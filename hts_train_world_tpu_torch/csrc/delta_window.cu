// K7: delta-window expansion (window.pl), one thread per output element.
//
// Replaces hts_train_world_tpu/features/windows.py:44-67 (apply_window /
// expand), which on the TPU ran every window as shifted copies of the whole
// (T, D) array plus an OR-reduce for the -1e10 boundary propagation, and a
// concatenate.  Here each thread computes one element of the
// [static | delta | delta-delta] layout: it reads its column's taps with the
// edge clamp, sums w[k] * x in tap order starting from 0 (the plain twin's
// order, built with --fmad=false, so the two agree bit for bit), and writes
// -1e10 when a tap inside the window's support reads -1e10.
//
// The kernel is a template on the scalar type: float for the feature lane,
// double for composition (compose_cmp) and for generation's windowed
// observations (pgtype 1/2), which run in float64 as the JAX package's do.
// -1e10 is exact in both types.
//
// Bound: bytes (x read, n_win x D per frame written); the taps re-read x
// from L1/L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_window_kernel(const T* __restrict__ x, int nT, int D,
                    const T* __restrict__ coef,
                    const T* __restrict__ sup, int n_win, int width,
                    long long total, T* __restrict__ out) {
  const T MAGIC = T(-1.0e10);
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= total) return;
  const int od = n_win * D;
  const int c = (int)(i % od);
  const long long bt = i / od;
  const int t = (int)(bt % nT);
  const long long b = bt / nT;
  const int w = c / D, d = c % D;
  const int nlr = (width - 1) / 2;
  const T* xb = x + (size_t)b * nT * D + d;
  T acc = T(0);
  bool boundary = false;
  for (int j = 0; j < width; ++j) {
    const T wk = coef[w * width + j];
    const bool s = sup[w * width + j] != T(0);
    if (wk == T(0) && !s) continue;
    const int tt = min(max(t + j - nlr, 0), nT - 1);
    const T xi = xb[(size_t)tt * D];
    if (wk != T(0)) acc = acc + wk * xi;
    if (s) boundary = boundary || xi == MAGIC;
  }
  out[i] = boundary ? MAGIC : acc;
}

template <typename T>
int launch(const void* x, int B, int nT, int D, const void* coef,
           const void* sup, int n_win, int width, void* out, cudaStream_t s) {
  const long long total = (long long)B * nT * n_win * D;
  if (total > 0) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    delta_window_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const T*>(x), nT, D, static_cast<const T*>(coef),
        static_cast<const T*>(sup), n_win, width, total,
        static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors, 1 for double (x, coef, sup and out alike).
extern "C" int delta_window_launch(const void* x, int B, int T, int D,
                                   const void* coef, const void* sup,
                                   int n_win, int width, int f64, void* out,
                                   cudaStream_t s) {
  return f64 ? launch<double>(x, B, T, D, coef, sup, n_win, width, out, s)
             : launch<float>(x, B, T, D, coef, sup, n_win, width, out, s);
}
