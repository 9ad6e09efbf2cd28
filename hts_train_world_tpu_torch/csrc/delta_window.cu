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
// Bound: bytes (x read, n_win x D per frame written); the taps re-read x
// from L1/L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float MAGIC = -1.0e10f;

__global__ void __launch_bounds__(THREADS)
delta_window_kernel(const float* __restrict__ x, int T, int D,
                    const float* __restrict__ coef,
                    const float* __restrict__ sup, int n_win, int width,
                    long long total, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= total) return;
  const int od = n_win * D;
  const int c = (int)(i % od);
  const long long bt = i / od;
  const int t = (int)(bt % T);
  const long long b = bt / T;
  const int w = c / D, d = c % D;
  const int nlr = (width - 1) / 2;
  const float* xb = x + (size_t)b * T * D + d;
  float acc = 0.f;
  bool boundary = false;
  for (int j = 0; j < width; ++j) {
    const float wk = coef[w * width + j];
    const bool s = sup[w * width + j] != 0.f;
    if (wk == 0.f && !s) continue;
    const int tt = min(max(t + j - nlr, 0), T - 1);
    const float xi = xb[(size_t)tt * D];
    if (wk != 0.f) acc = acc + wk * xi;
    if (s) boundary = boundary || xi == MAGIC;
  }
  out[i] = boundary ? MAGIC : acc;
}

}  // namespace

extern "C" int delta_window_launch(const float* x, int B, int T, int D,
                                   const float* coef, const float* sup,
                                   int n_win, int width, float* out,
                                   cudaStream_t s) {
  const long long total = (long long)B * T * n_win * D;
  if (total > 0) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    delta_window_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        x, T, D, coef, sup, n_win, width, total, out);
  }
  return (int)cudaGetLastError();
}
