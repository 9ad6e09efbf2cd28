// K26: D4C's body between its DFT matmuls and K2: LoveTrain's band sums,
// the centroid cross-product, the static group delay ratio and the
// Nuttall-windowed band segments.
//
// Replaces hts_train_world_tpu/ops/d4c.py:153-172 (LoveTrain's masked
// cumulative sums and ap0), 366-407 (the centroid products of both
// shifts, sgd = sc / sps with its non-finite guard, the smoothing
// difference) and 175-195 (each band's slice times the Nuttall window),
// which on the TPU ran as XLA passes over the (frames, fft_d/2+1) spectra.
// Four stages, one launcher each:
//   LoveTrain, one block a frame: s1 = sum of p over (b0, b1], s2 over
//           (b0, b2] (float64 block sums; the twin's float32 cumsum is
//           ~1e-6 from them), ap0 = s1 / max(s2, tiny), 0 where f0 = 0;
//           process = (f0 != 0) & (ap0 > threshold); cf0 = process ?
//           max(f0, 47) : 100;
//   centroid, one thread a bin: sc = (r2 r1 + i1 i2) at -0.25/f0 plus the
//           same at +0.25/f0 (the twin's order);
//   ratio, one thread a bin: sgd = sc / sps, non-finite -> 0 (division
//           by a zero or underflowed sps gives what torch.where(isfinite)
//           gives; denormals are kept: no -ftz);
//   segments, one thread an output: seg[r, i, j] = (a - b)[r, s_i + j] w[j],
//           the smoothed group delay minus its second smoothing, gathered
//           into each band's window.
//
// Bound: bytes.  LoveTrain reads its power rows once, the centroid eight
// spectra, the ratio two, the segments two rows' band spans; each writes
// once.
//
// Every stage is a template on the scalar type: float for the fast path,
// double for the parity analysis (the JAX package's f64 D4C, d4c.py:122-
// 150 and 323-360), where LoveTrain's sums stay in double and its ratio,
// threshold and f0 clamp are formed in double.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
love_train_kernel(const T* __restrict__ p, int H, int b0, int b1, int b2,
                  const T* __restrict__ f0, T threshold, T tiny,
                  T* __restrict__ ap0, unsigned char* __restrict__ process,
                  T* __restrict__ cf0) {
  __shared__ double red[32];
  const int r = blockIdx.x;
  const T* row = p + (size_t)r * H;
  double s1 = 0.0, s2 = 0.0;
  for (int k = b0 + 1 + threadIdx.x; k <= b2; k += THREADS) {
    const double v = row[k];
    s2 += v;
    if (k <= b1) s1 += v;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    const T f = f0[r];
    const T a = f == T(0) ? T(0) : (T)s1 / max_t((T)s2, tiny);
    const bool on = (f != T(0)) & (a > threshold);
    ap0[r] = a;
    process[r] = on;
    cf0[r] = on ? max_t(f, T(47)) : T(100);
  }
}

template <typename T>
struct Spectra {
  const T *r1a, *i1a, *r2a, *i2a, *r1b, *i1b, *r2b, *i2b;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
centroid_kernel(Spectra<T> s, long long n, T* __restrict__ sc) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T a = s.r2a[i] * s.r1a[i] + s.i1a[i] * s.i2a[i];
  const T b = s.r2b[i] * s.r1b[i] + s.i1b[i] * s.i2b[i];
  sc[i] = a + b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ratio_kernel(const T* __restrict__ sc, const T* __restrict__ sps,
             long long n, T* __restrict__ sgd) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T v = sc[i] / sps[i];
  sgd[i] = isfinite(v) ? v : T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segments_kernel(const T* __restrict__ a, const T* __restrict__ b, int H,
                const int* __restrict__ starts, int n_ap,
                const T* __restrict__ w, int wl, long long n,
                T* __restrict__ seg) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int j = (int)(i % wl);
  const long long rb = i / wl;
  const int band = (int)(rb % n_ap);
  const size_t at = (size_t)(rb / n_ap) * H + starts[band] + j;
  seg[i] = (a[at] - b[at]) * w[j];
}

inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// One launcher a stage; each returns cudaGetLastError() after its launch.
// f64: 0 for float tensors, 1 for double (every floating tensor alike).
// LoveTrain: p (R, H) power rows, bins (b0, b1] and (b0, b2], f0 (R,) ->
// ap0, process (uint8), cf0 (R,).
extern "C" int d4c_love_train_launch(const void* p, int R, int H, int b0,
                                     int b1, int b2, const void* f0,
                                     double threshold, double tiny, int f64,
                                     void* ap0, unsigned char* process,
                                     void* cf0, cudaStream_t s) {
  if (R > 0) {
    if (f64)
      love_train_kernel<double><<<R, THREADS, 0, s>>>(
          static_cast<const double*>(p), H, b0, b1, b2,
          static_cast<const double*>(f0), threshold, tiny,
          static_cast<double*>(ap0), process, static_cast<double*>(cf0));
    else
      love_train_kernel<float><<<R, THREADS, 0, s>>>(
          static_cast<const float*>(p), H, b0, b1, b2,
          static_cast<const float*>(f0), (float)threshold, (float)tiny,
          static_cast<float*>(ap0), process, static_cast<float*>(cf0));
  }
  return (int)cudaGetLastError();
}

// Centroid: r1, i1, r2, i2 at -0.25/f0 (a) and at +0.25/f0 (b), each
// (R, H) -> sc (R, H).
extern "C" int d4c_centroid_launch(const void* r1a, const void* i1a,
                                   const void* r2a, const void* i2a,
                                   const void* r1b, const void* i1b,
                                   const void* r2b, const void* i2b, int R,
                                   int H, int f64, void* sc, cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n > 0) {
    if (f64) {
      using T = double;
      centroid_kernel<T><<<blocks_for(n), THREADS, 0, s>>>(
          Spectra<T>{(const T*)r1a, (const T*)i1a, (const T*)r2a,
                     (const T*)i2a, (const T*)r1b, (const T*)i1b,
                     (const T*)r2b, (const T*)i2b}, n, (T*)sc);
    } else {
      using T = float;
      centroid_kernel<T><<<blocks_for(n), THREADS, 0, s>>>(
          Spectra<T>{(const T*)r1a, (const T*)i1a, (const T*)r2a,
                     (const T*)i2a, (const T*)r1b, (const T*)i1b,
                     (const T*)r2b, (const T*)i2b}, n, (T*)sc);
    }
  }
  return (int)cudaGetLastError();
}

// Ratio: sc, sps (R, H) -> sgd (R, H).
extern "C" int d4c_ratio_launch(const void* sc, const void* sps, int R,
                                int H, int f64, void* sgd, cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n > 0) {
    if (f64)
      ratio_kernel<double><<<blocks_for(n), THREADS, 0, s>>>(
          (const double*)sc, (const double*)sps, n, (double*)sgd);
    else
      ratio_kernel<float><<<blocks_for(n), THREADS, 0, s>>>(
          (const float*)sc, (const float*)sps, n, (float*)sgd);
  }
  return (int)cudaGetLastError();
}

// Segments: a, b (R, H), starts (n_ap,) on the device, window w (wl,) ->
// seg (R, n_ap, wl).
extern "C" int d4c_segments_launch(const void* a, const void* b, int R,
                                   int H, const int* starts, int n_ap,
                                   const void* w, int wl, int f64, void* seg,
                                   cudaStream_t s) {
  const long long m = (long long)R * n_ap * wl;
  if (m > 0) {
    if (f64)
      segments_kernel<double><<<blocks_for(m), THREADS, 0, s>>>(
          (const double*)a, (const double*)b, H, starts, n_ap,
          (const double*)w, wl, m, (double*)seg);
    else
      segments_kernel<float><<<blocks_for(m), THREADS, 0, s>>>(
          (const float*)a, (const float*)b, H, starts, n_ap, (const float*)w,
          wl, m, (float*)seg);
  }
  return (int)cudaGetLastError();
}
