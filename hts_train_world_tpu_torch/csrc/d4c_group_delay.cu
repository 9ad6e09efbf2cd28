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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
love_train_kernel(const float* __restrict__ p, int H, int b0, int b1, int b2,
                  const float* __restrict__ f0, float threshold, float tiny,
                  float* __restrict__ ap0, unsigned char* __restrict__ process,
                  float* __restrict__ cf0) {
  __shared__ double red[32];
  const int r = blockIdx.x;
  const float* row = p + (size_t)r * H;
  double s1 = 0.0, s2 = 0.0;
  for (int k = b0 + 1 + threadIdx.x; k <= b2; k += THREADS) {
    const double v = row[k];
    s2 += v;
    if (k <= b1) s1 += v;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    const float f = f0[r];
    const float a = f == 0.f ? 0.f : (float)s1 / fmaxf((float)s2, tiny);
    const bool on = (f != 0.f) & (a > threshold);
    ap0[r] = a;
    process[r] = on;
    cf0[r] = on ? fmaxf(f, 47.0f) : 100.0f;
  }
}

struct Spectra {
  const float *r1a, *i1a, *r2a, *i2a, *r1b, *i1b, *r2b, *i2b;
};

__global__ void __launch_bounds__(THREADS)
centroid_kernel(Spectra s, long long n, float* __restrict__ sc) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float a = s.r2a[i] * s.r1a[i] + s.i1a[i] * s.i2a[i];
  const float b = s.r2b[i] * s.r1b[i] + s.i1b[i] * s.i2b[i];
  sc[i] = a + b;
}

__global__ void __launch_bounds__(THREADS)
ratio_kernel(const float* __restrict__ sc, const float* __restrict__ sps,
             long long n, float* __restrict__ sgd) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float v = sc[i] / sps[i];
  sgd[i] = isfinite(v) ? v : 0.f;
}

__global__ void __launch_bounds__(THREADS)
segments_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int H, const int* __restrict__ starts, int n_ap,
                const float* __restrict__ w, int wl, long long n,
                float* __restrict__ seg) {
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
// LoveTrain: p (R, H) power rows, bins (b0, b1] and (b0, b2], f0 (R,) ->
// ap0, process (uint8), cf0 (R,).
extern "C" int d4c_love_train_launch(const float* p, int R, int H, int b0,
                                     int b1, int b2, const float* f0,
                                     float threshold, float tiny, float* ap0,
                                     unsigned char* process, float* cf0,
                                     cudaStream_t s) {
  if (R > 0)
    love_train_kernel<<<R, THREADS, 0, s>>>(p, H, b0, b1, b2, f0, threshold,
                                            tiny, ap0, process, cf0);
  return (int)cudaGetLastError();
}

// Centroid: r1, i1, r2, i2 at -0.25/f0 (a) and at +0.25/f0 (b), each
// (R, H) -> sc (R, H).
extern "C" int d4c_centroid_launch(const float* r1a, const float* i1a,
                                   const float* r2a, const float* i2a,
                                   const float* r1b, const float* i1b,
                                   const float* r2b, const float* i2b, int R,
                                   int H, float* sc, cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n > 0)
    centroid_kernel<<<blocks_for(n), THREADS, 0, s>>>(
        Spectra{r1a, i1a, r2a, i2a, r1b, i1b, r2b, i2b}, n, sc);
  return (int)cudaGetLastError();
}

// Ratio: sc, sps (R, H) -> sgd (R, H).
extern "C" int d4c_ratio_launch(const float* sc, const float* sps, int R,
                                int H, float* sgd, cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n > 0) ratio_kernel<<<blocks_for(n), THREADS, 0, s>>>(sc, sps, n, sgd);
  return (int)cudaGetLastError();
}

// Segments: a, b (R, H), starts (n_ap,) on the device, window w (wl,) ->
// seg (R, n_ap, wl).
extern "C" int d4c_segments_launch(const float* a, const float* b, int R,
                                   int H, const int* starts, int n_ap,
                                   const float* w, int wl, float* seg,
                                   cudaStream_t s) {
  const long long m = (long long)R * n_ap * wl;
  if (m > 0)
    segments_kernel<<<blocks_for(m), THREADS, 0, s>>>(a, b, H, starts, n_ap,
                                                      w, wl, m, seg);
  return (int)cudaGetLastError();
}
