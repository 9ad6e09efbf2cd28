// K32: Harvest's candidate detection and overlap spreading, in two stages.
//
// Replaces hts_train_world_tpu/ops/harvest_fix.py:71-118
// (detect_candidates, overlap_candidates); DetectOfficialF0Candidates and
// OverlapF0Candidates, harvest.cpp:388-429 in WORLD.  On the TPU the runs
// were found with masks, compactions and a cumulative sum over the channel
// axis, and the spreading was a gather; in the port's plain twin that is a
// dozen launches over (B, T, n_ch) tensors.
//
// Stage 1 (detect): one thread per (utterance, 1 ms frame) walks the
// frame's n_ch channels in order (adjacent threads read adjacent frames,
// so each channel's read is coalesced).  Channels 0 and n_ch-1 are forced
// unvoiced; every run of voiced (> 0) channels that spans >= 10 channels
// is a candidate, its mean taken as the difference of the float64 prefix
// sums of all channels at the run's ends over its length, summed in
// sequence as the twin's cumsum sums, and rounded once to the field's
// type.  The first nc_cap means go to the frame's row; the frame's count
// (capped) is kept, and each utterance's largest count (uncapped) is an
// atomic max.
//
// Stage 2 (overlap): one thread per output (utterance, frame, column j +
// nc*i): block i = 0 is the frame's own candidates, i = 1..3 frame t-i's,
// i = 4..6 frame t+i-3's, with nc the utterance's largest count; columns
// past 7*nc, frames off the ends and columns past a frame's count are 0.
//
// Bound: bytes (the raw field read once, the spread field written once);
// the walk is n_ch dependent float64 adds a thread.  Built with
// --fmad=false.  The kernels are templates on the field's type: float for
// the fast path, double for the parity analysis' Harvest.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_RUN = 10;  // channels a detected run spans at least

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_detect_kernel(const T* __restrict__ raw, int B, int n_ch, int nT,
                      int nc_cap, T* __restrict__ dets, int* __restrict__ kc,
                      int* __restrict__ nc) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= (long long)B * nT) return;
  const int u = (int)(g / nT), t = (int)(g % nT);
  const T* col = raw + (size_t)u * n_ch * nT + t;
  T* row = dets + (size_t)g * nc_cap;
  double csum = 0.0, at_start = 0.0;  // csum: sum of channels [0, c)
  int start = -1, k = 0;
  for (int c = 0; c < n_ch; ++c) {
    const T v = col[(size_t)c * nT];
    const bool voiced = v > T(0) && c != 0 && c != n_ch - 1;
    if (voiced && start < 0) {
      start = c;
      at_start = csum;
    } else if (!voiced && start >= 0) {  // the run [start, c) ends
      if (c - start >= MIN_RUN) {
        if (k < nc_cap)
          row[k] = (T)__ddiv_rn(csum - at_start, (double)(c - start));
        ++k;
      }
      start = -1;
    }
    csum += (double)v;
  }
  kc[g] = min(k, nc_cap);
  atomicMax(nc + u, k);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_overlap_kernel(const T* __restrict__ dets, const int* __restrict__ kc,
                       const int* __restrict__ nc, int B, int nT, int NC,
                       T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= (long long)B * nT * NC) return;
  const int col = (int)(g % NC);
  const long long ut = g / NC;
  const int u = (int)(ut / nT), t = (int)(ut % nT);
  const int ncb = max(nc[u], 1);
  const int blk = col / ncb, j = col - blk * ncb;
  const int shift = blk == 0 ? 0 : blk <= 3 ? blk : -(blk - 3);
  const int src = t - shift;
  T v = T(0);
  if (blk < 7 && src >= 0 && src < nT) {
    const size_t s = (size_t)u * nT + src;
    if (j < kc[s]) v = dets[s * NC + j];
  }
  out[g] = v;
}

template <typename T>
int detect(const void* raw, int B, int n_ch, int nT, int nc_cap, void* dets,
           int* kc, int* nc, cudaStream_t s) {
  const long long n = (long long)B * nT;
  harvest_detect_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS),
                             THREADS, 0, s>>>(
      static_cast<const T*>(raw), B, n_ch, nT, nc_cap, static_cast<T*>(dets),
      kc, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int overlap(const void* dets, const int* kc, const int* nc, int B, int nT,
            int NC, void* out, cudaStream_t s) {
  const long long n = (long long)B * nT * NC;
  harvest_overlap_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS),
                              THREADS, 0, s>>>(
      static_cast<const T*>(dets), kc, nc, B, nT, NC, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1.  raw (B, n_ch, T) -> dets (B, T, nc_cap) (the first kc[u, t]
// columns of each frame written), kc (B, T) int32, nc (B,) int32, which the
// caller zeroes.  f64: 0 for float raw and dets, 1 for double.
extern "C" int harvest_detect_launch(const void* raw, int B, int n_ch, int T,
                                     int nc_cap, int f64, void* dets, int* kc,
                                     int* nc, cudaStream_t s) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  if (n_ch < 2 || nc_cap < 1) return (int)cudaErrorInvalidValue;
  return f64 ? detect<double>(raw, B, n_ch, T, nc_cap, dets, kc, nc, s)
             : detect<float>(raw, B, n_ch, T, nc_cap, dets, kc, nc, s);
}

// Stage 2.  dets, kc, nc of stage 1 -> out (B, T, NC), NC = nc_cap.
extern "C" int harvest_overlap_launch(const void* dets, const int* kc,
                                      const int* nc, int B, int T, int NC,
                                      int f64, void* out, cudaStream_t s) {
  if (B <= 0 || T <= 0 || NC <= 0) return (int)cudaGetLastError();
  return f64 ? overlap<double>(dets, kc, nc, B, T, NC, out, s)
             : overlap<float>(dets, kc, nc, B, T, NC, out, s);
}
