// K14: Harvest's raw band candidates, one block per (utterance, channel).
//
// Replaces hts_train_world_tpu/ops/harvest.py:129-159 and :207-224
// (_zc_candidates and the per-octave groups of _raw_candidates) with
// ops/dio.py:37-70 (zero_crossings), prims.py:57-76 (compact_indices) and
// prims.py:137-181 (interp1_regular_grid); GetRawF0Candidates,
// harvest.cpp:211-254 and :334-343 in WORLD.  On the TPU every channel's
// four crossing streams were compacted with lax.top_k under a per-octave
// cap and interpolated with a scatter-add + cumsum.  Here one block walks
// its channel's band-passed row (read from h+1 of the circular
// convolution) once, in tiles of THREADS samples: each thread tests its
// sample for a negative-going crossing of the four streams (filtered,
// -filtered, diff, -diff), a warp ballot plus a scan over the warps ranks
// the crossings in time order, and the fine crossing positions of the
// first `cap` of each stream go to shared memory (device memory for very
// long inputs).  Each 1 ms frame then finds its segment by binary search
// over the stream's locations, evaluates y0 + s*(y1 - y0), and the
// 4-stream mean is gated to +-10 % of the boundary, the F0 range and the
// saturation limit; all four streams need > 2 intervals.  No score.
//
// Bound: bytes (the channel rows are read once; candidates written once);
// the per-tile block scans add a few barriers per 1024 samples.  Built
// with --fmad=false so the crossing positions round like the twin's.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

struct Stream {
  const float* fine;
  int n;  // intervals kept (the valid prefix of locations / intervals)
};

__device__ __forceinline__ float location(const float* fine, int k,
                                          float fs) {
  return __fdiv_rn(__fdiv_rn(fine[k] + fine[k + 1], 2.0f), fs);
}

__device__ __forceinline__ float interval(const float* fine, int k,
                                          float fs) {
  return __fdiv_rn(fs, fine[k + 1] - fine[k]);
}

// interp1 of the stream's (locations, intervals) at t: segment k =
// clip(#(location <= t), 1, n-1), y0 + s * (y1 - y0)
__device__ float interp_stream(const Stream& st, float t, float fs) {
  int lo = 0, hi = st.n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (location(st.fine, mid, fs) <= t) lo = mid + 1; else hi = mid;
  }
  const int k = min(max(lo, 1), st.n - 1);
  const float x0 = location(st.fine, k - 1, fs);
  const float x1 = location(st.fine, k, fs);
  const float y0 = interval(st.fine, k - 1, fs);
  const float y1 = interval(st.fine, k, fs);
  const float s = __fdiv_rn(t - x0, x1 - x0);
  return y0 + s * (y1 - y0);
}

__device__ __forceinline__ float fine_of(int i, float a, float b) {
  // e - s[e-1] / (s[e] - s[e-1]) with e = i + 1
  return (float)(i + 1) - __fdiv_rn(a, b - a);
}

__global__ void __launch_bounds__(THREADS)
harvest_candidates_kernel(const float* __restrict__ filt, int n_ch,
                          int fft_size, int L, const int* __restrict__ cint,
                          const float* __restrict__ cflt, float fs,
                          float f0_floor, float f0_ceil, int T, float fp,
                          int cap_max, float* __restrict__ gfine,
                          float* __restrict__ raw, int* __restrict__ n_out,
                          int* __restrict__ pos_out) {
  extern __shared__ float sfine[];
  __shared__ int cnt[4][WARPS];
  __shared__ int excl[4][WARPS];
  __shared__ int total[4];
  __shared__ int base[4];
  const int uc = blockIdx.x, c = uc % n_ch, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* x = filt + (size_t)uc * fft_size + cint[2 * c];
  const int cap = cint[2 * c + 1];
  float* fine = gfine ? gfine + (size_t)uc * 4 * cap_max : sfine;
  int* pos = pos_out ? pos_out + (size_t)uc * 4 * cap_max : nullptr;
  if (tid < 4) base[tid] = 0;
  __syncthreads();

  // ---- crossings of the four streams, ranked in time order ----
  for (int t0 = 0; t0 < L - 1; t0 += THREADS) {
    const int i = t0 + tid;
    bool m[4] = {false, false, false, false};
    float fv[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < L - 1) {
      const float a = x[i], b = x[i + 1];
      const float da = b - a;
      // the diff has L-1 samples: its last pair is (L-3, L-2)
      const float db = i + 1 < L - 1 ? x[i + 2] - b : da;
      m[0] = a > 0.f && b <= 0.f;
      m[1] = -a > 0.f && -b <= 0.f;
      m[2] = da > 0.f && db <= 0.f;
      m[3] = -da > 0.f && -db <= 0.f;
      if (m[0]) fv[0] = fine_of(i, a, b);
      if (m[1]) fv[1] = fine_of(i, -a, -b);
      if (m[2]) fv[2] = fine_of(i, da, db);
      if (m[3]) fv[3] = fine_of(i, -da, -db);
    }
    unsigned ball[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ball[s] = __ballot_sync(0xffffffffu, m[s]);
      if (lane == 0) cnt[s][warp] = __popc(ball[s]);
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int cc = cnt[s][lane];
        int v = cc;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        excl[s][lane] = v - cc;
        if (lane == 31) total[s] = v;
      }
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!m[s]) continue;
      const int rank = base[s] + excl[s][warp] + __popc(ball[s] & below);
      if (rank < cap) {
        fine[s * cap_max + rank] = fv[s];
        if (pos) pos[s * cap_max + rank] = i;
      }
    }
    __syncthreads();
    if (tid < 4) base[tid] += total[tid];
  }
  __syncthreads();

  // ---- per stream: interval count, saturation limit ----
  Stream st[4];
  bool enough = true;
  float t_limit = FLT_MAX;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int n_edges = base[s];
    int n = n_edges < 2 ? 0 : n_edges - 1;
    n = min(n, cap - 1);
    st[s].fine = fine + s * cap_max;
    st[s].n = n;
    enough = enough && n > 2;
    if (n_edges > cap)  // saturated: frames past the last kept location
      t_limit = fminf(t_limit, location(st[s].fine, max(n - 1, 0), fs));
    if (n_out && tid == 0) n_out[uc * 4 + s] = n;
    if (pos)
      for (int k = min(n_edges, cap) + tid; k < cap_max; k += THREADS)
        pos[s * cap_max + k] = L - 1;
  }

  // ---- candidates on the 1 ms grid ----
  const float hi = cflt[2 * c], lo = cflt[2 * c + 1];
  for (int q = tid; q < T; q += THREADS) {
    float cand = 0.f;
    if (enough) {
      const float t = (float)q * fp;
      float f[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) f[s] = interp_stream(st[s], t, fs);
      const float cm = (((f[0] + f[1]) + f[2]) + f[3]) / 4.0f;
      const bool bad = cm > hi || cm < lo || cm > f0_ceil || cm < f0_floor ||
                       t > t_limit;
      if (!bad) cand = cm;
    }
    raw[(size_t)uc * T + q] = cand;
  }
}

}  // namespace

extern "C" int harvest_candidates_launch(const float* filt, int blocks,
                                         int n_ch, int fft_size, int L,
                                         const int* cint, const float* cflt,
                                         float fs, float f0_floor,
                                         float f0_ceil, int T, float fp,
                                         int cap_max, float* gfine,
                                         float* raw, int* n_out,
                                         int* pos_out, cudaStream_t s) {
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem = gfine ? 0 : (size_t)4 * cap_max * sizeof(float);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_candidates_kernel<<<blocks, THREADS, smem, s>>>(
      filt, n_ch, fft_size, L, cint, cflt, fs, f0_floor, f0_ceil, T, fp,
      cap_max, gfine, raw, n_out, pos_out);
  return (int)cudaGetLastError();
}
