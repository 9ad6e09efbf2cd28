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
//
// The kernel is a template on the scalar type.  float64 is the parity
// analysis' Harvest (the JAX package's f64 branch of _raw_candidates):
// the same per-octave caps as the f32 form (no input found reaches one,
// see the twin), the crossings in shared memory or, past its size, in
// device scratch, and the 1 ms grid as arange(T) * 0.001 in float64, the
// grid JAX's f64 interp1 reads.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float min_t(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_t(double a, double b) {
  return fmin(a, b);
}
template <typename T> __device__ __forceinline__ T max_value();
template <> __device__ __forceinline__ float max_value<float>() {
  return FLT_MAX;
}
template <> __device__ __forceinline__ double max_value<double>() {
  return DBL_MAX;
}

template <typename T>
struct Stream {
  const T* fine;
  int n;  // intervals kept (the valid prefix of locations / intervals)
};

template <typename T>
__device__ __forceinline__ T location(const T* fine, int k, T fs) {
  return div_rn(div_rn(fine[k] + fine[k + 1], T(2)), fs);
}

template <typename T>
__device__ __forceinline__ T interval(const T* fine, int k, T fs) {
  return div_rn(fs, fine[k + 1] - fine[k]);
}

// interp1 of the stream's (locations, intervals) at t: segment k =
// clip(#(location <= t), 1, n-1), y0 + s * (y1 - y0)
template <typename T>
__device__ T interp_stream(const Stream<T>& st, T t, T fs) {
  int lo = 0, hi = st.n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (location(st.fine, mid, fs) <= t) lo = mid + 1; else hi = mid;
  }
  const int k = min(max(lo, 1), st.n - 1);
  const T x0 = location(st.fine, k - 1, fs);
  const T x1 = location(st.fine, k, fs);
  const T y0 = interval(st.fine, k - 1, fs);
  const T y1 = interval(st.fine, k, fs);
  const T s = div_rn(t - x0, x1 - x0);
  return y0 + s * (y1 - y0);
}

template <typename T>
__device__ __forceinline__ T fine_of(int i, T a, T b) {
  // e - s[e-1] / (s[e] - s[e-1]) with e = i + 1
  return (T)(i + 1) - div_rn(a, b - a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_candidates_kernel(const T* __restrict__ filt, int n_ch,
                          int fft_size, int L, const int* __restrict__ cint,
                          const T* __restrict__ cflt, T fs, T f0_floor,
                          T f0_ceil, int nT, T fp, int cap_max,
                          T* __restrict__ gfine, T* __restrict__ raw,
                          int* __restrict__ n_out,
                          int* __restrict__ pos_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sfine = reinterpret_cast<T*>(smem_raw);
  __shared__ int cnt[4][WARPS];
  __shared__ int excl[4][WARPS];
  __shared__ int total[4];
  __shared__ int base[4];
  const int uc = blockIdx.x, c = uc % n_ch, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* x = filt + (size_t)uc * fft_size + cint[2 * c];
  const int cap = cint[2 * c + 1];
  T* fine = gfine ? gfine + (size_t)uc * 4 * cap_max : sfine;
  int* pos = pos_out ? pos_out + (size_t)uc * 4 * cap_max : nullptr;
  if (tid < 4) base[tid] = 0;
  __syncthreads();

  // ---- crossings of the four streams, ranked in time order ----
  for (int t0 = 0; t0 < L - 1; t0 += THREADS) {
    const int i = t0 + tid;
    bool m[4] = {false, false, false, false};
    T fv[4] = {T(0), T(0), T(0), T(0)};
    if (i < L - 1) {
      const T a = x[i], b = x[i + 1];
      const T da = b - a;
      // the diff has L-1 samples: its last pair is (L-3, L-2)
      const T db = i + 1 < L - 1 ? x[i + 2] - b : da;
      m[0] = a > T(0) && b <= T(0);
      m[1] = -a > T(0) && -b <= T(0);
      m[2] = da > T(0) && db <= T(0);
      m[3] = -da > T(0) && -db <= T(0);
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
  Stream<T> st[4];
  bool enough = true;
  T t_limit = max_value<T>();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int n_edges = base[s];
    int n = n_edges < 2 ? 0 : n_edges - 1;
    n = min(n, cap - 1);
    st[s].fine = fine + s * cap_max;
    st[s].n = n;
    enough = enough && n > 2;
    if (n_edges > cap)  // saturated: frames past the last kept location
      t_limit = min_t(t_limit, location(st[s].fine, max(n - 1, 0), fs));
    if (n_out && tid == 0) n_out[uc * 4 + s] = n;
    if (pos)
      for (int k = min(n_edges, cap) + tid; k < cap_max; k += THREADS)
        pos[s * cap_max + k] = L - 1;
  }

  // ---- candidates on the 1 ms grid ----
  const T hi = cflt[2 * c], lo = cflt[2 * c + 1];
  for (int q = tid; q < nT; q += THREADS) {
    T cand = T(0);
    if (enough) {
      const T t = (T)q * fp;
      T f[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) f[s] = interp_stream(st[s], t, fs);
      const T cm = (((f[0] + f[1]) + f[2]) + f[3]) / T(4);
      const bool bad = cm > hi || cm < lo || cm > f0_ceil || cm < f0_floor ||
                       t > t_limit;
      if (!bad) cand = cm;
    }
    raw[(size_t)uc * nT + q] = cand;
  }
}

template <typename T>
int launch(const void* filt, int blocks, int n_ch, int fft_size, int L,
           const int* cint, const void* cflt, double fs, double f0_floor,
           double f0_ceil, int nT, double fp, int cap_max, void* gfine,
           void* raw, int* n_out, int* pos_out, cudaStream_t s) {
  const size_t smem = gfine ? 0 : (size_t)4 * cap_max * sizeof(T);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_candidates_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_candidates_kernel<T><<<blocks, THREADS, smem, s>>>(
      static_cast<const T*>(filt), n_ch, fft_size, L, cint,
      static_cast<const T*>(cflt), (T)fs, (T)f0_floor, (T)f0_ceil, nT,
      (T)fp, cap_max, static_cast<T*>(gfine), static_cast<T*>(raw), n_out,
      pos_out);
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors (filt, cflt, gfine, raw), 1 for double.
extern "C" int harvest_candidates_launch(const void* filt, int blocks,
                                         int n_ch, int fft_size, int L,
                                         const int* cint, const void* cflt,
                                         double fs, double f0_floor,
                                         double f0_ceil, int T, double fp,
                                         int cap_max, int f64, void* gfine,
                                         void* raw, int* n_out, int* pos_out,
                                         cudaStream_t s) {
  if (blocks <= 0) return (int)cudaGetLastError();
  return f64 ? launch<double>(filt, blocks, n_ch, fft_size, L, cint, cflt,
                              fs, f0_floor, f0_ceil, T, fp, cap_max, gfine,
                              raw, n_out, pos_out, s)
             : launch<float>(filt, blocks, n_ch, fft_size, L, cint, cflt, fs,
                             f0_floor, f0_ceil, T, fp, cap_max, gfine, raw,
                             n_out, pos_out, s);
}
