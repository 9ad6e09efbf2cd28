// K11: WORLD synthesis's response finish and overlap-add, as a gather.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:210-215 and :233 (fftshift,
// the DC remover, the unvoiced mask), :239-245 ((per sqrt(ns) + aper) / N
// and the valid-pulse mask) and :247-277 (the overlap-add: on the TPU a
// one-hot chunk matmul in fast mode, a scatter-add dropping negative and
// invalid indices in the exact path; in the port's twin an index_add_),
// and the streaming synthesizer's host overlap-add (synthesis_rt.py:
// 139-144, 226-233).  On the card an index_add_ adds with atomics, in an
// order that changes from run to run.
//
// Two kernels in one launch.  The first sums, per pulse, the half of the
// shifted periodic response that the DC remover reads, by the twin's
// halving tree (x[:h] + x[h:]), so both get the same DC.  The second gives
// each thread one output sample: the block finds, by binary search over the
// ascending pulse indices, the pulses whose responses cover its samples,
// and each thread adds them in ascending pulse order: response k of pulse
// p lands at global sample pidx + 1 + k - N/2, so output sample j (global
// y0 + j) reads k = y0 + j + N/2 - 1 - pidx.  A sample's sum starts from 0
// (batch synthesis) or from the value already in y (`accumulate`, the
// streaming synthesizer's window of not yet emitted samples, which the
// previous chunks' pulses have added to).  Samples outside the window are
// dropped, as the reference skips them.  That is the order in which the
// twin's index_add_ adds on the CPU, so the waveform equals it bit for bit
// and is the same on every run.  Each response element is computed where
// it is read (the twin's operations, --fmad=false) and never stored.
//
// A template on the scalar type: float for the fast path, double for the
// parity path.
//
// Bound: bytes, the two response arrays read once (2 x N values a pulse).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dc_kernel(const T* __restrict__ per_raw, int N, int p2, T* __restrict__ dc) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const long long bp = blockIdx.x;
  const int half = N / 2;
  const T* row = per_raw + (size_t)bp * N;   // shifted[half + i] = row[i]
  for (int i = threadIdx.x; i < p2; i += THREADS)
    s[i] = i < half ? row[i] : (T)0;
  __syncthreads();
  for (int h = p2 / 2; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += THREADS) s[i] = s[i] + s[i + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dc[bp] = s[0];
}

__device__ __forceinline__ int lower_bound(const long long* a, int n,
                                           long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ per_raw, const T* __restrict__ aper_raw,
              const bool* __restrict__ unvoiced,
              const long long* __restrict__ pidx,
              const long long* __restrict__ nsize,
              const long long* __restrict__ n_pulses, int P, int N,
              const T* __restrict__ dc_rm, const T* __restrict__ dc,
              int y_length, long long y0, int accumulate,
              T* __restrict__ y) {
  const int b = blockIdx.y, half = N / 2;
  const int j0 = blockIdx.x * THREADS;
  const int j = j0 + threadIdx.x;
  const int j1 = min(j0 + THREADS, y_length) - 1;
  const long long* pi = pidx + (size_t)b * P;
  // pulses with pidx in [g0 + half - N, g1 + half - 1] cover the tile's
  // global samples [g0, g1]
  const long long g0 = y0 + j0, g1 = y0 + j1;
  const int p_lo = lower_bound(pi, P, g0 + half - N);
  const int p_hi = lower_bound(pi, P, g1 + half);
  const long long n = n_pulses[b];
  const T fN = (T)N;
  T* out = y + (size_t)b * y_length;
  T acc = (T)0;
  if (accumulate && j < y_length) acc = out[j];
  for (int p = p_lo; p < p_hi; ++p) {
    const size_t bp = (size_t)b * P + p;
    const long long ns = nsize[bp];
    if (p >= n || ns <= 0) continue;       // masked: the twin adds +0
    const long long k = y0 + j + half - 1 - pi[p];
    if (j >= y_length || k < 0 || k >= N) continue;
    const int kk = (int)k;
    const int src = kk < half ? kk + half : kk - half;   // fftshift
    const T d = dc[bp], rm = dc_rm[kk];
    T per = (T)0;
    if (!unvoiced[bp])
      per = kk < half ? (-d) * rm : per_raw[bp * N + src] - d * rm;
    const T r = (per * sqrt_((T)ns) + aper_raw[bp * N + src]) / fN;
    acc = acc + r;
  }
  if (j < y_length) out[j] = acc;
}

template <typename T>
int launch(const void* per_raw, const void* aper_raw, const bool* unvoiced,
           const long long* pidx, const long long* nsize,
           const long long* n_pulses, int B, int P, int N, const void* dc_rm,
           int y_length, long long y0, int accumulate, void* dc, void* y,
           cudaStream_t s) {
  if (P > 0) {
    int p2 = 1;
    while (p2 < N / 2) p2 <<= 1;
    const size_t smem = (size_t)p2 * sizeof(T);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          dc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dc_kernel<T><<<(unsigned)((long long)B * P), THREADS, smem, s>>>(
        static_cast<const T*>(per_raw), N, p2, static_cast<T*>(dc));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((y_length + THREADS - 1) / THREADS, B);
  gather_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(per_raw), static_cast<const T*>(aper_raw),
      unvoiced, pidx, nsize, n_pulses, P, N, static_cast<const T*>(dc_rm),
      static_cast<const T*>(dc), y_length, y0, accumulate,
      static_cast<T*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float arrays, 1 for double.  y0: the global sample index of
// y[.., 0]; accumulate: 1 adds to y's values, 0 overwrites them.
extern "C" int synth_ola_launch(const void* per_raw, const void* aper_raw,
                                const bool* unvoiced, const long long* pidx,
                                const long long* nsize,
                                const long long* n_pulses, int B, int P,
                                int N, const void* dc_rm, int y_length,
                                long long y0, int accumulate, int f64,
                                void* dc, void* y, cudaStream_t s) {
  if (B <= 0 || y_length <= 0) return (int)cudaGetLastError();
  if (N < 2 || N % 2 || P < 0) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(per_raw, aper_raw, unvoiced, pidx, nsize,
                              n_pulses, B, P, N, dc_rm, y_length, y0,
                              accumulate, dc, y, s)
             : launch<float>(per_raw, aper_raw, unvoiced, pidx, nsize,
                             n_pulses, B, P, N, dc_rm, y_length, y0,
                             accumulate, dc, y, s);
}
