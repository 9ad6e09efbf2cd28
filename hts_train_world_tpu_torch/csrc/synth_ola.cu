// K11: WORLD synthesis's response finish and overlap-add, as a gather.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:210-215 and :233 (fftshift,
// the DC remover, the unvoiced mask), :239-245 ((per sqrt(ns) + aper) / N
// and the valid-pulse mask) and :247-277 (the overlap-add: on the TPU a
// one-hot chunk matmul, in the port's twin an index_add_).  On the card an
// index_add_ adds with atomics, in an order that changes from run to run.
//
// Two kernels in one launch.  The first sums, per pulse, the half of the
// shifted periodic response that the DC remover reads, by the twin's
// halving tree (x[:h] + x[h:]), so both get the same DC.  The second gives
// each thread one output sample: the block finds, by binary search over the
// ascending pulse indices, the pulses whose responses cover its samples,
// and each thread adds them in ascending pulse order, starting from 0:
// response k of pulse p lands at sample pidx + 1 + k - N/2, so sample j
// reads k = j + N/2 - 1 - pidx.  That is the order in which the twin's
// index_add_ adds on the CPU, so the waveform equals it bit for bit and is
// the same on every run.  Each response element is computed where it is
// read (the twin's f32 operations, --fmad=false) and never stored.
//
// Bound: bytes, the two response arrays read once (2 x 4 N bytes a pulse).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dc_kernel(const float* __restrict__ per_raw, int N, int p2,
          float* __restrict__ dc) {
  extern __shared__ float s[];
  const long long bp = blockIdx.x;
  const int half = N / 2;
  const float* row = per_raw + (size_t)bp * N;   // shifted[half + i] = row[i]
  for (int i = threadIdx.x; i < p2; i += THREADS)
    s[i] = i < half ? row[i] : 0.0f;
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

__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ per_raw,
              const float* __restrict__ aper_raw,
              const bool* __restrict__ unvoiced,
              const long long* __restrict__ pidx,
              const long long* __restrict__ nsize,
              const long long* __restrict__ n_pulses, int P, int N,
              const float* __restrict__ dc_rm, const float* __restrict__ dc,
              int y_length, float* __restrict__ y) {
  const int b = blockIdx.y, half = N / 2;
  const int j0 = blockIdx.x * THREADS;
  const int j = j0 + threadIdx.x;
  const int j1 = min(j0 + THREADS, y_length) - 1;
  const long long* pi = pidx + (size_t)b * P;
  // pulses with pidx in [j0 + half - N, j1 + half - 1] cover the tile
  const int p_lo = lower_bound(pi, P, (long long)j0 + half - N);
  const int p_hi = lower_bound(pi, P, (long long)j1 + half);
  const long long n = n_pulses[b];
  const float fN = (float)N;
  float acc = 0.0f;
  for (int p = p_lo; p < p_hi; ++p) {
    const size_t bp = (size_t)b * P + p;
    const long long ns = nsize[bp];
    if (p >= n || ns <= 0) continue;       // masked: the twin adds +0
    const long long k = (long long)j + half - 1 - pi[p];
    if (j >= y_length || k < 0 || k >= N) continue;
    const int kk = (int)k;
    const int src = kk < half ? kk + half : kk - half;   // fftshift
    const float d = dc[bp], rm = dc_rm[kk];
    float per = 0.0f;
    if (!unvoiced[bp])
      per = kk < half ? (-d) * rm : per_raw[bp * N + src] - d * rm;
    const float r = (per * sqrtf((float)ns) + aper_raw[bp * N + src]) / fN;
    acc = acc + r;
  }
  if (j < y_length) y[(size_t)b * y_length + j] = acc;
}

}  // namespace

extern "C" int synth_ola_launch(const float* per_raw, const float* aper_raw,
                                const bool* unvoiced, const long long* pidx,
                                const long long* nsize,
                                const long long* n_pulses, int B, int P,
                                int N, const float* dc_rm, int y_length,
                                float* dc, float* y, cudaStream_t s) {
  if (B <= 0 || y_length <= 0) return (int)cudaGetLastError();
  if (N < 2 || N % 2 || P < 0) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    int p2 = 1;
    while (p2 < N / 2) p2 <<= 1;
    const size_t smem = (size_t)p2 * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          dc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dc_kernel<<<(unsigned)((long long)B * P), THREADS, smem, s>>>(per_raw, N,
                                                                  p2, dc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((y_length + THREADS - 1) / THREADS, B);
  gather_kernel<<<grid, THREADS, 0, s>>>(per_raw, aper_raw, unvoiced, pidx,
                                         nsize, n_pulses, P, N, dc_rm, dc,
                                         y_length, y);
  return (int)cudaGetLastError();
}
