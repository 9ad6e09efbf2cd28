// K31: D4C's sorted band power sums, one block per (frame, band) row.
//
// Replaces hts_train_world_tpu/ops/d4c.py:190-194, the parity branch of
// _coarse_aperiodicity (d4c.cpp:215-220 in WORLD): the C sorts each band's
// power spectrum (fft_d/2 + 1 doubles) in ascending order and sums it from
// the smallest, and the band's aperiodicity is c[half - boundary - 1] /
// c[half] of that cumulative sum.  On the TPU this was jnp.sort and
// jnp.cumsum over (frames, bands, fft_d/2 + 1).  Here a block stages its
// row in shared memory (padded to a power of two, 2049 -> 4096 doubles =
// 32 KB at 48 kHz), sorts it with a bitonic network, and thread 0 adds the
// sorted values in sequence (the reference's order; a parallel scan would
// reassociate the sum) and keeps the two entries the ratio needs.
//
// The sort runs on 64-bit keys (the bits, with the sign bit set for
// positives and every bit flipped for negatives) in the order the JAX
// package's jnp.sort gives: -inf ... -0, +0 ... +inf, then every NaN
// whatever its sign; the padding is the largest key and sorts after all.
// So a row with a NaN gives den = NaN, and num = NaN only if the row has
// more than boundary + 1 NaNs, as in JAX; ties and signed zeros do not
// change a sum.
//
// Bound: bytes (each row read once, two doubles written).  The sort costs
// log2(P)(log2(P)+1)/2 compare-exchange passes over P keys in shared
// memory, and the sequential sum H dependent adds in one thread: it is
// latency-bound, with up to 4 blocks of 512 threads resident on an SM.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ unsigned long long key_of(double v) {
  if (isnan(v)) return 0xfffffffffffffffeull;  // decodes to a NaN
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double value_of(unsigned long long k) {
  const unsigned long long b = (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k;
  return __longlong_as_double((long long)b);
}

__global__ void __launch_bounds__(THREADS)
band_sort_kernel(const double* __restrict__ p, int H, int P, int i_num,
                 double* __restrict__ num, double* __restrict__ den) {
  extern __shared__ __align__(16) unsigned long long key[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const double* row = p + (size_t)r * H;
  for (int i = tid; i < P; i += THREADS)
    key[i] = i < H ? key_of(row[i]) : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = key[i], b = key[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < H; ++i) {
      s += value_of(key[i]);
      if (i == i_num) num[r] = s;
    }
    den[r] = s;
  }
}

}  // namespace

// p (R, H) float64 rows -> num (R,) = c[i_num], den (R,) = c[H - 1] of the
// cumulative sum of each row sorted ascending.
extern "C" int d4c_band_sort_launch(const double* p, int R, int H, int i_num,
                                    double* num, double* den,
                                    cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  if (H < 1 || i_num < 0 || i_num >= H) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < H) P <<= 1;
  const size_t smem = (size_t)P * sizeof(unsigned long long);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      band_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  band_sort_kernel<<<R, THREADS, smem, s>>>(p, H, P, i_num, num, den);
  return (int)cudaGetLastError();
}
