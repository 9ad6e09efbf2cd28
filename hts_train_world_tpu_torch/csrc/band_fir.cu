// K36: the SPTK engine's band-split mixed excitation, DFS -b twice and
// VOPR -a.
//
// Replaces hts_train_world_tpu/ops/excitation.py:85-107 (fir,
// mixed_excitation), which on the TPU ran two jnp.convolve(x, b)[:n]
// (causal 31-tap FIRs) and their sum: y[t] = sum_k low[k] v[t-k] +
// sum_k high[k] u[t-k].  One thread a sample; the two filters' taps are
// read from global memory through the read-only cache (every thread of a
// warp reads the same tap, one broadcast), so a launch writes no shared
// state and two streams may filter with different taps at once.  Each
// FIR is summed tap by tap from its product with x[t] (each product
// rounded, then added; --fmad=false), the two sums added last: the
// twin's order (ops/excitation.py fir), so the two agree bit for bit.
//
// Bound: bytes.  Two inputs read and one output written, 62 multiply-adds
// a sample; the neighbours' reads hit L1.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 64;

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_fir_kernel(const T* __restrict__ v, const T* __restrict__ u, long long n,
                const double* __restrict__ taps, int K, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  T lo = (T)__ldg(&taps[0]) * v[t];
  T hi = (T)__ldg(&taps[K]) * u[t];
  for (int k = 1; k < K && k <= t; ++k) {
    lo = lo + (T)__ldg(&taps[k]) * v[t - k];
    hi = hi + (T)__ldg(&taps[K + k]) * u[t - k];
  }
  out[t] = lo + hi;
}

template <typename T>
int launch(const void* v, const void* u, long long n, const double* taps,
           int K, void* out, cudaStream_t s) {
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  band_fir_kernel<T><<<blocks, THREADS, 0, s>>>(
      (const T*)v, (const T*)u, n, taps, K, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// v, u (n,) excitations; taps (2, K) float64 on the device (low, high);
// out (n,); f64 picks double.
extern "C" int band_fir_launch(const void* v, const void* u, long long n,
                               const double* taps, int K, int f64, void* out,
                               cudaStream_t s) {
  if (K < 1 || K > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  return f64 ? launch<double>(v, u, n, taps, K, out, s)
             : launch<float>(v, u, n, taps, K, out, s);
}
