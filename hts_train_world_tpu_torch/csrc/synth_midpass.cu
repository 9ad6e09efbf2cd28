// K30: synthesis's mid-pass, one thread per (utterance, pulse, bin).
//
// Replaces hts_train_world_tpu/ops/synthesis.py:195-209,228-232 (with
// ops/fftmat.py minphase_matmul), the elementwise work between the DFT
// matmuls of fast-mode synthesis, which XLA fused on the TPU and which
// plain PyTorch ran as 39 separate launches: per pulse and bin, the
// minimum-phase spectra exp(log_p R) (cos, sin)(log_p I) and
// exp(log_a R) (cos, sin)(log_a I), the fractional-delay factor re2 =
// cos(coef k), im2 = sqrt(1 - re2^2) (synthesis.cpp's form), and the two
// complex products that feed the inverse DFTs:
//   (sre, sim) = periodic spectrum x conj(delay),
//   (pre, pim) = aperiodic spectrum x noise spectrum.
// coef = 2 pi shift fs / N comes per pulse from the wrapper, computed as
// the plain twin computes it.  The matmuls around it stay torch.matmul,
// as the JAX package leaves them to XLA.
//
// Inputs lpr, lpi, lar, lai, nre, nim (B*P, H), coef (B*P,); outputs sre,
// sim, pre, pim (B*P, H).  Bound: bytes (six arrays read, four written,
// each once); the math is ~25 operations an element.  Built with
// --fmad=false, so each product rounds as the twin's separate torch calls
// do, and exp / cos / sin / sqrt are CUDA's full-precision forms.
//
// A template on the scalar type.  In float (the fast path) the log
// spectra come from the min-phase DFT matmuls; in double (the parity
// path, synthesis.py:180-209,215-224) from torch.fft, as the JAX exact
// path takes jnp.fft (prims.py:512-532), and the noise spectrum from
// torch.fft.rfft.  JAX exponentiates the complex log, jnp.exp(D / N); here
// exp(re) (cos im, sin im), the same function, within a few float64 ulps
// of it (the check states the bound).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
synth_midpass_kernel(const T* __restrict__ lpr, const T* __restrict__ lpi,
                     const T* __restrict__ lar, const T* __restrict__ lai,
                     const T* __restrict__ nre, const T* __restrict__ nim,
                     const T* __restrict__ coef, long long rows, int H,
                     T* __restrict__ sre, T* __restrict__ sim,
                     T* __restrict__ pre, T* __restrict__ pim) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= rows * H) return;
  const long long row = g / H;
  const int k = (int)(g - row * H);
  const T mag = exp_(lpr[g]);
  const T re = mag * cos_(lpi[g]);
  const T im = mag * sin_(lpi[g]);
  const T re2 = cos_(coef[row] * (T)k);
  const T im2 = sqrt_((T)1 - re2 * re2);
  sre[g] = re * re2 + im * im2;
  sim[g] = im * re2 - re * im2;
  const T amag = exp_(lar[g]);
  const T are = amag * cos_(lai[g]);
  const T aim = amag * sin_(lai[g]);
  const T a = nre[g], b = nim[g];
  pre[g] = are * a - aim * b;
  pim[g] = are * b + aim * a;
}

template <typename T>
void launch(const void* lpr, const void* lpi, const void* lar,
            const void* lai, const void* nre, const void* nim,
            const void* coef, long long rows, int H, void* sre, void* sim,
            void* pre, void* pim, cudaStream_t s) {
  const long long n = rows * H;
  synth_midpass_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                            0, s>>>(
      static_cast<const T*>(lpr), static_cast<const T*>(lpi),
      static_cast<const T*>(lar), static_cast<const T*>(lai),
      static_cast<const T*>(nre), static_cast<const T*>(nim),
      static_cast<const T*>(coef), rows, H, static_cast<T*>(sre),
      static_cast<T*>(sim), static_cast<T*>(pre), static_cast<T*>(pim));
}

}  // namespace

// f64: 0 for float arrays, 1 for double.
extern "C" int synth_midpass_launch(const void* lpr, const void* lpi,
                                    const void* lar, const void* lai,
                                    const void* nre, const void* nim,
                                    const void* coef, long long rows, int H,
                                    int f64, void* sre, void* sim, void* pre,
                                    void* pim, cudaStream_t s) {
  if (rows * H > 0) {
    if (f64)
      launch<double>(lpr, lpi, lar, lai, nre, nim, coef, rows, H, sre, sim,
                     pre, pim, s);
    else
      launch<float>(lpr, lpi, lar, lai, nre, nim, coef, rows, H, sre, sim,
                    pre, pim, s);
  }
  return (int)cudaGetLastError();
}
