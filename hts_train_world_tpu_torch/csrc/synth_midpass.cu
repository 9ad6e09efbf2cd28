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
// Inputs lpr, lpi, lar, lai, nre, nim (B*P, H) float32, coef (B*P,);
// outputs sre, sim, pre, pim (B*P, H).  Bound: bytes (six arrays read, four
// written, each once); the math is ~25 operations an element.  Built with
// --fmad=false, so each product rounds as the twin's separate torch calls
// do, and expf / cosf / sinf / sqrtf are CUDA's full-precision forms.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
synth_midpass_kernel(const float* __restrict__ lpr,
                     const float* __restrict__ lpi,
                     const float* __restrict__ lar,
                     const float* __restrict__ lai,
                     const float* __restrict__ nre,
                     const float* __restrict__ nim,
                     const float* __restrict__ coef, long long rows, int H,
                     float* __restrict__ sre, float* __restrict__ sim,
                     float* __restrict__ pre, float* __restrict__ pim) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= rows * H) return;
  const long long row = g / H;
  const int k = (int)(g - row * H);
  const float mag = expf(lpr[g]);
  const float re = mag * cosf(lpi[g]);
  const float im = mag * sinf(lpi[g]);
  const float re2 = cosf(coef[row] * (float)k);
  const float im2 = sqrtf(1.0f - re2 * re2);
  sre[g] = re * re2 + im * im2;
  sim[g] = im * re2 - re * im2;
  const float amag = expf(lar[g]);
  const float are = amag * cosf(lai[g]);
  const float aim = amag * sinf(lai[g]);
  const float a = nre[g], b = nim[g];
  pre[g] = are * a - aim * b;
  pim[g] = are * b + aim * a;
}

}  // namespace

extern "C" int synth_midpass_launch(const void* lpr, const void* lpi,
                                    const void* lar, const void* lai,
                                    const void* nre, const void* nim,
                                    const void* coef, long long rows, int H,
                                    void* sre, void* sim, void* pre,
                                    void* pim, cudaStream_t s) {
  const long long n = rows * H;
  if (n > 0)
    synth_midpass_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                           0, s>>>(
        static_cast<const float*>(lpr), static_cast<const float*>(lpi),
        static_cast<const float*>(lar), static_cast<const float*>(lai),
        static_cast<const float*>(nre), static_cast<const float*>(nim),
        static_cast<const float*>(coef), rows, H, static_cast<float*>(sre),
        static_cast<float*>(sim), static_cast<float*>(pre),
        static_cast<float*>(pim));
  return (int)cudaGetLastError();
}
