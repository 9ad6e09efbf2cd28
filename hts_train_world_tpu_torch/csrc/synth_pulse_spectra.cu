// K10: each pulse's log spectra and noise segment, one block per pulse.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:154-175 (the frame lerp of
// |sp| and the clamped ap, as an interpolation-weight matmul on the TPU),
// :177-194 (the periodic log spectrum and the unvoiced test) and :217-227
// (the noise segment, its mean removed, and the aperiodic log spectrum).
// On the TPU these were XLA passes writing each intermediate (sp_env,
// ap, apr, the masked noise, its mean) to HBM.  Here a block reads the two
// frame rows its pulse falls between and the stream segment once and
// writes only what the first DFT matmuls read: log_p and log_a
// (N/2+1 each), the noise segment (N) and the unvoiced flag.
//
// Bound: bytes, about 16 KB written per pulse at N = 2048.  The lerp and
// the logs are the twin's f32 operations (--fmad=false); the logs are
// CUDA's logf and the segment mean sums in another order than the twin,
// so the check holds them within a few ulps.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float clamp_lo_hi(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);     // NaN passes, as torch.clamp
}

__global__ void __launch_bounds__(THREADS)
synth_pulse_spectra_kernel(const float* __restrict__ sp,
                           const float* __restrict__ ap, int T, int H,
                           const float* __restrict__ stream, int S,
                           const float* __restrict__ ptime,
                           const float* __restrict__ vuv,
                           const long long* __restrict__ nsize,
                           const long long* __restrict__ noff, int P, int N,
                           float fp, float tiny, float* __restrict__ log_p,
                           float* __restrict__ log_a,
                           float* __restrict__ noise,
                           bool* __restrict__ unvoiced) {
  __shared__ float red[32];
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P), tid = threadIdx.x;
  const float lo = (float)0.001, hi = (float)0.999999999999;
  const float guard = (float)1e-12;           // kMySafeGuardMinimum

  // frame interpolation position (synthesis.cpp:140-178)
  const float pos = ptime[bp] / fp;
  const float last = (float)(T - 1);
  float ffl = floorf(pos), fce = ceilf(pos);
  ffl = ffl > last ? last : ffl;
  fce = fce > last ? last : fce;
  const long long fl = (long long)ffl, ce = (long long)fce;
  const float frac = pos - floorf(pos);
  const bool same = fl == ce;
  const float v = vuv[bp];
  const float* sa = sp + ((size_t)b * T + fl) * H;
  const float* sb = sp + ((size_t)b * T + ce) * H;
  const float* aa = ap + ((size_t)b * T + fl) * H;
  const float* ab = ap + ((size_t)b * T + ce) * H;
  float* lp = log_p + (size_t)bp * H;
  float* la = log_a + (size_t)bp * H;
  for (int h = tid; h < H; h += THREADS) {
    const float s0 = fabsf(sa[h]), s1 = fabsf(sb[h]);
    const float env = same ? s0 : s0 * (1.0f - frac) + s1 * frac;
    const float a0 = clamp_lo_hi(aa[h], lo, hi);
    const float a1 = clamp_lo_hi(ab[h], lo, hi);
    float apr = same ? a0 : a0 * (1.0f - frac) + a1 * frac;
    apr = apr * apr;
    if (h == 0) unvoiced[bp] = (v <= 0.5f) || (apr > (float)0.999);
    lp[h] = logf(env * (1.0f - apr) + guard) / 2.0f;
    float e = v != 0.0f ? env * apr : env;
    e = e < tiny ? tiny : e;
    la[h] = logf(e) / 2.0f;
  }

  // the noise segment (synthesis.cpp:38-68): the first ns draws from the
  // pulse's offset (zeros past the stream), mean removed, zero beyond ns
  const long long ns = nsize[bp], off = noff[bp];
  const float* st = stream + (size_t)b * S;
  float* nz = noise + (size_t)bp * N;
  float part = 0.0f;
  for (int k = tid; k < N; k += THREADS) {
    if (k < ns) {
      const long long i = off + k;
      part += (i >= 0 && i < S) ? st[i] : 0.0f;
    }
  }
  const float avg = block_sum(part, red) / (float)(ns < 1 ? 1 : ns);
  for (int k = tid; k < N; k += THREADS) {
    float o = 0.0f;
    if (k < ns) {
      const long long i = off + k;
      o = ((i >= 0 && i < S) ? st[i] : 0.0f) - avg;
    }
    nz[k] = o;
  }
}

}  // namespace

extern "C" int synth_pulse_spectra_launch(
    const float* sp, const float* ap, int B, int T, int H,
    const float* stream, int S, const float* ptime, const float* vuv,
    const long long* nsize, const long long* noff, int P, int N, float fp,
    float tiny, float* log_p, float* log_a, float* noise, bool* unvoiced,
    cudaStream_t s) {
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  if (T < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  synth_pulse_spectra_kernel<<<(unsigned)((long long)B * P), THREADS, 0, s>>>(
      sp, ap, T, H, stream, S, ptime, vuv, nsize, noff, P, N, fp, tiny,
      log_p, log_a, noise, unvoiced);
  return (int)cudaGetLastError();
}
