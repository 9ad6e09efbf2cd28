// K21: the modulation-spectrum postfilter (MSPF), one block per
// trajectory (a dimension of one utterance's statics).
//
// Replaces hts_train_world_tpu/ops/postfilter.py:51-144 (_frames,
// seq2msmp, msmp2seq, apply_mspf, and the analysis inside mspf_stats),
// which on the TPU vmapped over dimensions: a gather of centred 25-frame
// windows at hop 12, a Bartlett window, rfft at 64, log magnitude and
// phase, the map toward the natural statistics, irfft, and a flat
// scatter-add overlap-add.  Here one block owns one trajectory:
//   0. the trajectory's mean (a float64 block sum over T);
//   1. per (frame, bin): the 64-point DFT of the windowed frame as a
//      direct sum of its 25 samples against twiddles in shared memory
//      (frames centred at k*12, zero outside [0, T)), ms = 0.5
//      log(re^2 + im^2 + 1e-30), mp = atan2(im, re) / pi.  Analysis mode
//      writes ms and stops.  Apply mode maps ms toward the natural
//      statistics, ms' = ms + w (((ms - gen_mean) / gen_std) nat_std +
//      nat_mean - ms) (a zero gen_std gives inf/NaN, as in JAX), and
//      stores exp(ms') (cos, sin)(pi mp) in device scratch;
//   2. per (frame, sample): the 64-point inverse real DFT (the imaginary
//      parts of bins 0 and 32 are dropped, as a C2R transform drops them);
//   3. per output sample t: the overlap-add as a gather of the frames that
//      cover t + 12, in ascending frame order from 0.0 (the order of the
//      CPU twin's index_add_, so the sum is deterministic), plus the mean.
// Every frame of the inverse is 64 samples long, so up to 6 frames cover
// an output sample.
//
// Bound: latency.  A trajectory of T <= ~1100 frames is ~93 frames x 33
// bins x 25 taps for the forward and 93 x 64 x 33 for the inverse; the
// launch has one block per dimension (50 at mgc's width), each a few
// microseconds of float64 arithmetic and transcendental calls.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LEN = 25;            // mspfLength
constexpr int SHIFT = 12;          // (LEN - 1) / 2
constexpr int NFFT = 64;           // mspfFFTLen
constexpr int NBIN = NFFT / 2 + 1;
constexpr double PI = 3.141592653589793;

__global__ void __launch_bounds__(THREADS)
mspf_kernel(const double* __restrict__ x, int T, int D, int F,
            const double* __restrict__ nat_mean,
            const double* __restrict__ nat_std,
            const double* __restrict__ gen_mean,
            const double* __restrict__ gen_std, double weight, int analysis,
            double* __restrict__ ms_out, double* __restrict__ spec,
            double* __restrict__ frames, double* __restrict__ out) {
  __shared__ double cs[NFFT], sn[NFFT], bart[LEN], red[32];
  const int d = blockIdx.x;
  for (int j = threadIdx.x; j < NFFT; j += THREADS) {
    sincospi(2.0 * j / NFFT, &sn[j], &cs[j]);
  }
  for (int n = threadIdx.x; n < LEN; n += THREADS) {
    bart[n] = 1.0 - fabs((n - (LEN - 1) / 2.0) / ((LEN - 1) / 2.0));
  }
  double s = 0.0;
  for (int t = threadIdx.x; t < T; t += THREADS) s += x[(size_t)t * D + d];
  const double mean = block_sum(s, red) / T;   // block_sum syncs the tables

  // 1. forward DFT of every windowed frame, magnitude and phase
  const size_t sb = (size_t)d * F * NBIN;
  for (int i = threadIdx.x; i < F * NBIN; i += THREADS) {
    const int f = i / NBIN, k = i % NBIN;
    double re = 0.0, im = 0.0;
    for (int n = 0; n < LEN; ++n) {
      const int t = f * SHIFT + n - (LEN - 1) / 2;
      const double v = (t >= 0 && t < T)
                           ? (x[(size_t)t * D + d] - mean) * bart[n] : 0.0;
      const int j = (k * n) & (NFFT - 1);
      re = re + v * cs[j];
      im = im - v * sn[j];
    }
    const double ms = 0.5 * log(re * re + im * im + 1e-30);
    if (analysis) {
      ms_out[sb + i] = ms;
      continue;
    }
    const double mp = atan2(im, re) / PI;
    const size_t dk = (size_t)d * NBIN + k;
    const double conv =
        ((ms - gen_mean[dk]) / gen_std[dk]) * nat_std[dk] + nat_mean[dk];
    const double mag = exp(ms + weight * (conv - ms));
    const double ph = PI * mp;
    spec[2 * (sb + i)] = mag * cos(ph);
    spec[2 * (sb + i) + 1] = mag * sin(ph);
  }
  if (analysis) return;
  __syncthreads();

  // 2. inverse real DFT of every frame (bins 0 and 32 real)
  const size_t fb = (size_t)d * F * NFFT;
  for (int i = threadIdx.x; i < F * NFFT; i += THREADS) {
    const int f = i / NFFT, n = i % NFFT;
    const double* y = spec + 2 * (sb + (size_t)f * NBIN);
    double acc = 0.0;
    for (int k = 1; k < NBIN - 1; ++k) {
      const int j = (k * n) & (NFFT - 1);
      acc = acc + (y[2 * k] * cs[j] - y[2 * k + 1] * sn[j]);
    }
    const double nyq = (n & 1) ? -y[2 * (NBIN - 1)] : y[2 * (NBIN - 1)];
    frames[fb + i] = (y[0] + nyq + 2.0 * acc) / NFFT;
  }
  __syncthreads();

  // 3. overlap-add as a gather, ascending frames, plus the mean
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const int p = t + SHIFT;
    const int k0 = max(0, (p - (NFFT - 1) + SHIFT - 1) / SHIFT);
    const int k1 = min(F - 1, p / SHIFT);
    double acc = 0.0;
    for (int k = k0; k <= k1; ++k)
      acc = acc + frames[fb + (size_t)k * NFFT + (p - k * SHIFT)];
    out[(size_t)t * D + d] = acc + mean;
  }
}

}  // namespace

// x (T, D) float64.  analysis != 0: ms_out (D, F, 33) only.  Otherwise the
// four (D, 33) statistics, spec scratch (D, F, 33, 2), frames scratch
// (D, F, 64) and out (T, D).
extern "C" int mspf_launch(const double* x, int T, int D, int F,
                           const double* nat_mean, const double* nat_std,
                           const double* gen_mean, const double* gen_std,
                           double weight, int analysis, double* ms_out,
                           double* spec, double* frames, double* out,
                           cudaStream_t s) {
  if (T > 0 && D > 0)
    mspf_kernel<<<D, THREADS, 0, s>>>(x, T, D, F, nat_mean, nat_std,
                                       gen_mean, gen_std, weight, analysis,
                                       ms_out, spec, frames, out);
  return (int)cudaGetLastError();
}
