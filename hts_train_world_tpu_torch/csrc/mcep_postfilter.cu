// K22: the mel-cepstral postfilter (postfiltering_mcp), one block per
// frame.
//
// Replaces hts_train_world_tpu/ops/postfilter.py:32-45 (mcep_postfilter)
// with ops/sptk.py:44-85 (freqt, c2acr, mc2b, b2mc), which on the TPU ran,
// for the frame and for its formant-emphasised copy (coefficients 2.. times
// pf), a (M, 2048) freqt matrix product to a 2048-term cepstrum (co =
// 2047, dewarped by -alpha), an rfft at fft_size (which CROPS that
// cepstrum to its first fft_size terms when fft_size < 2048), exp(2 Re),
// an irfft for lag 0, and then mc2b, a c0 correction of 0.5 ln(r0/r0')
// and b2mc.  Every step before the exp is linear in the cepstrum, so the
// wrapper folds freqt and the cosine transform, cropped alike, into one
// float64 table G (M, fft_size/2+1), G[m, k] = sum_{j < min(fft_size,
// 2048)} freqt[m, j] cos(2 pi j k / fft_size).  A block reads its frame,
// forms Re C_k for both cepstra as M-term dot products with G's columns,
// sums p_k = exp(2 Re C_k) with the C2R weights (1 at bins 0 and N/2, 2
// elsewhere) in a float64 block reduction (the 1/N of lag 0 cancels in
// the ratio), and writes the emphasised cepstrum with c0 moved by
// 0.5 ln(r0/r0'): b2mc(mc2b(x)) is x, so only c0 changes.
//
// Bound: operations.  2 x M x (N/2+1) multiply-adds and 2 (N/2+1) exps a
// frame; G (200 KB at M 50, N 1024) stays in L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXM = 256;

__global__ void __launch_bounds__(THREADS)
mcep_postfilter_kernel(const double* __restrict__ mgc, int T, int M,
                       const double* __restrict__ G, int H, double pf,
                       double* __restrict__ out) {
  __shared__ double c[MAXM], w[MAXM], red[32];
  const int t = blockIdx.x;
  for (int m = threadIdx.x; m < M; m += THREADS) {
    c[m] = mgc[(size_t)t * M + m];
    w[m] = c[m] * (m >= 2 ? pf : 1.0);
  }
  __syncthreads();
  double r = 0.0, rw = 0.0;
  for (int k = threadIdx.x; k < H; k += THREADS) {
    double s = 0.0, sw = 0.0;
    for (int m = 0; m < M; ++m) {
      const double g = G[(size_t)m * H + k];
      s = s + c[m] * g;
      sw = sw + w[m] * g;
    }
    const double a = (k == 0 || k == H - 1) ? 1.0 : 2.0;
    r = r + a * exp(2.0 * s);
    rw = rw + a * exp(2.0 * sw);
  }
  r = block_sum(r, red);
  rw = block_sum(rw, red);
  const double delta = log(r / rw) / 2.0;
  for (int m = threadIdx.x; m < M; m += THREADS)
    out[(size_t)t * M + m] = m == 0 ? w[0] + delta : w[m];
}

}  // namespace

// mgc (T, M) float64 with M <= 256, G (M, H) with H = fft_size/2 + 1.
extern "C" int mcep_postfilter_launch(const double* mgc, int T, int M,
                                      const double* G, int H, double pf,
                                      double* out, cudaStream_t s) {
  if (M > MAXM || H < 2) return (int)cudaErrorInvalidValue;
  if (T > 0 && M > 0)
    mcep_postfilter_kernel<<<T, THREADS, 0, s>>>(mgc, T, M, G, H, pf, out);
  return (int)cudaGetLastError();
}
