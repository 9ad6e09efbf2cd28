// K29: the adjoint of K28 (the trajectory cost's banded solve), one thread
// per (utterance, static dimension).
//
// Replaces the gradient that the JAX package takes with jax.grad through
// hts_train_world_tpu/models/acoustic.py:103-211 and ops/mlpg.py:29-103
// (reverse-mode through build_banded_normal's scatters and the two
// lax.scans of the LDL^T solve and of _ldlt_ds).  With A = sum_w W_w^T P_w
// W_w, c = A^-1 b, e = s - c, q = e^T A e and logdet = log det A, the
// cotangents g_c, g_q, g_logdet give
//   r      = g_c - 2 g_q A e,            lambda = A^-1 r,
//   G_A    = g_q e e^T + g_logdet A^-1 - sym(lambda c^T)   (on A's band),
//   g_mu[t,w]   = prec[t,w] (W_w lambda)[t],
//   g_prec[t,w] = (W_w lambda)[t] mu[t,w] + sum_{k,j} w_k w_j G_A[t+k, t+j].
// lambda reuses K28's saved factors: a forward substitution over the frames
// (z = D^-1 L^-1 r into scratch), then one reverse sweep that back-
// substitutes lambda and, from the same L and d, runs Takahashi's recursion
// for the band of A^-1 (Sigma_ii, Sigma_i,i+1, Sigma_i,i+2), forms G_A's
// band for row i and writes both gradients of frame i+1, whose window taps
// reach rows i..i+2.  Entries outside [0, T) are exact zeros, as the
// dropped taps of the forward are.
//
// Inputs mu, prec (B, T, nw, D); s, c, g_c (B, T, D); saved (6, B, T, D) as
// K28 wrote them; g_q, g_logdet (B, D).  Outputs g_mu, g_prec (B, T, nw, D);
// scratch z (B, T, D).  A template on float and double; --fmad=false.
//
// Bound: latency, as K28 (2*T dependent steps a thread, B*D threads).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXW = 4;

template <typename F>
__device__ __forceinline__ void emit(
    int t, int nw, int D, const F (&cw)[MAXW][3], const F* mub,
    const F* pb, F* gmu, F* gprec, F lm, F l0, F lp, F Gmm, F Gm0, F Gmp,
    F G00, F G0p, F Gpp) {
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    if (w >= nw) break;
    const F wm = cw[w][0], w0 = cw[w][1], wp = cw[w][2];
    const F wl = wm * lm + w0 * l0 + wp * lp;
    const F quad = wm * wm * Gmm + w0 * w0 * G00 + wp * wp * Gpp
                   + F(2) * (wm * w0 * Gm0 + wm * wp * Gmp + w0 * wp * G0p);
    const size_t at = ((size_t)t * nw + w) * D;
    gmu[at] = pb[at] * wl;
    gprec[at] = wl * mub[at] + quad;
  }
}

template <typename F>
__global__ void __launch_bounds__(THREADS)
trajectory_adjoint_kernel(const F* __restrict__ mu, const F* __restrict__ prec,
                          const F* __restrict__ s, const F* __restrict__ c,
                          const F* __restrict__ saved,
                          const F* __restrict__ g_c, const F* __restrict__ g_q,
                          const F* __restrict__ g_ld, int B, int T, int nw,
                          int D, const F* __restrict__ coef,
                          F* __restrict__ zs, F* __restrict__ g_mu,
                          F* __restrict__ g_prec) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= B * D) return;
  const int b = g / D, d = g % D;
  const size_t wb = (size_t)b * T * nw * D + d;
  const F* mub = mu + wb;
  const F* pb = prec + wb;
  F* gmu = g_mu + wb;
  F* gprec = g_prec + wb;
  const size_t ob = (size_t)b * T * D + d;
  const size_t plane = (size_t)B * T * D;
  const F* ds = saved + ob;
  const F* l1s = saved + plane + ob;
  const F* l2s = saved + 2 * plane + ob;
  const F* a0s = saved + 3 * plane + ob;
  const F* a1s = saved + 4 * plane + ob;
  const F* a2s = saved + 5 * plane + ob;
  const F* sb = s + ob;
  const F* cb = c + ob;
  const F* gcb = g_c + ob;
  F* zb = zs + ob;
  const F gq = g_q[(size_t)b * D + d], gl = g_ld[(size_t)b * D + d];
  F cw[MAXW][3];
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
#pragma unroll
    for (int k = 0; k < 3; ++k) cw[w][k] = w < nw ? coef[w * 3 + k] : F(0);

  // forward substitution of r = g_c - 2 g_q A e; E[j] = e at frame i-2+j
  F E[5];
  E[0] = E[1] = F(0);
#pragma unroll
  for (int j = 2; j < 5; ++j) {
    const int t = j - 2;
    E[j] = t < T ? sb[(size_t)t * D] - cb[(size_t)t * D] : F(0);
  }
  F y1 = F(0), y2 = F(0);
  for (int i = 0; i < T; ++i) {
    const size_t at = (size_t)i * D;
    const F up1 = i + 1 < T ? a1s[at] * E[3] : F(0);
    const F dn1 = i >= 1 ? a1s[at - D] * E[1] : F(0);
    const F up2 = i + 2 < T ? a2s[at] * E[4] : F(0);
    const F dn2 = i >= 2 ? a2s[at - 2 * D] * E[0] : F(0);
    const F ae = a0s[at] * E[2] + up1 + dn1 + up2 + dn2;
    const F r = gcb[at] - F(2) * gq * ae;
    const F yi = r - l1s[at] * y1 - l2s[at] * y2;
    zb[at] = yi / ds[at];
    y2 = y1;
    y1 = yi;
#pragma unroll
    for (int j = 0; j < 4; ++j) E[j] = E[j + 1];
    const int tn = i + 3;
    E[4] = tn < T ? sb[(size_t)tn * D] - cb[(size_t)tn * D] : F(0);
  }

  // reverse sweep: lambda, the band of A^-1, G_A's band, the gradients
  F lam1 = F(0), lam2 = F(0);            // lambda at i+1, i+2
  F S11 = F(0), S12 = F(0), S22 = F(0);  // Sigma (i+1,i+1), (i+1,i+2), (i+2,i+2)
  F c1 = F(0), c2 = F(0), e1 = F(0), e2 = F(0);
  F G11 = F(0), G12 = F(0), G22 = F(0);  // G_A (i+1,i+1), (i+1,i+2), (i+2,i+2)
  for (int i = T - 1; i >= 0; --i) {
    const size_t at = (size_t)i * D;
    const F l1n = i + 1 < T ? l1s[at + D] : F(0);
    const F l2n = i + 2 < T ? l2s[at + 2 * D] : F(0);
    const F lam = zb[at] - l1n * lam1 - l2n * lam2;
    const F S02 = -l1n * S12 - l2n * S22;
    const F S01 = -l1n * S11 - l2n * S12;
    const F S00 = F(1) / ds[at] - l1n * S01 - l2n * S02;
    const F ci = cb[at];
    const F ei = sb[at] - ci;
    const F G00 = gq * ei * ei + gl * S00 - lam * ci;
    const F G01 = gq * ei * e1 + gl * S01 - F(0.5) * (lam * c1 + ci * lam1);
    const F G02 = gq * ei * e2 + gl * S02 - F(0.5) * (lam * c2 + ci * lam2);
    if (i + 1 < T)
      emit<F>(i + 1, nw, D, cw, mub, pb, gmu, gprec, lam, lam1, lam2, G00,
              G01, G02, G11, G12, G22);
    lam2 = lam1;
    lam1 = lam;
    S22 = S11;
    S12 = S01;
    S11 = S00;
    c2 = c1;
    c1 = ci;
    e2 = e1;
    e1 = ei;
    G22 = G11;
    G12 = G01;
    G11 = G00;
  }
  emit<F>(0, nw, D, cw, mub, pb, gmu, gprec, F(0), lam1, lam2, F(0), F(0),
          F(0), G11, G12, G22);
}

template <typename F>
int launch(const void* mu, const void* prec, const void* s, const void* c,
           const void* saved, const void* g_c, const void* g_q,
           const void* g_ld, int B, int T, int nw, int D, const void* coef,
           void* zs, void* g_mu, void* g_prec, cudaStream_t st) {
  if (nw > MAXW) return (int)cudaErrorInvalidValue;
  const int n = B * D;
  if (n > 0 && T > 0)
    trajectory_adjoint_kernel<F><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                   st>>>(
        static_cast<const F*>(mu), static_cast<const F*>(prec),
        static_cast<const F*>(s), static_cast<const F*>(c),
        static_cast<const F*>(saved), static_cast<const F*>(g_c),
        static_cast<const F*>(g_q), static_cast<const F*>(g_ld), B, T, nw, D,
        static_cast<const F*>(coef), static_cast<F*>(zs),
        static_cast<F*>(g_mu), static_cast<F*>(g_prec));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors, 1 for double (every tensor alike).
extern "C" int trajectory_adjoint_launch(
    const void* mu, const void* prec, const void* s, const void* c,
    const void* saved, const void* g_c, const void* g_q, const void* g_ld,
    int B, int T, int nw, int D, const void* coef, int f64, void* zs,
    void* g_mu, void* g_prec, cudaStream_t st) {
  return f64 ? launch<double>(mu, prec, s, c, saved, g_c, g_q, g_ld, B, T,
                              nw, D, coef, zs, g_mu, g_prec, st)
             : launch<float>(mu, prec, s, c, saved, g_c, g_q, g_ld, B, T, nw,
                             D, coef, zs, g_mu, g_prec, st);
}
