// K28: the trajectory cost's banded solve, one thread per (utterance,
// static dimension).
//
// Replaces hts_train_world_tpu/models/acoustic.py:103-211
// (trajectory_cost's in-graph MLPG, quad_per_dim and _ldlt_ds under vmap)
// with ops/mlpg.py:29-103 (build_banded_normal + banded_ldlt_solve), which
// on the TPU built the pentadiagonal normal matrix A = sum_w W_w^T P_w W_w
// with scatter-adds over (3, T) band arrays, then ran the LDL^T recursion
// as lax.scans (once for the solve, once more for the log-det) and the
// quadratic form as whole-array products.  Here each thread forms row i of
// A and of b = sum_w W_w^T P_w mu_w on the fly from the precisions and means
// of frames i-1, i, i+1 (K8's rows, in the plain twin's window and
// tap order), runs the LDL^T forward recursion, summing log d_i, and saves
// d, L[i,i-1], L[i,i-2] and A's three bands for the adjoint (K29).  The back
// substitution walks the frames in reverse and forms the banded quadratic
// form e^T A e, e = s - c, as it goes.
//
// Inputs mu, prec (B, T, nw, D), s (B, T, D); outputs c (B, T, D), q and
// logdet (B, D), saved (6, B, T, D): d, l1, l2, A[i,i], A[i,i+1], A[i,i+2].
// Neighbouring threads hold neighbouring dimensions, so a warp reads and
// writes neighbouring addresses.
//
// A template on the scalar type: float for training (as the JAX package
// trains in float32), double for the card's gradcheck.  Built with
// --fmad=false, like every kernel here.
//
// Bound: latency.  Each thread runs 2*T dependent steps; at the pipeline's
// TRJGV (B = 1, D = 79) only 79 threads run.  Bytes (mu and prec read once,
// s once, c, q, logdet and the saved planes written once) give the floor
// PERF.md states beside it.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXW = 4;

template <typename F>
__global__ void __launch_bounds__(THREADS)
trajectory_nll_kernel(const F* __restrict__ mu, const F* __restrict__ prec,
                      const F* __restrict__ s, int B, int T, int nw, int D,
                      const F* __restrict__ coef, F* __restrict__ saved,
                      F* __restrict__ c, F* __restrict__ q,
                      F* __restrict__ logdet) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= B * D) return;
  const int b = g / D, d = g % D;
  const F* mub = mu + (size_t)b * T * nw * D + d;
  const F* pb = prec + (size_t)b * T * nw * D + d;
  const size_t ob = (size_t)b * T * D + d;
  const size_t plane = (size_t)B * T * D;
  F* ds = saved + ob;
  F* l1s = saved + plane + ob;
  F* l2s = saved + 2 * plane + ob;
  F* a0s = saved + 3 * plane + ob;
  F* a1s = saved + 4 * plane + ob;
  F* a2s = saved + 5 * plane + ob;
  F cw[MAXW][3];
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
#pragma unroll
    for (int k = 0; k < 3; ++k) cw[w][k] = w < nw ? coef[w * 3 + k] : F(0);

  // P / U [w][slot]: precision and mean at frame i-1+slot (0 outside [0, T))
  F P[MAXW][3], U[MAXW][3];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    P[w][0] = U[w][0] = F(0);
#pragma unroll
    for (int sl = 1; sl < 3; ++sl) {
      const int t = sl - 1;
      const bool ok = w < nw && t < T;
      P[w][sl] = ok ? pb[((size_t)t * nw + w) * D] : F(0);
      U[w][sl] = ok ? mub[((size_t)t * nw + w) * D] : F(0);
    }
  }

  F d1 = F(1), d2 = F(1), y1 = F(0), y2 = F(0), lp = F(0), ld = F(0);
  for (int i = 0; i < T; ++i) {
    // row i: A[i,i], A[i-1,i], A[i-2,i] and b[i]
    F a[3] = {F(0), F(0), F(0)}, r = F(0);
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
#pragma unroll
      for (int ki = 0; ki < 3; ++ki) {
        const F wk = cw[w][ki];
        if (wk == F(0)) continue;
        const int t = i - (ki - 1);
        if (t >= 0 && t < T) r = r + P[w][2 - ki] * U[w][2 - ki] * wk;
#pragma unroll
        for (int kj = ki; kj < 3; ++kj) {
          const F wj = cw[w][kj];
          if (wj == F(0)) continue;
          const int off = kj - ki;
          const int tt = i - (kj - 1);
          if (tt >= 0 && tt < T && i - off >= 0)
            a[off] = a[off] + P[w][2 - kj] * wk * wj;
        }
      }
    }
    const F ai1 = i >= 1 ? a[1] : F(0), ai2 = i >= 2 ? a[2] : F(0);
    const F l2 = ai2 / d2;
    const F l1 = (ai1 - l2 * d2 * lp) / d1;
    const F di = a[0] - l1 * l1 * d1 - l2 * l2 * d2;
    const F yi = r - l1 * y1 - l2 * y2;
    c[ob + (size_t)i * D] = yi / di;  // z, back-substituted below
    ds[(size_t)i * D] = di;
    l1s[(size_t)i * D] = l1;
    l2s[(size_t)i * D] = l2;
    a0s[(size_t)i * D] = a[0];
    if (i >= 1) a1s[(size_t)(i - 1) * D] = ai1;
    if (i >= 2) a2s[(size_t)(i - 2) * D] = ai2;
    ld = ld + log(di);
    d2 = d1;
    d1 = di;
    y2 = y1;
    y1 = yi;
    lp = l1;
    const int tn = i + 2;
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      P[w][0] = P[w][1];
      U[w][0] = U[w][1];
      P[w][1] = P[w][2];
      U[w][1] = U[w][2];
      const bool ok = w < nw && tn < T;
      P[w][2] = ok ? pb[((size_t)tn * nw + w) * D] : F(0);
      U[w][2] = ok ? mub[((size_t)tn * nw + w) * D] : F(0);
    }
  }
  a1s[(size_t)(T - 1) * D] = F(0);
  a2s[(size_t)(T - 1) * D] = F(0);
  if (T >= 2) a2s[(size_t)(T - 2) * D] = F(0);

  // back substitution, and e^T A e with e = s - c from the last row up
  F c1 = F(0), c2 = F(0), e1 = F(0), e2 = F(0), qq = F(0);
  for (int i = T - 1; i >= 0; --i) {
    const F ln1 = i + 1 < T ? l1s[(size_t)(i + 1) * D] : F(0);
    const F ln2 = i + 2 < T ? l2s[(size_t)(i + 2) * D] : F(0);
    const F ci = c[ob + (size_t)i * D] - ln1 * c1 - ln2 * c2;
    c[ob + (size_t)i * D] = ci;
    const F ei = s[ob + (size_t)i * D] - ci;
    qq = qq + a0s[(size_t)i * D] * ei * ei
         + F(2) * a1s[(size_t)i * D] * ei * e1
         + F(2) * a2s[(size_t)i * D] * ei * e2;
    c2 = c1;
    c1 = ci;
    e2 = e1;
    e1 = ei;
  }
  q[(size_t)b * D + d] = qq;
  logdet[(size_t)b * D + d] = ld;
}

template <typename F>
int launch(const void* mu, const void* prec, const void* s, int B, int T,
           int nw, int D, const void* coef, void* saved, void* c, void* q,
           void* logdet, cudaStream_t st) {
  if (nw > MAXW) return (int)cudaErrorInvalidValue;
  const int n = B * D;
  if (n > 0 && T > 0)
    trajectory_nll_kernel<F><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                               st>>>(
        static_cast<const F*>(mu), static_cast<const F*>(prec),
        static_cast<const F*>(s), B, T, nw, D, static_cast<const F*>(coef),
        static_cast<F*>(saved), static_cast<F*>(c), static_cast<F*>(q),
        static_cast<F*>(logdet));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors, 1 for double (every tensor alike).
extern "C" int trajectory_nll_launch(const void* mu, const void* prec,
                                     const void* s, int B, int T, int nw,
                                     int D, const void* coef, int f64,
                                     void* saved, void* c, void* q,
                                     void* logdet, cudaStream_t st) {
  return f64 ? launch<double>(mu, prec, s, B, T, nw, D, coef, saved, c, q,
                              logdet, st)
             : launch<float>(mu, prec, s, B, T, nw, D, coef, saved, c, q,
                             logdet, st);
}
