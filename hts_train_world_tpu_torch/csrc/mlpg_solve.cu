// K8: MLPG, one thread per (utterance, dimension).
//
// Replaces hts_train_world_tpu/ops/mlpg.py:29-119 (build_banded_normal +
// banded_ldlt_solve under vmap), which on the TPU built the pentadiagonal
// normal equations with scatter-adds over whole (3, T) band arrays and then
// ran two lax.scans over frames.  Here each thread keeps the precisions and
// means of frames i-1, i, i+1 in registers, forms row i of the bands and of
// the right-hand side on the fly (the same products, summed in the same
// window and tap order as the plain twin), and runs the LDL^T forward
// recursion, storing z, L[i,i-1], L[i,i-2]; the back substitution then walks
// the frames in reverse.  Means, variances and outputs are laid out
// (..., T, n_win, D) / (..., T, D), so the threads of a warp (neighbouring
// dimensions) read and write neighbouring addresses.
//
// The kernel is a template on the scalar type: float for the feature lane,
// double for generation (pgen's mlpg_streams, generate_em, make_mspf),
// where MSD streams put variances x1e8 on unvoiced frames and leaves can sit
// at variance 1e-8, so precisions span ~1e16, beyond a float32 LDL^T.  The
// float instantiation is the same arithmetic as before the template.
//
// Bound: latency.  The recursion is strictly sequential: 2*T dependent steps
// per thread, with B*D independent threads (1200 at the 48 kHz feature
// shapes).  Bytes (means and variances read once, the output written once)
// give the floor that PERF.md states beside it.  Built with --fmad=false.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXW = 4;

template <typename F>
__global__ void __launch_bounds__(THREADS)
mlpg_solve_kernel(const F* __restrict__ mu, const F* __restrict__ var,
                  int B, int T, int nw, int D,
                  const F* __restrict__ coef, F* __restrict__ zs,
                  F* __restrict__ l1s, F* __restrict__ l2s,
                  F* __restrict__ out) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= B * D) return;
  const int b = g / D, d = g % D;
  const F* mub = mu + (size_t)b * T * nw * D + d;
  const F* vb = var + (size_t)b * T * nw * D + d;
  const size_t ob = (size_t)b * T * D + d;
  F c[MAXW][3];
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
#pragma unroll
    for (int k = 0; k < 3; ++k) c[w][k] = w < nw ? coef[w * 3 + k] : F(0);

  // P / U [w][slot]: precision and mean at frame i-1+slot (0 outside [0, T))
  F P[MAXW][3], U[MAXW][3];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    P[w][0] = U[w][0] = F(0);
#pragma unroll
    for (int s = 1; s < 3; ++s) {
      const int t = s - 1;
      const bool ok = w < nw && t < T;
      P[w][s] = ok ? F(1) / vb[((size_t)t * nw + w) * D] : F(0);
      U[w][s] = ok ? mub[((size_t)t * nw + w) * D] : F(0);
    }
  }

  F d1 = F(1), d2 = F(1), y1 = F(0), y2 = F(0), lp = F(0);
  for (int i = 0; i < T; ++i) {
    // row i: A[i,i], A[i-1,i], A[i-2,i] and rhs[i]
    F a[3] = {F(0), F(0), F(0)}, r = F(0);
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
#pragma unroll
      for (int ki = 0; ki < 3; ++ki) {
        const F wk = c[w][ki];
        if (wk == F(0)) continue;
        // rhs: frame t = i - k, slot 2 - ki
        const int t = i - (ki - 1);
        if (t >= 0 && t < T) r = r + P[w][2 - ki] * U[w][2 - ki] * wk;
#pragma unroll
        for (int kj = ki; kj < 3; ++kj) {
          const F wj = c[w][kj];
          if (wj == F(0)) continue;
          const int off = kj - ki;
          const int tt = i - (kj - 1);  // frame of the product, slot 2 - kj
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
    zs[ob + (size_t)i * D] = yi / di;
    l1s[ob + (size_t)i * D] = l1;
    l2s[ob + (size_t)i * D] = l2;
    d2 = d1;
    d1 = di;
    y2 = y1;
    y1 = yi;
    lp = l1;
    // slide the frame window: slot 2 becomes frame i+2
    const int tn = i + 2;
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      P[w][0] = P[w][1];
      U[w][0] = U[w][1];
      P[w][1] = P[w][2];
      U[w][1] = U[w][2];
      const bool ok = w < nw && tn < T;
      P[w][2] = ok ? F(1) / vb[((size_t)tn * nw + w) * D] : F(0);
      U[w][2] = ok ? mub[((size_t)tn * nw + w) * D] : F(0);
    }
  }

  F c1 = F(0), c2 = F(0);
  for (int i = T - 1; i >= 0; --i) {
    const F ln1 = i + 1 < T ? l1s[ob + (size_t)(i + 1) * D] : F(0);
    const F ln2 = i + 2 < T ? l2s[ob + (size_t)(i + 2) * D] : F(0);
    const F ci = zs[ob + (size_t)i * D] - ln1 * c1 - ln2 * c2;
    out[ob + (size_t)i * D] = ci;
    c2 = c1;
    c1 = ci;
  }
}

template <typename F>
int launch(const void* mu, const void* var, int B, int T, int nw, int D,
           const void* coef, void* scratch_, void* out, cudaStream_t s) {
  if (nw > MAXW) return (int)cudaErrorInvalidValue;
  F* scratch = static_cast<F*>(scratch_);
  const int n = B * D;
  if (n > 0 && T > 0) {
    const size_t plane = (size_t)B * T * D;
    mlpg_solve_kernel<F><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const F*>(mu), static_cast<const F*>(var), B, T, nw, D,
        static_cast<const F*>(coef), scratch, scratch + plane,
        scratch + 2 * plane, static_cast<F*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors, 1 for double (means, variances, coefficients,
// scratch and output alike).
extern "C" int mlpg_solve_launch(const void* mu, const void* var, int B,
                                 int T, int nw, int D, const void* coef,
                                 int f64, void* scratch, void* out,
                                 cudaStream_t s) {
  return f64 ? launch<double>(mu, var, B, T, nw, D, coef, scratch, out, s)
             : launch<float>(mu, var, B, T, nw, D, coef, scratch, out, s);
}
