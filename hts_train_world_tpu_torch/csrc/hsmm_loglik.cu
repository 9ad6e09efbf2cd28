// K17: gathered MSD diagonal-Gaussian log-likelihoods of a padded batch of
// utterance chains, float64.
//
// Replaces hts_train_world_tpu/models/hsmm.py:147-171 (_gauss_ll,
// frame_loglik) as hsmm_batch.py:194-201 vmaps it over a bucket: per
// utterance a (T, K, D_s) broadcast of (x - mu)^2 / v per stream, which XLA
// materialises.  Here one block takes (utterance b, a tile of TT frames):
// the frame tile sits in shared memory and each thread owns one chain state
// k, walks its stream rows once (mean, 1/v and log v read once per TT
// frames) and keeps the TT quadratic forms in registers.  Nothing of the
// broadcast reaches device memory.
//
// Per (b, t, k) and every stream s, in stream order:
//   ll = -0.5 * ((sum_j (x_j - mu_j)^2 / v_j + sum_j log v_j) + D_s log 2pi)
// an MSD stream scores log w + ll where frames[b, t, a_s] != 0, else
// log1p(-w), w clipped to [1e-4, 1 - 1e-4]; total = total + weight * ll.
// A stream of weight 0.0 (bap) is scored too, as hsmm.py:170 does: for a
// finite ll the total is unchanged, and a NaN or inf in its columns makes
// the total NaN, as in the JAX package.
//
// meta (n_streams, 6) int64: column start, stop, msd flag, and the offsets
// of the stream's means (R_s, D_s), variances and msd weights (R_s,) in
// `tabs`.  rows (n_streams, B, Kb) int64.
//
// Bound: operations (about 3 float64 operations per (b, t, k, column) of
// all streams, against a few bytes per frame and per output).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TT = 16;             // frames per block
constexpr double LOG_2PI = 1.8378770664093453;

__global__ void __launch_bounds__(THREADS)
hsmm_loglik_kernel(const double* __restrict__ frames, int B, int Tb, int D,
                   int Kb, int n_streams, const long long* __restrict__ meta,
                   const double* __restrict__ wts,
                   const long long* __restrict__ rows,
                   const double* __restrict__ tabs,
                   double* __restrict__ out) {
  extern __shared__ double xs[];   // TT x D
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int nt = min(TT, Tb - t0);
  const double* fb = frames + ((size_t)b * Tb + t0) * D;
  for (int i = threadIdx.x; i < TT * D; i += blockDim.x)
    xs[i] = i < nt * D ? fb[i] : 0.0;
  __syncthreads();

  for (int k = threadIdx.x; k < Kb; k += blockDim.x) {
    double total[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) total[t] = 0.0;
    for (int s = 0; s < n_streams; ++s) {
      const double wt = wts[s];
      const long long* m = meta + 6 * s;
      const int a = (int)m[0], Ds = (int)(m[1] - m[0]);
      const bool msd = m[2] != 0;
      const long long r = rows[((size_t)s * B + b) * Kb + k];
      const double* mu = tabs + m[3] + r * Ds;
      const double* va = tabs + m[4] + r * Ds;
      double q[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) q[t] = 0.0;
      double slv = 0.0;
      for (int j = 0; j < Ds; ++j) {
        const double mj = mu[j], vj = va[j];
        const double iv = 1.0 / vj;
        slv += log(vj);
        const double* xj = xs + a + j;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const double d = xj[t * D] - mj;
          q[t] += d * d * iv;
        }
      }
      double lw = 0.0, l1 = 0.0;
      if (msd) {
        const double w = fmin(fmax(tabs[m[5] + r], 1e-4), 1.0 - 1e-4);
        lw = log(w);
        l1 = log1p(-w);
      }
      const double c = (double)Ds * LOG_2PI;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        double ll = -0.5 * ((q[t] + slv) + c);
        if (msd) ll = xs[t * D + a] != 0.0 ? lw + ll : l1;
        total[t] = total[t] + wt * ll;
      }
    }
    for (int t = 0; t < nt; ++t)
      out[((size_t)b * Tb + t0 + t) * Kb + k] = total[t];
  }
}

}  // namespace

extern "C" int hsmm_loglik_launch(const double* frames, int B, int Tb, int D,
                                  int Kb, int n_streams,
                                  const long long* meta, const double* wts,
                                  const long long* rows, const double* tabs,
                                  double* out, cudaStream_t st) {
  if (B > 0 && Tb > 0 && Kb > 0) {
    const size_t smem = (size_t)TT * D * sizeof(double);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hsmm_loglik_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((Tb + TT - 1) / TT, B);
    hsmm_loglik_kernel<<<grid, THREADS, smem, st>>>(
        frames, B, Tb, D, Kb, n_streams, meta, wts, rows, tabs, out);
  }
  return (int)cudaGetLastError();
}
