// K33: mixture-of-diagonal-Gaussians log-likelihoods and component
// posteriors, float64.  Two launchers:
//
// - chain mode (hsmm_mix_loglik_launch) replaces
//   hts_train_world_tpu/models/hsmm_variants.py:87-107 (frame_loglik_mix,
//   called per label by align_utterance_mix): per utterance a (T, S, C, D_s)
//   broadcast of (x - mu)^2 / v per stream and label, which XLA
//   materialises.  Here, as in K17 (hsmm_loglik.cu), one block takes
//   (utterance b, a tile of TT frames) of a padded batch: the tile sits in
//   shared memory and each thread owns one chain state k, walks each
//   component's stream row once and keeps the TT x C sums in registers.
//   Per (b, t, k) and stream s, in stream order:
//     ll_c = -0.5 * ((sum_j (x_j - mu_cj)^2 / v_cj + sum_j log v_cj)
//                    + D_s log 2pi)
//     z_c  = log w_c + ll_c;  m = max_c z_c (NaN if any is), 0 where m is
//     not finite;  ll = log(sum_c exp(z_c - m)) + m
//   (jax.scipy.special.logsumexp's form); an MSD stream scores log w + ll
//   where frames[b, t, a_s] != 0, else log1p(-w), w clipped to [1e-4,
//   1 - 1e-4]; total = total + weight * ll, the weight-0 bap included as K17
//   does (a NaN in its columns makes the total NaN).
// - posterior mode (hsmm_mix_post_launch) replaces :147-154
//   (_responsibilities, called per (model, state, stream) segment): one
//   thread a frame of one stream, its row's components scored with the same
//   ll_c arithmetic, then z - max_c z (no finiteness test, as numpy), exp,
//   divided by the sum over c.
//
// Tables (chain mode): meta (n_streams, 7) int64: column start, stop, msd
// flag, and the offsets in `tabs` of the stream's means (R_s, C, D_s),
// variances (R_s, C, D_s), log-weights (R_s, C) and msd weights (R_s,).
// rows (n_streams, B, Kb) int64.  The component count C is a launch
// argument (1..8); each count is its own instantiation, so the sums stay
// in registers.
//
// Bound: operations (about 3 float64 operations per (b, t, k, component,
// column) in chain mode, per (frame, component, column) in posterior mode,
// against a few bytes per frame and per output).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TT = 8;              // frames per block (chain mode)
constexpr double LOG_2PI = 1.8378770664093453;

// max that propagates NaN, as jnp.max / torch.amax / numpy's max do
__device__ __forceinline__ double nan_max(double m, double z) {
  return (z > m || isnan(z)) ? z : m;
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
mix_loglik_kernel(const double* __restrict__ frames, int B, int Tb, int D,
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
      const long long* m = meta + 7 * s;
      const int a = (int)m[0], Ds = (int)(m[1] - m[0]);
      const bool msd = m[2] != 0;
      const long long r = rows[((size_t)s * B + b) * Kb + k];
      const double c2pi = (double)Ds * LOG_2PI;
      double z[NC][TT];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const double* mu = tabs + m[3] + (r * NC + c) * Ds;
        const double* va = tabs + m[4] + (r * NC + c) * Ds;
        double q[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) q[t] = 0.0;
        double slv = 0.0;
        for (int j = 0; j < Ds; ++j) {
          const double mj = mu[j], vj = va[j];
          slv += log(vj);
          const double* xj = xs + a + j;
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const double d = xj[t * D] - mj;
            q[t] += d * d / vj;
          }
        }
        const double lw = tabs[m[5] + r * NC + c];
#pragma unroll
        for (int t = 0; t < TT; ++t)
          z[c][t] = lw + -0.5 * ((q[t] + slv) + c2pi);
      }
      double lwm = 0.0, l1 = 0.0;
      if (msd) {
        const double w = fmin(fmax(tabs[m[6] + r], 1e-4), 1.0 - 1e-4);
        lwm = log(w);
        l1 = log1p(-w);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        double mx = z[0][t];
#pragma unroll
        for (int c = 1; c < NC; ++c) mx = nan_max(mx, z[c][t]);
        if (!isfinite(mx)) mx = 0.0;
        double sum = 0.0;
#pragma unroll
        for (int c = 0; c < NC; ++c) sum += exp(z[c][t] - mx);
        double ll = log(sum) + mx;
        if (msd) ll = xs[t * D + a] != 0.0 ? lwm + ll : l1;
        total[t] = total[t] + wt * ll;
      }
    }
    for (int t = 0; t < nt; ++t)
      out[((size_t)b * Tb + t0 + t) * Kb + k] = total[t];
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
mix_post_kernel(const double* __restrict__ x, int N, int Ds,
                const long long* __restrict__ rows,
                const double* __restrict__ means,
                const double* __restrict__ vars,
                const double* __restrict__ logw, double* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long r = rows[n];
  const double* xr = x + (size_t)n * Ds;
  const double c2pi = (double)Ds * LOG_2PI;
  double z[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const double* mu = means + (r * NC + c) * Ds;
    const double* va = vars + (r * NC + c) * Ds;
    double q = 0.0, slv = 0.0;
    for (int j = 0; j < Ds; ++j) {
      const double vj = va[j];
      slv += log(vj);
      const double d = xr[j] - mu[j];
      q += d * d / vj;
    }
    z[c] = logw[r * NC + c] + -0.5 * ((q + slv) + c2pi);
  }
  double mx = z[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) mx = nan_max(mx, z[c]);
  double sum = 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    z[c] = exp(z[c] - mx);
    sum += z[c];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) out[(size_t)n * NC + c] = z[c] / sum;
}

template <int NC>
int chain_launch(const double* frames, int B, int Tb, int D, int Kb,
                 int n_streams, const long long* meta, const double* wts,
                 const long long* rows, const double* tabs, double* out,
                 cudaStream_t st) {
  const size_t smem = (size_t)TT * D * sizeof(double);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mix_loglik_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Tb + TT - 1) / TT, B);
  mix_loglik_kernel<NC><<<grid, THREADS, smem, st>>>(
      frames, B, Tb, D, Kb, n_streams, meta, wts, rows, tabs, out);
  return (int)cudaGetLastError();
}

template <int NC>
int post_launch(const double* x, int N, int Ds, const long long* rows,
                const double* means, const double* vars, const double* logw,
                double* out, cudaStream_t st) {
  mix_post_kernel<NC><<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      x, N, Ds, rows, means, vars, logw, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hsmm_mix_loglik_launch(const double* frames, int B, int Tb,
                                      int D, int Kb, int n_streams, int C,
                                      const long long* meta,
                                      const double* wts,
                                      const long long* rows,
                                      const double* tabs, double* out,
                                      cudaStream_t st) {
  if (B <= 0 || Tb <= 0 || Kb <= 0) return (int)cudaGetLastError();
  switch (C) {
#define K33_CHAIN(n)                                                      \
  case n:                                                                 \
    return chain_launch<n>(frames, B, Tb, D, Kb, n_streams, meta, wts,    \
                           rows, tabs, out, st);
    K33_CHAIN(1) K33_CHAIN(2) K33_CHAIN(3) K33_CHAIN(4)
    K33_CHAIN(5) K33_CHAIN(6) K33_CHAIN(7) K33_CHAIN(8)
#undef K33_CHAIN
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int hsmm_mix_post_launch(const double* x, int N, int Ds, int C,
                                    const long long* rows,
                                    const double* means, const double* vars,
                                    const double* logw, double* out,
                                    cudaStream_t st) {
  if (N <= 0) return (int)cudaGetLastError();
  switch (C) {
#define K33_POST(n)                                                       \
  case n:                                                                 \
    return post_launch<n>(x, N, Ds, rows, means, vars, logw, out, st);
    K33_POST(1) K33_POST(2) K33_POST(3) K33_POST(4)
    K33_POST(5) K33_POST(6) K33_POST(7) K33_POST(8)
#undef K33_POST
    default:
      return (int)cudaErrorInvalidValue;
  }
}
