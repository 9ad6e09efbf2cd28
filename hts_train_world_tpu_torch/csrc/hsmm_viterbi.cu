// K20: HSMMAlign's segmental Viterbi over a padded batch of utterance
// chains, with the backtrack in the kernel, float64, one block per
// utterance.
//
// Replaces hts_train_world_tpu/models/hsmm.py:183-230 (viterbi_segment):
// there a lax.scan over the chain states builds a (T+1, max_dur) slab of
// candidates per state, takes its max and argmax, and the backtrack runs
// over the stacked argmaxes.  Here the states run in sequence inside the
// block and the threads cover the destinations t in [0, t_len]:
//
//  A. csum[t+1, k] = csum[t, k] + obs[t, k], one thread per state,
//     sequentially in t (the CPU's cumsum order);
//  B. per state s < k_len, destination t takes the max over d = 1..max_dur
//     of cand = (delta_prev[t-d] + dll[d]) + (csum[t] - csum[t-d]), the
//     JAX expression's association, where a term with t - d < 0 is exactly
//     LOG_ZERO (not skipped: an unreachable delta_prev of LOG_ZERO plus
//     negative terms sits below it, and the max must choose as JAX does).
//     Ties go to the smallest d, as argmax does; a NaN wins, and the first
//     NaN, as in jnp.max / jnp.argmax.  The argmax (d - 1) goes to the
//     back-pointers, int16 (B, K, T+1) in device memory;
//  C. one thread walks back from t_len: ends[s] = t, t -= bp[s, t] + 1.
//
// States k >= k_len and frames t > t_len are never read, so a padded
// utterance gives its unpadded result bit for bit; ends past k_len are 0.
// The two delta rows, the state's csum column and its duration log-probs
// live in shared memory, or, past the shared-memory budget (T beyond about
// 8200 frames at max_dur 60), in the per-utterance rows of `rows_g` that
// the wrapper allocates: the same code in the same order either way.
//
// Bound: operations (~4 float64 operations per (state, t, d) term), with
// the chain states sequential inside a block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr double NEG = -1.0e10;      // hsmm.py's LOG_ZERO
constexpr double LOG_2PI = 1.8378770664093453;

// kDeviceRows: the rows in `rows_g` (else in shared memory, where the
// compiler then knows them to be and reads them as such)
template <bool kDeviceRows>
__global__ void __launch_bounds__(THREADS)
hsmm_viterbi_kernel(const double* __restrict__ obs,
                    const double* __restrict__ dmean,
                    const double* __restrict__ dvar,
                    const long long* __restrict__ t_len_p,
                    const long long* __restrict__ k_len_p, int T, int K,
                    int max_dur, double* __restrict__ csum_g,
                    short* __restrict__ bp_g, double* __restrict__ best_ll,
                    long long* __restrict__ ends_g, double* rows_g) {
  extern __shared__ double sm_shared[];
  double* sm = kDeviceRows
      ? rows_g + (size_t)blockIdx.x * (3 * (T + 1) + max_dur) : sm_shared;
  double* ra = sm;                 // T+1
  double* rb = ra + (T + 1);       // T+1
  double* cs = rb + (T + 1);       // T+1
  double* dl = cs + (T + 1);       // max_dur
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int t_len = (int)t_len_p[b], k_len = (int)k_len_p[b];
  const double* ob = obs + (size_t)b * T * K;
  double* csum = csum_g + (size_t)b * (T + 1) * K;
  short* bp = bp_g + (size_t)b * K * (T + 1);
  const double* dm = dmean + (size_t)b * K;
  const double* dv = dvar + (size_t)b * K;

  // A. prefix sums of the log-likelihoods, per state
  for (int k = tid; k < k_len; k += nth) {
    double c = 0.0;
    csum[k] = 0.0;
    for (int t = 0; t < t_len; ++t) {
      c = c + ob[(size_t)t * K + k];
      csum[(size_t)(t + 1) * K + k] = c;
    }
  }
  for (int t = tid; t <= t_len; t += nth) ra[t] = t == 0 ? 0.0 : NEG;
  __syncthreads();

  // B. the states in sequence: ra / rb hold delta before / after
  for (int s = 0; s < k_len; ++s) {
    const double* dp = (s & 1) ? rb : ra;
    double* dn = (s & 1) ? ra : rb;
    for (int t = tid; t <= t_len; t += nth) cs[t] = csum[(size_t)t * K + s];
    const double mean = dm[s], var = dv[s];
    for (int d = tid; d < max_dur; d += nth) {
      const double x = (double)(d + 1) - mean;
      dl[d] = -0.5 * ((x * x) / var + log(var) + LOG_2PI);
    }
    __syncthreads();
    short* bps = bp + (size_t)s * (T + 1);
    for (int t = tid; t <= t_len; t += nth) {
      double best = 0.0;
      int arg = 0;
      for (int d = 1; d <= max_dur; ++d) {
        const int t0 = t - d;
        const double c = t0 >= 0
            ? (dp[t0] + dl[d - 1]) + (cs[t] - cs[t0]) : NEG;
        if (d == 1 || c > best || (c != c && best == best)) {
          best = c;
          arg = d - 1;
        }
      }
      dn[t] = best;
      bps[t] = (short)arg;
    }
    __syncthreads();   // dn complete; cs and dl free for the next state
  }

  // C. backtrack (JAX's indexing: a negative frame wraps once, then clamps)
  if (tid == 0) {
    const double* last = (k_len & 1) ? rb : ra;
    best_ll[b] = last[t_len];
    int te = t_len;
    for (int s = k_len - 1; s >= 0; --s) {
      int i = te < 0 ? te + t_len + 1 : te;
      i = min(max(i, 0), t_len);
      ends_g[(size_t)b * K + s] = te;
      te -= bp[(size_t)s * (T + 1) + i] + 1;
    }
    for (int s = k_len; s < K; ++s) ends_g[(size_t)b * K + s] = 0;
  }
}

}  // namespace

extern "C" int hsmm_viterbi_launch(const double* obs, const double* dmean,
                                   const double* dvar, const long long* t_len,
                                   const long long* k_len, int B, int T, int K,
                                   int max_dur, double* csum, short* bp,
                                   double* best_ll, long long* ends,
                                   double* rows, cudaStream_t st) {
  if (B > 0) {
    // rows: null to keep the rows in shared memory (the wrapper passes
    // device rows when they pass its budget of 200 KiB)
    const size_t smem = rows != nullptr
        ? 0 : (3 * (size_t)(T + 1) + max_dur) * sizeof(double);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hsmm_viterbi_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    if (rows != nullptr)
      hsmm_viterbi_kernel<true><<<B, THREADS, 0, st>>>(
          obs, dmean, dvar, t_len, k_len, T, K, max_dur, csum, bp, best_ll,
          ends, rows);
    else
      hsmm_viterbi_kernel<false><<<B, THREADS, smem, st>>>(
          obs, dmean, dvar, t_len, k_len, T, K, max_dur, csum, bp, best_ll,
          ends, rows);
  }
  return (int)cudaGetLastError();
}
