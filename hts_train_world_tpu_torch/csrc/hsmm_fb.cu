// K18: the padded segmental forward-backward of an HSMM chain, with frame
// occupancies and duration statistics, float64, one block per utterance.
//
// Replaces hts_train_world_tpu/models/hsmm.py:286-391
// (forward_backward_segment, vmapped over a bucket by hsmm_batch.py:204-208):
// there every chain state builds (T+1, max_dur) slabs and the forward is a
// scatter-max / scatter-add into destinations.  Here the K states run in
// sequence inside the block and the threads cover t in [0, T]:
//
//  A. csum[t+1, k] = csum[t, k] + obs[t, k] * temper, one thread per state,
//     sequentially in t (the CPU's cumsum order);
//  B. forward: destination te pulls its sources t0 = te - d, d = 1..max_dur
//     (valid while te <= t_len): m = max(LOG_ZERO, cand), acc = sum exp(cand
//     - m), F = acc > 0 ? log(max(acc, 1e-300)) + m : LOG_ZERO — the
//     scatter's terms, with no atomics;
//  C. backward from bS (LOG_ZERO but 0 at t_len): a log-sum-exp over all
//     max_dur terms, invalid ones entering as LOG_ZERO as in the JAX slab;
//  D. per state the segment posteriors exp(min(xi, 0)), their start-minus-end
//     differences (written into gamma), mass, E[d] mass and E[d^2] mass;
//  E. gamma = the prefix sum of those differences, one thread per state.
//
// Chain states >= k_len pass both recursions through unchanged and get zero
// occupancy; segments never cross t_len.  The per-state rows of F and B go
// to device scratch (B, K, T+1) for phase D; a state's csum column, its
// duration log-probs and two (T+1)-rows live in shared memory, or, when
// those 3 (T+1) + max_dur doubles pass the shared-memory budget (T past
// about 8200 frames at max_dur 60), in the per-utterance rows of `rows_g`
// that the wrapper allocates.  Both layouts run the same code in the same
// order, so a batch gives the same numbers whichever it takes.
//
// Bound: operations (three exp and ~20 float64 operations per valid
// (state, t0, d) term), with the K states sequential inside a block.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr double NEG = -1.0e10;      // hsmm.py's LOG_ZERO
constexpr double LOG_2PI = 1.8378770664093453;

// Sum of three doubles over the block, returned to every thread.  `red` is
// 3 * 32 doubles of shared memory; blockDim.x is a multiple of 32.
__device__ void block_sum3(double& a, double& b, double& c, double* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  __syncthreads();
  if (lane == 0) {
    red[wid] = a;
    red[32 + wid] = b;
    red[64 + wid] = c;
  }
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? red[lane] : 0.0;
    b = lane < nw ? red[32 + lane] : 0.0;
    c = lane < nw ? red[64 + lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      red[0] = a;
      red[32] = b;
      red[64] = c;
    }
  }
  __syncthreads();
  a = red[0];
  b = red[32];
  c = red[64];
}

// The state's csum column and duration log-probs into shared memory.
__device__ void load_state(const double* __restrict__ csum, int K, int T,
                           int k, double mean, double var, double temper,
                           int max_dur, double* cs, double* dl) {
  for (int t = threadIdx.x; t <= T; t += blockDim.x)
    cs[t] = csum[(size_t)t * K + k];
  for (int d = threadIdx.x; d < max_dur; d += blockDim.x) {
    const double x = (double)(d + 1) - mean;
    dl[d] = -0.5 * ((x * x) / var + log(var) + LOG_2PI) * temper;
  }
}

// kDeviceRows: the rows in `rows_g` (else in shared memory, where the
// compiler then knows them to be and reads them as such)
template <bool kDeviceRows>
__global__ void __launch_bounds__(THREADS)
hsmm_fb_kernel(const double* __restrict__ obs, const double* __restrict__ dmean,
               const double* __restrict__ dvar,
               const long long* __restrict__ t_len_p,
               const long long* __restrict__ k_len_p, int T, int K,
               int max_dur, double temper, double* __restrict__ csum_g,
               double* __restrict__ Fg, double* __restrict__ Bg,
               double* __restrict__ ll_out, double* __restrict__ gamma_g,
               double* __restrict__ dstats_g, double* __restrict__ rows_g) {
  extern __shared__ double sm_shared[];
  double* sm = kDeviceRows
      ? rows_g + (size_t)blockIdx.x * (3 * (T + 1) + max_dur) : sm_shared;
  double* ra = sm;                 // T+1
  double* rb = ra + (T + 1);       // T+1
  double* cs = rb + (T + 1);       // T+1
  double* dl = cs + (T + 1);       // max_dur
  __shared__ double red[96];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int t_len = (int)t_len_p[b], k_len = (int)k_len_p[b];
  const double* ob = obs + (size_t)b * T * K;
  double* csum = csum_g + (size_t)b * (T + 1) * K;
  double* F = Fg + (size_t)b * K * (T + 1);
  double* Bw = Bg + (size_t)b * K * (T + 1);
  double* gam = gamma_g + (size_t)b * T * K;
  double* dst = dstats_g + (size_t)b * K * 3;
  const double* dm = dmean + (size_t)b * K;
  const double* dv = dvar + (size_t)b * K;

  // A. prefix sums of the tempered log-likelihoods, per state
  for (int k = tid; k < K; k += nth) {
    double c = 0.0;
    csum[k] = 0.0;
    for (int t = 0; t < T; ++t) {
      c = c + ob[(size_t)t * K + k] * temper;
      csum[(size_t)(t + 1) * K + k] = c;
    }
  }
  // B. forward, ra = F before the state, rb = after
  for (int t = tid; t <= T; t += nth) ra[t] = t == 0 ? 0.0 : NEG;
  __syncthreads();
  for (int s = 0; s < K; ++s) {
    double* fp = (s & 1) ? rb : ra;
    double* fn = (s & 1) ? ra : rb;
    if (s < k_len) {
      load_state(csum, K, T, s, dm[s], dv[s], temper, max_dur, cs, dl);
      __syncthreads();
      for (int te = tid; te <= T; te += nth) {
        double f = NEG;
        if (te <= t_len) {
          const int dmx = min(max_dur, te);
          double m = NEG;
          for (int d = dmx; d >= 1; --d) {
            const int t0 = te - d;
            m = fmax(m, fp[t0] + (dl[d - 1] + (cs[te] - cs[t0])));
          }
          double acc = 0.0;
          for (int d = dmx; d >= 1; --d) {
            const int t0 = te - d;
            acc += exp(fp[t0] + (dl[d - 1] + (cs[te] - cs[t0])) - m);
          }
          if (acc > 0.0) f = log(fmax(acc, 1e-300)) + m;
        }
        fn[te] = f;
      }
    } else {
      for (int t = tid; t <= T; t += nth) fn[t] = fp[t];
    }
    __syncthreads();
    for (int t = tid; t <= T; t += nth) F[(size_t)s * (T + 1) + t] = fn[t];
    // the next state's load_state writes only cs and dl; fp is rewritten
    // as its fn after the barrier that follows that load
  }
  __syncthreads();

  // C. backward, from bS
  for (int t = tid; t <= T; t += nth) ra[t] = t == t_len ? 0.0 : NEG;
  __syncthreads();
  for (int s = K - 1; s >= 0; --s) {
    const int i = K - 1 - s;
    double* bn = (i & 1) ? rb : ra;     // B after the state
    double* bc = (i & 1) ? ra : rb;
    if (s < k_len) {
      load_state(csum, K, T, s, dm[s], dv[s], temper, max_dur, cs, dl);
      __syncthreads();
      for (int t0 = tid; t0 <= T; t0 += nth) {
        double m = -INFINITY;
        for (int d = 1; d <= max_dur; ++d) {
          const int te = t0 + d;
          m = fmax(m, te <= t_len ? (dl[d - 1] + (cs[te] - cs[t0])) + bn[te]
                                  : NEG);
        }
        double acc = 0.0;
        for (int d = 1; d <= max_dur; ++d) {
          const int te = t0 + d;
          const double c = te <= t_len
              ? (dl[d - 1] + (cs[te] - cs[t0])) + bn[te] : NEG;
          acc += exp(c - m);
        }
        bc[t0] = log(acc) + m;
      }
    } else {
      for (int t = tid; t <= T; t += nth) bc[t] = bn[t];
    }
    __syncthreads();
    for (int t = tid; t <= T; t += nth) Bw[(size_t)s * (T + 1) + t] = bc[t];
  }
  __syncthreads();
  const double logZ = Bw[0];
  if (tid == 0) ll_out[b] = logZ;

  // D. per-state posteriors: start-minus-end differences and dur stats
  for (int s = 0; s < K; ++s) {
    if (s >= k_len) {
      for (int t = tid; t < T; t += nth) gam[(size_t)t * K + s] = 0.0;
      if (tid < 3) dst[s * 3 + tid] = 0.0;
      continue;
    }
    __syncthreads();   // the previous state's readers of ra, rb, cs, dl
    load_state(csum, K, T, s, dm[s], dv[s], temper, max_dur, cs, dl);
    for (int t = tid; t <= T; t += nth) {
      ra[t] = s == 0 ? (t == 0 ? 0.0 : NEG) : F[(size_t)(s - 1) * (T + 1) + t];
      rb[t] = s == K - 1 ? (t == t_len ? 0.0 : NEG)
                         : Bw[(size_t)(s + 1) * (T + 1) + t];
    }
    __syncthreads();
    double mass = 0.0, ed = 0.0, ed2 = 0.0;
    for (int t = tid; t <= T; t += nth) {
      double starts = 0.0, ends = 0.0;
      for (int d = 1; d <= max_dur; ++d) {
        const int te = t + d;
        if (te > t_len) break;
        const double xi =
            ((ra[t] + (dl[d - 1] + (cs[te] - cs[t]))) + rb[te]) - logZ;
        const double p = exp(fmin(xi, 0.0));
        starts += p;
        mass += p;
        ed += p * (double)d;
        ed2 += p * (double)(d * d);
      }
      if (t <= t_len) {
        for (int d = min(max_dur, t); d >= 1; --d) {
          const int t0 = t - d;
          const double xi =
              ((ra[t0] + (dl[d - 1] + (cs[t] - cs[t0]))) + rb[t]) - logZ;
          ends += exp(fmin(xi, 0.0));
        }
      }
      if (t < T) gam[(size_t)t * K + s] = starts - ends;
    }
    block_sum3(mass, ed, ed2, red);
    if (tid == 0) {
      dst[s * 3] = mass;
      dst[s * 3 + 1] = ed;
      dst[s * 3 + 2] = ed2;
    }
  }
  __syncthreads();

  // E. occupancies: prefix sums of the differences, per state
  for (int k = tid; k < K; k += nth) {
    double c = 0.0;
    for (int t = 0; t < T; ++t) {
      c = c + gam[(size_t)t * K + k];
      gam[(size_t)t * K + k] = c;
    }
  }
}

}  // namespace

extern "C" int hsmm_fb_launch(const double* obs, const double* dmean,
                              const double* dvar, const long long* t_len,
                              const long long* k_len, int B, int T, int K,
                              int max_dur, double temper, double* csum,
                              double* F, double* Bw, double* ll,
                              double* gamma, double* dstats, double* rows,
                              cudaStream_t st) {
  if (B > 0) {
    // rows: null to keep the rows in shared memory (the wrapper passes
    // device rows when they pass its budget of 200 KiB)
    const size_t smem = rows != nullptr
        ? 0 : (3 * (size_t)(T + 1) + max_dur) * sizeof(double);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hsmm_fb_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    if (rows != nullptr)
      hsmm_fb_kernel<true><<<B, THREADS, 0, st>>>(
          obs, dmean, dvar, t_len, k_len, T, K, max_dur, temper, csum, F, Bw,
          ll, gamma, dstats, rows);
    else
      hsmm_fb_kernel<false><<<B, THREADS, smem, st>>>(
          obs, dmean, dvar, t_len, k_len, T, K, max_dur, temper, csum, F, Bw,
          ll, gamma, dstats, rows);
  }
  return (int)cudaGetLastError();
}
