// K18: the padded segmental forward-backward of an HSMM chain, with frame
// occupancies and duration statistics, float64.
//
// Replaces hts_train_world_tpu/models/hsmm.py:286-391
// (forward_backward_segment, vmapped over a bucket by hsmm_batch.py:204-208):
// there every chain state builds (T+1, max_dur) slabs and the forward is a
// scatter-max / scatter-add into destinations, the forward and backward
// two independent scans and the posteriors a vmap over the states.  The
// launcher enqueues three kernels in that shape:
//
//  A. prefix sums: csum[b, k, t+1] = csum[b, k, t] + obs[t, k] * temper, a
//     thread per (utterance, state), sequentially in t (the CPU's cumsum
//     order), written through a shared tile;
//  B. the two chains at once, each utterance's forward on one thread-block
//     cluster of C CTAs and its backward on another (grid (C, 2, B)).  The
//     CTAs split t in [0, t_len] into contiguous slices of at least
//     max_dur frames, so the terms of a slice reach past it into one
//     neighbour only: the left one for the forward's F[te - d], the right
//     one for the backward's B[t0 + d].  Per state each CTA reads that
//     halo from the neighbour's rows through distributed shared memory,
//     computes its slice and meets the cluster at one barrier; the rows
//     are double-buffered, so the neighbour's reads of a state's rows end
//     before they are overwritten two states on.  The state's csum row and
//     duration log-probs for the next state are loaded between the
//     barrier's arrive and wait.  C is the largest power of two up to 16
//     (the non-portable size, where the card takes it) that keeps the
//     slices max_dur long and every cluster of the launch resident at
//     once.  Per destination the terms are the ones a single block took:
//     forward te pulls its sources t0 = te - d, d = max_dur..1 (valid
//     while te <= t_len): m = max(LOG_ZERO, cand), acc = sum exp(cand - m)
//     in that order, F = acc > 0 ? log(max(acc, 1e-300)) + m : LOG_ZERO;
//     the backward from bS (LOG_ZERO but 0 at t_len) a log-sum-exp over
//     all max_dur terms, invalid ones entering as LOG_ZERO.  A destination
//     takes four lanes: each the terms of one residue of d mod 4 into a
//     shared row, their max by shuffles (a max is the same in any order
//     but for the sign of a zero, so a zero max is taken again in order),
//     the exps in place, summed by the first lane in the order above.
//     Rows go to device scratch (B, K+1, T+1): F[s] the forward before
//     state s, B[s+1] the backward after it;
//  C. posteriors, a block of 512 threads per (utterance, state): the
//     segment posteriors exp(min(xi, 0)) with the threads striding t as
//     one block did, their start-minus-end differences, mass, E[d] mass
//     and E[d^2] mass summed by the same block tree, then gamma as the
//     prefix sum of the differences, sequentially in t.
//
// Each term keeps its operations and every sum its order, so ll, gamma
// and dstats do not depend on C or on where the rows live.  Chain states
// >= k_len pass both recursions through unchanged and get zero occupancy;
// segments never cross t_len.  Rows live in shared memory up to the
// caller's budget (hsmm.ROWS_SHARED_BYTES), else the same code reads them
// from the device rows of stage B (the chains past that budget only at a
// forced small C; the posteriors past about 6300 frames).
//
// Bound: operations (three exp and ~20 float64 operations per valid
// (state, t0, d) term); the chains are sequential in the states.
#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;         // the posteriors' t stride
constexpr int CHAIN_MAX_THREADS = 512;
constexpr int PORTABLE_CLUSTER = 8, MAX_CLUSTER = 16;
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

// the state's duration log-probs
__device__ void load_dur(double mean, double var, double temper, int max_dur,
                         double* dl) {
  for (int d = threadIdx.x; d < max_dur; d += blockDim.x) {
    const double x = (double)(d + 1) - mean;
    dl[d] = -0.5 * ((x * x) / var + log(var) + LOG_2PI) * temper;
  }
}

// ---- A. prefix sums, (B, K, T+1) ----

// A warp per 32 rows (b, k): each lane sums its row in order, 32 frames a
// step (their loads issued together, a step ahead), into a shared tile
// that the warp then writes row by row, so every store is coalesced.
constexpr int CS_TILE = 32;

__global__ void __launch_bounds__(CS_TILE)
hsmm_csum_kernel(const double* __restrict__ obs, int B, int T, int K,
                 double temper, double* __restrict__ csum) {
  __shared__ double tile[CS_TILE][CS_TILE + 1];
  const int lane = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * CS_TILE, i = i0 + lane;
  const long long rows = (long long)B * K;
  const bool ok = i < rows;
  const int b = ok ? (int)(i / K) : 0, k = ok ? (int)(i % K) : 0;
  const double* ob = obs + (size_t)b * T * K + k;
  // csum[t] for t in [t0, t0 + 32) adds obs[t - 1] for t >= 1
  auto load = [&](int t0, double* v) {
#pragma unroll
    for (int j = 0; j < CS_TILE; ++j) {
      const int t = t0 + j;
      v[j] = ok && t >= 1 && t <= T ? ob[(size_t)(t - 1) * K] : 0.0;
    }
  };
  double c = 0.0, v[CS_TILE], nx[CS_TILE];
  load(0, v);
  for (int t0 = 0; t0 <= T; t0 += CS_TILE) {
    if (t0 + CS_TILE <= T) load(t0 + CS_TILE, nx);
#pragma unroll
    for (int j = 0; j < CS_TILE; ++j) {
      if (t0 + j >= 1) c = c + v[j] * temper;
      tile[lane][j] = c;
    }
    __syncwarp();
    for (int r = 0; r < CS_TILE && i0 + r < rows; ++r)
      if (t0 + lane <= T)
        csum[(size_t)(i0 + r) * (T + 1) + t0 + lane] = tile[r][lane];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CS_TILE; ++j) v[j] = nx[j];
  }
}

// ---- B. the chains ----

// Slice r of C over n = t_len + 1 frames: at most n / max_dur CTAs hold
// frames (one for a row shorter than 2 max_dur), each ceil(n / Ca) of
// them (>= max_dur), the last the rest; the others hold none.
struct Slice {
  int lo, hi, len;
};
__device__ __forceinline__ Slice slice_of(int r, int C, int n, int max_dur) {
  const int ca = max(1, min(C, n / max_dur));
  const int sl = (n + ca - 1) / ca;
  const int lo = min(n, r * sl), hi = min(n, lo + sl);
  return {lo, hi, sl};
}

// lanes a destination in the chains
constexpr int TPD = 4;

// the max over a destination's group of TPD lanes
__device__ __forceinline__ double group_max(double m) {
#pragma unroll
  for (int o = 1; o < TPD; o <<= 1)
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// kDev: the rows in the device rows of F / B (else in shared memory: two
// row buffers of W = slice + max_dur frames, two csum buffers); dl twice
// and a row of max_dur exps a destination of a round in shared memory
// either way
template <bool kDev>
__global__ void __launch_bounds__(CHAIN_MAX_THREADS, 2)
hsmm_chain_kernel(const double* __restrict__ csum_g,
                  const double* __restrict__ dmean,
                  const double* __restrict__ dvar,
                  const long long* __restrict__ t_len_p,
                  const long long* __restrict__ k_len_p, int T, int K,
                  int max_dur, double temper, int W,
                  double* __restrict__ Fg, double* __restrict__ Bg) {
  extern __shared__ double sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int b = blockIdx.z, tid = threadIdx.x, nth = blockDim.x;
  const bool fwd = blockIdx.y == 0;
  const int t_len = (int)t_len_p[b], k_len = (int)k_len_p[b];
  const int Dm = max_dur, n = t_len + 1;
  const Slice me = slice_of(r, C, n, Dm);
  const size_t rows = (size_t)(K + 1) * (T + 1);
  double* R = (fwd ? Fg : Bg) + (size_t)b * rows;       // (K+1, T+1)
  const double* csb = csum_g + (size_t)b * K * (T + 1);
  const double* dm = dmean + (size_t)b * K;
  const double* dv = dvar + (size_t)b * K;
  // the frames of this CTA's buffers: forward [lo - Dm, hi), backward
  // [lo, hi + Dm), clipped to [0, n)
  const int b_lo = fwd ? max(0, me.lo - Dm) : me.lo;
  const int b_hi = fwd ? me.hi : min(n, me.hi + Dm);
  // buffer index of frame t: t - base
  const int base = kDev ? 0 : (fwd ? me.lo - Dm : me.lo);
  double* buf[2] = {sm, sm + W};
  double* csbuf[2] = {sm + 2 * W, sm + 3 * W};
  double* dlbuf[2] = {sm + 4 * W, sm + 4 * W + Dm};
  if (kDev) {
    dlbuf[0] = sm;
    dlbuf[1] = sm + Dm;
  }
  double* ex = dlbuf[1] + Dm;                 // (nth / TPD, Dm): the exps
  const int lane = tid % TPD, g = tid / TPD, ng = nth / TPD;
  // the state order, its first row (the chain's start) and the device row
  // each state writes; states >= k_len pass the rows through
  auto state = [&](int i) { return fwd ? i : k_len - 1 - i; };
  auto row_out = [&](int i) {
    return R + (size_t)(fwd ? i + 1 : k_len - 1 - i) * (T + 1);
  };
  double* start = R + (size_t)(fwd ? 0 : k_len) * (T + 1);
  auto load_state = [&](int i, int p) {
    const int s = state(i);
    if (!kDev) {
      const double* src = csb + (size_t)s * (T + 1);
      for (int t = b_lo + tid; t < b_hi; t += nth)
        csbuf[p][t - base] = src[t];
    }
    load_dur(dm[s], dv[s], temper, Dm, dlbuf[p]);
  };
  // the start row: F before state 0, or bS
  for (int t = me.lo + tid; t < me.hi; t += nth) {
    const double v = fwd ? (t == 0 ? 0.0 : NEG) : (t == t_len ? 0.0 : NEG);
    start[t] = v;
    if (!kDev) buf[0][t - base] = v;
  }
  if (k_len > 0) load_state(0, 0);
  if (kDev) __threadfence();
  cluster_arrive();
  cluster_wait();
  for (int i = 0; i < k_len; ++i) {
    const int p = i & 1;
    const double* rp = kDev ? (i == 0 ? start : row_out(i - 1)) - base
                            : buf[p] - base;
    double* rn = kDev ? row_out(i) : buf[p ^ 1] - base;
    const double* cs = kDev ? csb + (size_t)state(i) * (T + 1)
                            : csbuf[p] - base;
    const double* dl = dlbuf[p];
    if (!kDev && me.lo < me.hi) {
      // the halo from the neighbour's rows of this state
      double* mine = buf[p] - base;
      if (fwd && r > 0) {
        const double* nb = cluster.map_shared_rank(buf[p], r - 1)
                           - (me.lo - me.len - Dm);
        for (int t = b_lo + tid; t < me.lo; t += nth) mine[t] = nb[t];
      } else if (!fwd && me.hi < n) {
        const double* nb = cluster.map_shared_rank(buf[p], r + 1) - me.hi;
        for (int t = me.hi + tid; t < b_hi; t += nth) mine[t] = nb[t];
      }
    }
    __syncthreads();
    // a destination a group of TPD lanes (the header's stage B)
    for (int u0 = me.lo; u0 < me.hi; u0 += ng) {
      const int u = u0 + g;
      const bool on = u < me.hi;
      double* er = ex + (size_t)g * Dm;
      if (fwd) {
        const int te = u, dmx = on ? min(Dm, te) : 0;
        auto cand = [&](int d) {
          const int t0 = te - d;
          return rp[t0] + (dl[d - 1] + (cs[te] - cs[t0]));
        };
        double m = NEG;
        for (int d = dmx - lane; d >= 1; d -= TPD) {
          er[d - 1] = cand(d);
          m = fmax(m, er[d - 1]);
        }
        m = group_max(m);
        if (m == 0.0) {
          m = NEG;
          for (int d = dmx; d >= 1; --d) m = fmax(m, cand(d));
        }
        for (int d = dmx - lane; d >= 1; d -= TPD)
          er[d - 1] = exp(er[d - 1] - m);
        __syncwarp();
        if (on && lane == 0) {
          double acc = 0.0;
          for (int d = dmx; d >= 1; --d) acc += er[d - 1];
          const double f = acc > 0.0 ? log(fmax(acc, 1e-300)) + m : NEG;
          rn[te] = f;
          if (!kDev) row_out(i)[te] = f;
        }
      } else {
        const int t0 = u, dmx = on ? Dm : 0;
        auto cand = [&](int d) {
          const int te = t0 + d;
          return te <= t_len ? (dl[d - 1] + (cs[te] - cs[t0])) + rp[te]
                             : NEG;
        };
        double m = -INFINITY;
        for (int d = 1 + lane; d <= dmx; d += TPD) {
          er[d - 1] = cand(d);
          m = fmax(m, er[d - 1]);
        }
        m = group_max(m);
        if (m == 0.0) {
          m = -INFINITY;
          for (int d = 1; d <= dmx; ++d) m = fmax(m, cand(d));
        }
        for (int d = 1 + lane; d <= dmx; d += TPD)
          er[d - 1] = exp(er[d - 1] - m);
        __syncwarp();
        if (on && lane == 0) {
          double acc = 0.0;
          for (int d = 1; d <= Dm; ++d) acc += er[d - 1];
          const double v = log(acc) + m;
          rn[t0] = v;
          if (!kDev) row_out(i)[t0] = v;
        }
      }
      __syncwarp();
    }
    // this state's rows are complete in the cluster at the barrier; the
    // next state's csum and dl go into the other buffers meanwhile (their
    // readers finished at the barrier before this state's halo)
    if (kDev) __threadfence();
    cluster_arrive();
    if (i + 1 < k_len) load_state(i + 1, p ^ 1);
    cluster_wait();
  }
}

// ---- C. posteriors and occupancies ----

// kDev: ra, rb and cs read from the device rows, the differences kept in
// gamma (else ra, rb, cs, the differences and dl in shared memory)
template <bool kDev>
__global__ void __launch_bounds__(THREADS)
hsmm_post_kernel(const double* __restrict__ csum_g,
                 const double* __restrict__ dmean,
                 const double* __restrict__ dvar,
                 const long long* __restrict__ t_len_p,
                 const long long* __restrict__ k_len_p, int T, int K,
                 int max_dur, double temper, const double* __restrict__ Fg,
                 const double* __restrict__ Bg, double* __restrict__ ll_out,
                 double* __restrict__ gamma_g, double* __restrict__ dstats_g) {
  extern __shared__ double sm[];
  __shared__ double red[96];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nth = blockDim.x;
  const int t_len = (int)t_len_p[b], k_len = (int)k_len_p[b];
  double* gam = gamma_g + (size_t)b * T * K + s;
  double* dst = dstats_g + ((size_t)b * K + s) * 3;
  if (s >= k_len) {
    for (int t = tid; t < T; t += nth) gam[(size_t)t * K] = 0.0;
    if (tid < 3) dst[tid] = 0.0;
    return;
  }
  const size_t rows = (size_t)(K + 1) * (T + 1);
  const double* Fr = Fg + (size_t)b * rows + (size_t)s * (T + 1);
  const double* Br = Bg + (size_t)b * rows + (size_t)(s + 1) * (T + 1);
  const double* csr = csum_g + ((size_t)b * K + s) * (T + 1);
  const double logZ = Bg[(size_t)b * rows];
  if (s == 0 && tid == 0) ll_out[b] = logZ;
  const double* ra = Fr;
  const double* rb = Br;
  const double* cs = csr;
  double* diff = nullptr;
  double* dl = sm;
  if (!kDev) {
    double* sra = sm + max_dur;
    double* srb = sra + (T + 1);
    double* scs = srb + (T + 1);
    diff = scs + (T + 1);
    for (int t = tid; t <= t_len; t += nth) {
      sra[t] = Fr[t];
      srb[t] = Br[t];
      scs[t] = csr[t];
    }
    ra = sra;
    rb = srb;
    cs = scs;
  }
  load_dur(dmean[(size_t)b * K + s], dvar[(size_t)b * K + s], temper,
           max_dur, dl);
  __syncthreads();
  double mass = 0.0, ed = 0.0, ed2 = 0.0;
  for (int t = tid; t <= T; t += nth) {
    double starts = 0.0, ends = 0.0;
#pragma unroll 4
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
#pragma unroll 4
      for (int d = min(max_dur, t); d >= 1; --d) {
        const int t0 = t - d;
        const double xi =
            ((ra[t0] + (dl[d - 1] + (cs[t] - cs[t0]))) + rb[t]) - logZ;
        ends += exp(fmin(xi, 0.0));
      }
    }
    if (t < T) {
      if (kDev) gam[(size_t)t * K] = starts - ends;
      else diff[t] = starts - ends;
    }
  }
  block_sum3(mass, ed, ed2, red);
  if (tid == 0) {
    dst[0] = mass;
    dst[1] = ed;
    dst[2] = ed2;
    // occupancies: the prefix sum of the differences
    double c = 0.0;
    for (int t = 0; t < T; ++t) {
      c = c + (kDev ? gam[(size_t)t * K] : diff[t]);
      gam[(size_t)t * K] = c;
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// row buffer words a CTA needs for C CTAs over T+1 frames: the longest
// slice (a row shorter than C max_dur frames takes fewer, longer slices,
// below 2 max_dur) and its halo
int row_words(int T, int C, int max_dur) {
  return std::max((T + 1 + C - 1) / C, 2 * max_dur) + max_dur;
}

// a chain CTA's shape at C CTAs an utterance: its row buffers (W
// frames), TPD lanes for each of up to 128 destinations a round, the
// shared memory of the rows (or, past the budget, of dl alone) and of the
// exps
struct ChainShape {
  int W, threads;
  size_t smem;
  bool dev;
};
ChainShape chain_shape(int T, int C, int max_dur, int budget) {
  const int W = row_words(T, C, max_dur);
  const int te = std::min(CHAIN_MAX_THREADS / TPD,
                          (W - max_dur + 7) / 8 * 8);
  const size_t ex = (size_t)te * max_dur;
  size_t words = 4 * (size_t)W + 2 * (size_t)max_dur + ex;
  const bool dev = words * sizeof(double) > (size_t)budget;
  if (dev) words = 2 * (size_t)max_dur + ex;
  return {W, TPD * te, words * sizeof(double), dev};
}

cudaLaunchConfig_t chain_config(const ChainShape& sh, int C, int B,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 2, B);
  cfg.blockDim = dim3(sh.threads, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kDev>
cudaError_t chain_attributes(const ChainShape& sh, int C) {
  auto kern = hsmm_chain_kernel<kDev>;
  cudaError_t e = allow_smem(kern, sh.smem);
  if (e == cudaSuccess && C > PORTABLE_CLUSTER)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// how many clusters of C CTAs of this shape the card holds at once (0 if
// it takes none: a cluster of 16 where the card refuses the non-portable
// size), asked once a (device, C, shape)
int resident_clusters(const ChainShape& sh, int C) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, size_t, bool>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const auto key = std::make_tuple(dev, C, sh.threads, sh.smem, sh.dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = chain_config(sh, C, 1, attr);
  const cudaError_t e = sh.dev ? chain_attributes<true>(sh, C)
                               : chain_attributes<false>(sh, C);
  if (e != cudaSuccess
      || cudaOccupancyMaxActiveClusters(
             &n, sh.dev ? hsmm_chain_kernel<true> : hsmm_chain_kernel<false>,
             &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  cache[key] = n;
  return n;
}

// the chains' cluster size: the largest power of two up to 16 that keeps
// every slice at least max_dur long and all 2B clusters resident at once
// (a cluster holds its SMs for the whole chain, so a second wave would
// double the launch), else 1
int choose_cluster(int B, int T, int max_dur, int budget) {
  const int want = std::max(1, (T + 1) / max_dur);
  for (int C = MAX_CLUSTER; C > 1; C >>= 1)
    if (C <= want
        && resident_clusters(chain_shape(T, C, max_dur, budget), C) >= 2 * B)
      return C;
  return 1;
}

int launch_chains(const ChainShape& sh, const double* csum,
                  const double* dmean, const double* dvar,
                  const long long* t_len, const long long* k_len, int B,
                  int T, int K, int max_dur, double temper, int C, double* F,
                  double* Bw, cudaStream_t st) {
  cudaError_t e = sh.dev ? chain_attributes<true>(sh, C)
                         : chain_attributes<false>(sh, C);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = chain_config(sh, C, B, attr);
  cfg.stream = st;
  e = sh.dev ? cudaLaunchKernelEx(&cfg, hsmm_chain_kernel<true>, csum, dmean,
                                  dvar, t_len, k_len, T, K, max_dur, temper,
                                  sh.W, F, Bw)
             : cudaLaunchKernelEx(&cfg, hsmm_chain_kernel<false>, csum, dmean,
                                  dvar, t_len, k_len, T, K, max_dur, temper,
                                  sh.W, F, Bw);
  return (int)e;
}

}  // namespace

// obs (B, T, K), dmean/dvar (B, K), t_len/k_len (B,) int64; scratch csum
// (B, K, T+1), F and Bw (B, K+1, T+1); out ll (B,), gamma (B, T, K),
// dstats (B, K, 3).  budget: the shared-memory bytes a CTA's rows may
// take; cluster: the chains' CTAs an utterance (0: the largest the rows
// allow, up to 16 where the card takes it, else 8).
extern "C" int hsmm_fb_launch(const double* obs, const double* dmean,
                              const double* dvar, const long long* t_len,
                              const long long* k_len, int B, int T, int K,
                              int max_dur, double temper, double* csum,
                              double* F, double* Bw, double* ll,
                              double* gamma, double* dstats, int budget,
                              int cluster, cudaStream_t st) {
  if (cluster < 0 || cluster > MAX_CLUSTER || max_dur < 1 || T < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const size_t bk = (size_t)B * K;
  hsmm_csum_kernel<<<(unsigned)((bk + CS_TILE - 1) / CS_TILE), CS_TILE, 0,
                     st>>>(obs, B, T, K, temper, csum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int C =
      cluster > 0 ? cluster : choose_cluster(B, T, max_dur, budget);
  const int rc = launch_chains(chain_shape(T, C, max_dur, budget), csum,
                               dmean, dvar, t_len, k_len, B, T, K, max_dur,
                               temper, C, F, Bw, st);
  if (rc != 0) return rc;
  const size_t post_smem =
      (4 * (size_t)(T + 1) + (size_t)max_dur) * sizeof(double);
  const dim3 grid(K, B);
  if (post_smem > (size_t)budget) {
    const size_t sm = (size_t)max_dur * sizeof(double);
    e = allow_smem(hsmm_post_kernel<true>, sm);
    if (e != cudaSuccess) return (int)e;
    hsmm_post_kernel<true><<<grid, THREADS, sm, st>>>(
        csum, dmean, dvar, t_len, k_len, T, K, max_dur, temper, F, Bw, ll,
        gamma, dstats);
  } else {
    e = allow_smem(hsmm_post_kernel<false>, post_smem);
    if (e != cudaSuccess) return (int)e;
    hsmm_post_kernel<false><<<grid, THREADS, post_smem, st>>>(
        csum, dmean, dvar, t_len, k_len, T, K, max_dur, temper, F, Bw, ll,
        gamma, dstats);
  }
  return (int)cudaGetLastError();
}
