// K16: Harvest's contour stack, one block per utterance.
//
// Replaces hts_train_world_tpu/ops/harvest_fix.py:121-445
// (remove_unreliable, fix_contour with its Extend / ExtendSub /
// MakeSortedOrder / MergeF0 machinery, smooth_contour); harvest.cpp:652-1113
// in WORLD, whose serial logic the JAX package transcribes in
// ops/harvest.py:606-842.  On the TPU these were masked scans and
// while_loops over a statically capped section axis.  Here:
// - threads over (frame, candidate) pairs: RemoveUnreliableCandidates, on
//   tiles of frames whose candidate rows (and their neighbours) are staged
//   in shared memory;
// - threads over frames: SearchF0Base, FixStep1 and the copies;
// - one warp builds each boundary list ([start, end-1] pairs of the runs of
//   f0 > 0, first and last frame forced unvoiced) from ballots of 32 frames;
// - threads over runs: FixStep2's short runs, FixStep4's short gaps;
// - threads over sections: Extend (each section writes only its own
//   channel, device scratch of cap x T) and ExtendSub's section sums;
// - one thread: ExtendSub's running (never reset) mean, the insertion sort
//   that compares the current order[i]; the block walks MergeF0 from slot 0
//   (not order[0]) with block-wide float64 score sums and range copies;
// - threads over sections: the smoothing, each section's held-edge channel
//   over the whole T + 600 frames through the Butterworth twice,
//   sequentially in float64, the first pass kept in device scratch.
//
// SelectBestF0 divides once per step: the least |ref - c| gives the least
// rounded quotient (rounding is monotone), and only candidates whose
// numerator lies within 2^-20 of it can round to the same quotient, so
// only those are divided again to find the last minimum, as the twin does.
//
// Bound: latency of the serial steps (ExtendSub, the sort and MergeF0's
// walk, and 2 x (T + 600) dependent float64 steps per section); bytes and
// operations are small.  Built with --fmad=false.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8;  // frames a RemoveUnreliable tile holds
constexpr unsigned FULL = 0xffffffffu;
constexpr int LAG = 300;
constexpr float RANGE3 = 0.18f;
constexpr double BB0 = 0.0078202080334971724, BB1 = 0.015640416066994345;
constexpr double BA0 = 1.7347257688092754, BA1 = -0.76600660094326412;

__device__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const double s = red[0];
  __syncthreads();
  return s;
}

// GetBoundaryList (harvest.cpp:727-743): the runs of f > 0 over [0, n),
// with the first and last frame forced unvoiced when `forced`, as
// inclusive (start, end) pairs; at most `cap` kept.  Run by one whole warp:
// each step ballots 32 frames and walks their rises and falls in order.
__device__ int build_sections(const float* f, int n, bool forced, int* st,
                              int* ed, int cap) {
  const int lane = threadIdx.x & 31;
  int k = 0;
  unsigned prev = 0u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool v = i < n && f[i] > 0.f && !(forced && (i == 0 || i == n - 1));
    const unsigned bal = __ballot_sync(FULL, v);
    const unsigned before = (bal << 1) | prev;  // bit b: frame base+b-1
    unsigned rise = bal & ~before, ev = rise | (~bal & before);
    while (ev) {
      const int b = __ffs(ev) - 1;
      ev &= ev - 1;
      if ((rise >> b) & 1u) {
        if (lane == 0 && k < cap) st[k] = base + b;
      } else {
        if (lane == 0 && k < cap) ed[k] = base + b - 1;
        ++k;
      }
    }
    prev = bal >> 31;
  }
  if (prev) {
    if (lane == 0 && k < cap) ed[k] = n - 1;
    ++k;
  }
  return min(k, cap);
}

// SelectBestF0 (harvest.cpp:636-650): <= accepts, the last minimum of
// the rounded |ref - c| / ref wins (ref > 0)
__device__ __forceinline__ float select_best(float ref, const float* row,
                                             int NC) {
  float m = FLT_MAX;
  for (int k = 0; k < NC; ++k) m = fminf(m, fabsf(ref - row[k]));
  const float e = __fdiv_rn(m, ref);
  if (!(e <= RANGE3)) return 0.f;
  const float lim = m * (1.0f + 1.0f / 1048576.0f);
  for (int k = NC - 1; k >= 0; --k) {
    const float x = fabsf(ref - row[k]);
    if (x <= lim && __fdiv_rn(x, ref) == e) return row[k];
  }
  return 0.f;
}

// ExtendF0 (harvest.cpp:791-820) on one section's channel
__device__ int extend(float* ch, int origin, int last, int sign,
                      const float* c2, int NC, int T) {
  float tmp = fmaxf(ch[origin], 1e-30f);
  int shifted = origin, count = 0;
  const int span = abs(last - origin);
  for (int i = 0; i <= span; ++i) {
    const int idx = origin + sign * (i + 1);
    const int ic = min(max(idx, 0), T - 1);
    const float best = select_best(tmp, c2 + (size_t)ic * NC, NC);
    ch[ic] = best;
    if (best == 0.f) {
      ++count;
    } else {
      tmp = best;
      count = 0;
      shifted = idx;
    }
    if (count == 4) break;
  }
  return shifted;
}

// SearchScore (harvest.cpp:901-907)
__device__ __forceinline__ float match_score(float f, const float* c,
                                             const float* s, int NC) {
  float best = 0.f;
  for (int k = 0; k < NC; ++k)
    if (c[k] == f && best < s[k]) best = s[k];
  return best;
}

__global__ void __launch_bounds__(THREADS)
harvest_contour_kernel(const float* __restrict__ rc,
                       const float* __restrict__ sc, int T, int NC, int cap3,
                       int cap_s, int rows_s, int runs, float* fields,
                       float* conts, float* multi, double* smooth, int* ints,
                       double* sums, float* __restrict__ out) {
  extern __shared__ float tile[];  // (TILE + 2) candidate rows
  __shared__ int sh_n, sh_keep;
  __shared__ double red[32];
  const int u = blockIdx.x, tid = threadIdx.x;
  const size_t F = (size_t)T * NC;
  const float* ci = rc + u * F;
  const float* si = sc + u * F;
  float* c2 = fields + u * 2 * F;
  float* s2 = c2 + F;
  float* base = conts + (size_t)u * 4 * T;  // later FixStep3's output
  float* s1 = base + T;
  float* sx = s1 + T;                       // FixStep2's output
  float* s4 = sx + T;
  float* mul = multi + (size_t)u * cap3 * T;
  const int Lx = T + 2 * LAG;
  double* smb = smooth + (size_t)u * rows_s * Lx;
  int* st = ints + (size_t)u * 6 * runs;
  int* ed = st + runs;
  int* st2 = ed + runs;
  int* ed2 = st2 + runs;
  int* kept = ed2 + runs;
  int* order = kept + runs;
  double* ssum = sums + (size_t)u * cap3;
  float* o = out + (size_t)u * T;

  // ---- RemoveUnreliableCandidates (harvest.cpp:652-688) ----
  // candidates are >= 0, so min |c - n| / c is the least relative error;
  // frames i0-1 .. i0+TILE of the input go to shared memory per tile
  for (int i0 = 0; i0 < T; i0 += TILE) {
    for (int q = tid; q < (TILE + 2) * NC; q += THREADS) {
      const int i = i0 - 1 + q / NC;
      tile[q] = (i >= 0 && i < T) ? ci[(size_t)i * NC + q % NC] : 0.f;
    }
    __syncthreads();
    for (int q = tid; q < TILE * NC; q += THREADS) {
      const int f = q / NC, i = i0 + f;
      if (i >= T) break;
      const float c = tile[q + NC];
      bool kill = false;
      if (c != 0.f && i >= 1 && i <= T - 2) {
        const float* pv = tile + f * NC;
        const float* nx = tile + (f + 2) * NC;
        float m1 = FLT_MAX, m2 = FLT_MAX;
        for (int k = 0; k < NC; ++k) {
          m1 = fminf(m1, fabsf(c - nx[k]));
          m2 = fminf(m2, fabsf(c - pv[k]));
        }
        const float e = fminf(fminf(__fdiv_rn(m1, c), 1.f),
                              fminf(__fdiv_rn(m2, c), 1.f));
        kill = e > 0.05f;
      }
      const size_t p = (size_t)i * NC + q % NC;
      c2[p] = kill ? 0.f : c;
      s2[p] = kill ? 0.f : si[p];
    }
    __syncthreads();
  }

  // ---- SearchF0Base (:693-705): the first best score ----
  for (int i = tid; i < T; i += THREADS) {
    const float* sr = s2 + (size_t)i * NC;
    int j = 0;
    float best = sr[0];
    for (int k = 1; k < NC; ++k)
      if (sr[k] > best) {
        best = sr[k];
        j = k;
      }
    base[i] = best > 0.f ? c2[(size_t)i * NC + j] : 0.f;
  }
  __syncthreads();

  // ---- FixStep1 (:710-722); a zero divisor means the condition holds ----
  for (int i = tid; i < T; i += THREADS) {
    const float b0 = base[i];
    const float b1 = i >= 1 ? base[i - 1] : 0.f;
    const float b2 = i >= 2 ? base[i - 2] : 0.f;
    const float ref = b1 * 2.0f - b2;
    const bool c1 = ref == 0.f || fabsf(__fdiv_rn(b0 - ref, ref)) > 0.008f;
    const bool cc2 = b1 == 0.f || __fdiv_rn(fabsf(b0 - b1), b1) > 0.008f;
    s1[i] = (i >= 2 && b0 != 0.f && !(c1 && cc2)) ? b0 : 0.f;
  }
  __syncthreads();

  // ---- FixStep2 (:748-762): zero runs with end - start < 6 ----
  if (tid < 32) {
    const int n = build_sections(s1, T, true, st, ed, runs);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < T; i += THREADS) sx[i] = s1[i];
  __syncthreads();
  for (int k = tid; k < sh_n; k += THREADS)
    if (ed[k] - st[k] < 6)
      for (int i = st[k]; i <= ed[k]; ++i) sx[i] = 0.f;
  __syncthreads();

  // ---- FixStep3 (:968-995) ----
  float* s3 = base;
  if (tid < 32) {
    const int n = build_sections(sx, T, true, st, ed, cap3);
    if (tid == 0) sh_n = n;
  }
  __syncthreads();
  const int n_sec = sh_n;
  for (size_t p = tid; p < (size_t)n_sec * T; p += THREADS) {
    const int k = (int)(p / T), i = (int)(p % T);
    mul[p] = (i >= st[k] && i <= ed[k]) ? sx[i] : 0.f;
  }
  __syncthreads();
  // Extend (:861-878), then the section sums over [start, end) of ExtendSub
  for (int k = tid; k < n_sec; k += THREADS) {
    float* ch = mul + (size_t)k * T;
    const int e = extend(ch, ed[k], min(T - 2, ed[k] + 100), 1, c2, NC, T);
    const int s = extend(ch, st[k], max(1, st[k] - 100), -1, c2, NC, T);
    st2[k] = s;
    ed2[k] = e;
    double acc = 0.0;
    for (int i = s; i < e; ++i) acc += (double)ch[i];
    ssum[k] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    // ExtendSub (:840-856): the running mean is never reset
    double mean = 0.0;
    int nk = 0;
    for (int k = 0; k < n_sec; ++k) {
      const int len = ed2[k] - st2[k];
      mean = (mean + ssum[k]) / (double)max(len, 1);
      if (2200.0 / mean < (double)len) kept[nk++] = k;
    }
    // MakeSortedOrder (:883-896): the comparison reads the current order[i]
    for (int i = 0; i < nk; ++i) order[i] = i;
    for (int i = 1; i < nk; ++i)
      for (int j = i - 1; j >= 0; --j) {
        if (st2[kept[order[j]]] > st2[kept[order[i]]]) {
          const int tmp = order[i];
          order[i] = order[j];
          order[j] = tmp;
        } else {
          break;
        }
      }
    sh_keep = nk;
  }
  __syncthreads();
  const int nk = sh_keep;
  if (nk == 0) {
    for (int i = tid; i < T; i += THREADS) s3[i] = sx[i];
  } else {
    // MergeF0 (:937-963): the base is slot 0, the walk visits order[1..]
    const int k0 = kept[0];
    for (int i = tid; i < T; i += THREADS) s3[i] = mul[(size_t)k0 * T + i];
    int bl0 = st2[k0], bl1 = ed2[k0];
    __syncthreads();
    for (int m = 1; m < nk; ++m) {
      const int oo = kept[order[m]];
      const int sa = st2[oo], eb = ed2[oo];
      const float* ch = mul + (size_t)oo * T;
      int lo = -1;
      if (sa - bl1 > 0) {  // disjoint: append
        lo = sa;
        bl0 = sa;
      } else if (!(bl0 <= sa && bl1 >= eb)) {  // overlap: by score
        double a = 0.0, b = 0.0;
        for (int i = sa + tid; i <= bl1; i += THREADS) {
          const float* cr = c2 + (size_t)i * NC;
          const float* sr = s2 + (size_t)i * NC;
          a += (double)match_score(s3[i], cr, sr, NC);
          b += (double)match_score(ch[i], cr, sr, NC);
        }
        a = block_sum_d(a, red);
        b = block_sum_d(b, red);
        lo = a > b ? bl1 : sa;
      }
      if (lo >= 0) {
        for (int i = lo + tid; i <= eb; i += THREADS) s3[i] = ch[i];
        bl1 = eb;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- FixStep4 (:1000-1022): fill gaps shorter than 9 frames ----
  if (tid < 32) {
    const int n = build_sections(s3, T, true, st, ed, runs);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < T; i += THREADS) s4[i] = s3[i];
  __syncthreads();
  for (int g = tid; g + 1 < sh_n; g += THREADS) {
    const int pe = ed[g], ns = st[g + 1], dist = ns - pe - 1;
    if (dist >= 9) continue;
    const float tmp0 = s3[pe] + 1.0f, tmp1 = s3[ns] - 1.0f;
    const float coef = __fdiv_rn(tmp1 - tmp0, (float)(dist + 1));
    for (int i = pe + 1; i < ns; ++i) s4[i] = tmp0 + coef * (float)(i - pe);
  }
  __syncthreads();

  // ---- SmoothF0Contour (:1049-1113) on the 300-frame apron ----
  // the apron's zeros end every run, so its sections are the runs of s4
  if (tid < 32) {
    const int n = build_sections(s4, T, false, st, ed, cap_s);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < T; i += THREADS) o[i] = 0.f;
  __syncthreads();
  for (int k = tid; k < sh_n; k += THREADS) {
    double* buf = smb + (size_t)tid * Lx;
    const int a = st[k] + LAG, b = ed[k] + LAG;
    double w0 = 0.0, w1 = 0.0;
    for (int j = 0; j < Lx; ++j) {  // held edges outside [a, b]
      const double x = (double)s4[min(max(j, a), b) - LAG];
      const double wt = x + BA0 * w0 + BA1 * w1;
      buf[Lx - 1 - j] = BB0 * wt + BB1 * w0 + BB0 * w1;
      w1 = w0;
      w0 = wt;
    }
    w0 = w1 = 0.0;
    for (int j = 0; j <= Lx - 1 - a; ++j) {  // written back to front
      const double wt = buf[j] + BA0 * w0 + BA1 * w1;
      const double yv = BB0 * wt + BB1 * w0 + BB0 * w1;
      const int p = Lx - 1 - j;
      if (p <= b) o[p - LAG] = (float)yv;
      w1 = w0;
      w0 = wt;
    }
  }
}

}  // namespace

extern "C" int harvest_contour_launch(const float* rc, const float* sc, int B,
                                      int T, int NC, int cap3, int cap_s,
                                      int rows_s, int runs, float* fields,
                                      float* conts, float* multi,
                                      double* smooth, int* ints, double* sums,
                                      float* out, cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (T < 3 || rows_s < min(cap_s, THREADS)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(TILE + 2) * NC * sizeof(float);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_contour_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_contour_kernel<<<B, THREADS, smem, s>>>(rc, sc, T, NC, cap3, cap_s,
                                                  rows_s, runs, fields, conts,
                                                  multi, smooth, ints, sums,
                                                  out);
  return (int)cudaGetLastError();
}
