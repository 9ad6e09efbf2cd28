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
// numerator lies within a relative margin of it (2^-20 in float, 2^-40 in
// double, each far above the type's 2 ulps) can round to the same
// quotient, so only those are divided again to find the last minimum, as
// the twin does.
//
// Bound: latency of the serial steps (ExtendSub, the sort and MergeF0's
// walk, and 2 x (T + 600) dependent float64 steps per section); bytes and
// operations are small.  Built with --fmad=false.
//
// The kernel is a template on the scalar type of the fields, the contours
// and the section channels: float is the fast path, double the parity
// analysis' Harvest (the twin in float64).  The running sums, the score
// sums and the smoothing are float64 in both.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8;  // frames a RemoveUnreliable tile holds
constexpr unsigned FULL = 0xffffffffu;
constexpr int LAG = 300;
constexpr double BB0 = 0.0078202080334971724, BB1 = 0.015640416066994345;
constexpr double BA0 = 1.7347257688092754, BA1 = -0.76600660094326412;

// a constant in each type: the float instantiation keeps its literals
template <typename T> struct K;
template <> struct K<float> {
  static constexpr float RANGE3 = 0.18f, KILL = 0.05f, JUMP = 0.008f;
  static constexpr float TINY = 1e-30f, BIG = FLT_MAX;
  static constexpr float MARGIN = 1.0f + 1.0f / 1048576.0f;  // 1 + 2^-20
};
template <> struct K<double> {
  static constexpr double RANGE3 = 0.18, KILL = 0.05, JUMP = 0.008;
  static constexpr double TINY = 1e-30, BIG = DBL_MAX;
  static constexpr double MARGIN = 1.0 + 1.0 / 1099511627776.0;  // 2^-40
};

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float min_t(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_t(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

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
template <typename T>
__device__ int build_sections(const T* f, int n, bool forced, int* st,
                              int* ed, int cap) {
  const int lane = threadIdx.x & 31;
  int k = 0;
  unsigned prev = 0u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool v =
        i < n && f[i] > T(0) && !(forced && (i == 0 || i == n - 1));
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
template <typename T>
__device__ __forceinline__ T select_best(T ref, const T* row, int NC) {
  T m = K<T>::BIG;
  for (int k = 0; k < NC; ++k) m = min_t(m, abs_t(ref - row[k]));
  const T e = div_rn(m, ref);
  if (!(e <= K<T>::RANGE3)) return T(0);
  const T lim = m * K<T>::MARGIN;
  for (int k = NC - 1; k >= 0; --k) {
    const T x = abs_t(ref - row[k]);
    if (x <= lim && div_rn(x, ref) == e) return row[k];
  }
  return T(0);
}

// ExtendF0 (harvest.cpp:791-820) on one section's channel
template <typename T>
__device__ int extend(T* ch, int origin, int last, int sign, const T* c2,
                      int NC, int nT) {
  T tmp = max_t(ch[origin], K<T>::TINY);
  int shifted = origin, count = 0;
  const int span = abs(last - origin);
  for (int i = 0; i <= span; ++i) {
    const int idx = origin + sign * (i + 1);
    const int ic = min(max(idx, 0), nT - 1);
    const T best = select_best(tmp, c2 + (size_t)ic * NC, NC);
    ch[ic] = best;
    if (best == T(0)) {
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
template <typename T>
__device__ __forceinline__ T match_score(T f, const T* c, const T* s,
                                         int NC) {
  T best = T(0);
  for (int k = 0; k < NC; ++k)
    if (c[k] == f && best < s[k]) best = s[k];
  return best;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_contour_kernel(const T* __restrict__ rc, const T* __restrict__ sc,
                       int nT, int NC, int cap3, int cap_s, int rows_s,
                       int runs, T* fields, T* conts, T* multi,
                       double* smooth, int* ints, double* sums,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // (TILE + 2) candidate rows
  __shared__ int sh_n, sh_keep;
  __shared__ double red[32];
  const int u = blockIdx.x, tid = threadIdx.x;
  const size_t F = (size_t)nT * NC;
  const T* ci = rc + u * F;
  const T* si = sc + u * F;
  T* c2 = fields + u * 2 * F;
  T* s2 = c2 + F;
  T* base = conts + (size_t)u * 4 * nT;  // later FixStep3's output
  T* s1 = base + nT;
  T* sx = s1 + nT;                       // FixStep2's output
  T* s4 = sx + nT;
  T* mul = multi + (size_t)u * cap3 * nT;
  const int Lx = nT + 2 * LAG;
  double* smb = smooth + (size_t)u * rows_s * Lx;
  int* st = ints + (size_t)u * 6 * runs;
  int* ed = st + runs;
  int* st2 = ed + runs;
  int* ed2 = st2 + runs;
  int* kept = ed2 + runs;
  int* order = kept + runs;
  double* ssum = sums + (size_t)u * cap3;
  T* o = out + (size_t)u * nT;

  // ---- RemoveUnreliableCandidates (harvest.cpp:652-688) ----
  // candidates are >= 0, so min |c - n| / c is the least relative error;
  // frames i0-1 .. i0+TILE of the input go to shared memory per tile
  for (int i0 = 0; i0 < nT; i0 += TILE) {
    for (int q = tid; q < (TILE + 2) * NC; q += THREADS) {
      const int i = i0 - 1 + q / NC;
      tile[q] = (i >= 0 && i < nT) ? ci[(size_t)i * NC + q % NC] : T(0);
    }
    __syncthreads();
    for (int q = tid; q < TILE * NC; q += THREADS) {
      const int f = q / NC, i = i0 + f;
      if (i >= nT) break;
      const T c = tile[q + NC];
      bool kill = false;
      if (c != T(0) && i >= 1 && i <= nT - 2) {
        const T* pv = tile + f * NC;
        const T* nx = tile + (f + 2) * NC;
        T m1 = K<T>::BIG, m2 = K<T>::BIG;
        for (int k = 0; k < NC; ++k) {
          m1 = min_t(m1, abs_t(c - nx[k]));
          m2 = min_t(m2, abs_t(c - pv[k]));
        }
        const T e = min_t(min_t(div_rn(m1, c), T(1)),
                          min_t(div_rn(m2, c), T(1)));
        kill = e > K<T>::KILL;
      }
      const size_t p = (size_t)i * NC + q % NC;
      c2[p] = kill ? T(0) : c;
      s2[p] = kill ? T(0) : si[p];
    }
    __syncthreads();
  }

  // ---- SearchF0Base (:693-705): the first best score ----
  for (int i = tid; i < nT; i += THREADS) {
    const T* sr = s2 + (size_t)i * NC;
    int j = 0;
    T best = sr[0];
    for (int k = 1; k < NC; ++k)
      if (sr[k] > best) {
        best = sr[k];
        j = k;
      }
    base[i] = best > T(0) ? c2[(size_t)i * NC + j] : T(0);
  }
  __syncthreads();

  // ---- FixStep1 (:710-722); a zero divisor means the condition holds ----
  for (int i = tid; i < nT; i += THREADS) {
    const T b0 = base[i];
    const T b1 = i >= 1 ? base[i - 1] : T(0);
    const T b2 = i >= 2 ? base[i - 2] : T(0);
    const T ref = b1 * T(2) - b2;
    const bool c1 =
        ref == T(0) || abs_t(div_rn(b0 - ref, ref)) > K<T>::JUMP;
    const bool cc2 = b1 == T(0) || div_rn(abs_t(b0 - b1), b1) > K<T>::JUMP;
    s1[i] = (i >= 2 && b0 != T(0) && !(c1 && cc2)) ? b0 : T(0);
  }
  __syncthreads();

  // ---- FixStep2 (:748-762): zero runs with end - start < 6 ----
  if (tid < 32) {
    const int n = build_sections(s1, nT, true, st, ed, runs);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < nT; i += THREADS) sx[i] = s1[i];
  __syncthreads();
  for (int k = tid; k < sh_n; k += THREADS)
    if (ed[k] - st[k] < 6)
      for (int i = st[k]; i <= ed[k]; ++i) sx[i] = T(0);
  __syncthreads();

  // ---- FixStep3 (:968-995) ----
  T* s3 = base;
  if (tid < 32) {
    const int n = build_sections(sx, nT, true, st, ed, cap3);
    if (tid == 0) sh_n = n;
  }
  __syncthreads();
  const int n_sec = sh_n;
  for (size_t p = tid; p < (size_t)n_sec * nT; p += THREADS) {
    const int k = (int)(p / nT), i = (int)(p % nT);
    mul[p] = (i >= st[k] && i <= ed[k]) ? sx[i] : T(0);
  }
  __syncthreads();
  // Extend (:861-878), then the section sums over [start, end) of ExtendSub
  for (int k = tid; k < n_sec; k += THREADS) {
    T* ch = mul + (size_t)k * nT;
    const int e = extend(ch, ed[k], min(nT - 2, ed[k] + 100), 1, c2, NC, nT);
    const int s = extend(ch, st[k], max(1, st[k] - 100), -1, c2, NC, nT);
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
    for (int i = tid; i < nT; i += THREADS) s3[i] = sx[i];
  } else {
    // MergeF0 (:937-963): the base is slot 0, the walk visits order[1..]
    const int k0 = kept[0];
    for (int i = tid; i < nT; i += THREADS) s3[i] = mul[(size_t)k0 * nT + i];
    int bl0 = st2[k0], bl1 = ed2[k0];
    __syncthreads();
    for (int m = 1; m < nk; ++m) {
      const int oo = kept[order[m]];
      const int sa = st2[oo], eb = ed2[oo];
      const T* ch = mul + (size_t)oo * nT;
      int lo = -1;
      if (sa - bl1 > 0) {  // disjoint: append
        lo = sa;
        bl0 = sa;
      } else if (!(bl0 <= sa && bl1 >= eb)) {  // overlap: by score
        double a = 0.0, b = 0.0;
        for (int i = sa + tid; i <= bl1; i += THREADS) {
          const T* cr = c2 + (size_t)i * NC;
          const T* sr = s2 + (size_t)i * NC;
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
    const int n = build_sections(s3, nT, true, st, ed, runs);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < nT; i += THREADS) s4[i] = s3[i];
  __syncthreads();
  for (int g = tid; g + 1 < sh_n; g += THREADS) {
    const int pe = ed[g], ns = st[g + 1], dist = ns - pe - 1;
    if (dist >= 9) continue;
    const T tmp0 = s3[pe] + T(1), tmp1 = s3[ns] - T(1);
    const T coef = div_rn(tmp1 - tmp0, (T)(dist + 1));
    for (int i = pe + 1; i < ns; ++i) s4[i] = tmp0 + coef * (T)(i - pe);
  }
  __syncthreads();

  // ---- SmoothF0Contour (:1049-1113) on the 300-frame apron ----
  // the apron's zeros end every run, so its sections are the runs of s4
  if (tid < 32) {
    const int n = build_sections(s4, nT, false, st, ed, cap_s);
    if (tid == 0) sh_n = n;
  }
  for (int i = tid; i < nT; i += THREADS) o[i] = T(0);
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
      if (p <= b) o[p - LAG] = (T)yv;
      w1 = w0;
      w0 = wt;
    }
  }
}

template <typename T>
int launch(const void* rc, const void* sc, int B, int nT, int NC, int cap3,
           int cap_s, int rows_s, int runs, void* fields, void* conts,
           void* multi, double* smooth, int* ints, double* sums, void* out,
           cudaStream_t s) {
  const size_t smem = (size_t)(TILE + 2) * NC * sizeof(T);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_contour_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_contour_kernel<T><<<B, THREADS, smem, s>>>(
      static_cast<const T*>(rc), static_cast<const T*>(sc), nT, NC, cap3,
      cap_s, rows_s, runs, static_cast<T*>(fields), static_cast<T*>(conts),
      static_cast<T*>(multi), smooth, ints, sums, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors (rc, sc, fields, conts, multi, out), 1 for
// double.
extern "C" int harvest_contour_launch(const void* rc, const void* sc, int B,
                                      int T, int NC, int cap3, int cap_s,
                                      int rows_s, int runs, int f64,
                                      void* fields, void* conts, void* multi,
                                      double* smooth, int* ints, double* sums,
                                      void* out, cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (T < 3 || rows_s < min(cap_s, THREADS)) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(rc, sc, B, T, NC, cap3, cap_s, rows_s, runs,
                              fields, conts, multi, smooth, ints, sums, out, s)
             : launch<float>(rc, sc, B, T, NC, cap3, cap_s, rows_s, runs,
                             fields, conts, multi, smooth, ints, sums, out, s);
}
