// K33: mixture-of-diagonal-Gaussians log-likelihoods and component
// posteriors, float64.  Two launchers:
//
// - chain mode (hsmm_mix_loglik_launch) replaces
//   hts_train_world_tpu/models/hsmm_variants.py:87-107 (frame_loglik_mix,
//   called per label by align_utterance_mix): per utterance a (T, S, C, D_s)
//   broadcast of (x - mu)^2 / v per stream and label, which XLA
//   materialises.  Per (b, t, k) and stream s, in stream order:
//     ll_c = -0.5 * ((sum_j (x_j - mu_cj)^2 / v_cj + sum_j log v_cj)
//                    + D_s log 2pi)
//     z_c  = log w_c + ll_c;  m = max_c z_c (NaN if any is), 0 where m is
//     not finite;  ll = log(sum_c exp(z_c - m)) + m
//   (jax.scipy.special.logsumexp's form); an MSD stream scores log w + ll
//   where frames[b, t, a_s] != 0, else log1p(-w), w clipped to [1e-4,
//   1 - 1e-4]; total = total + weight * ll, the weight-0 bap included as K17
//   does (a NaN in its columns makes the total NaN).
//   K17's design (hsmm_loglik.cu) with C components.  A row prologue
//   (mix_rows_kernel, a thread a (row, component)) turns each stream's
//   (mu, v) rows into 1/v and sum_j log v, and each MSD weight into log w
//   and log1p(-w), in the caller's table buffer, which the wrapper caches
//   per mixture set: it runs once a set, not at every launch.  The main
//   kernel (mix_chain_kernel) is a "distance GEMM": a block takes 64
//   frames x TK KG chain states of one utterance (KG warps) and walks every
//   stream's columns in chunks of CC = 4, cp.async staging the frame tile
//   and the tile's gathered (mu, v, 1/v) rows of each component NS - 1
//   chunks ahead.  A thread keeps 2 frames (by its lane) x TK states (by its
//   warp) x C quadratic forms in registers, TK sized per C (4 for C <= 2, 2
//   for C <= 4, 1 up to 8: at most 16 sums) so that no C spills, and every
//   thread is busy at any Kb.  Tiles of 64 frames pad a batch's frames
//   less and cut a launch into more blocks than 128 would (ERST5's largest
//   batch: 1056 blocks, 7 % padding, against 576 and 17 %), so the last
//   wave of blocks idles less of the card.  At a stream's last chunk the epilogue takes
//   the logsumexp over C, the MSD switch and total + weight * ll into a
//   shared-memory tile of totals, which leaves in coalesced rows.
//
//   Each term is the twin's correctly rounded quotient (x - mu)^2 / v,
//   added unfused in column order (a recipe threshold sits on these last
//   bits, ROADMAP Queue C), without a division (quot): with rv =
//   RN(1/v) from the prologue, q0 = RN(dd rv) is within 2 ulps of dd / v
//   (two roundings of 2^-53 each); r = fma(-v, q0, dd), q1 = fma(r, rv, q0)
//   puts the exact sum within 2^-50 ulp of dd / v, so q1 is faithful (within
//   1 ulp); then r = fma(-v, q1, dd) is exact (the remainder of a faithful
//   quotient is representable) and, by Markstein's theorem (rv correctly
//   rounded, q1 faithful), fma(r, rv, q1) is RN(dd / v).  One correction
//   would not do: a quotient may lie within 2^-54 ulp of a midpoint.  The
//   theorem needs no overflow or underflow: it holds where dd is 0 or in
//   [2^-960, 2^960) and |v| in [2^-60, 2^60].  That is so where x and mu
//   are each 0 or of magnitude in [2^-400, 2^479) (distinct such doubles
//   differ by at least 2^-452), so a thread checks its frames' x once a
//   column, the prologue marks a row element whose mu or v is out of range
//   by a NaN 1/v, and a column of a thread's tile with either divides all
//   its terms (NaN and inf inputs too).  `hsmm_mix_quot_launch` runs a
//   term on given (x, mu, v) triples with the chain kernel's own tests
//   (in_range(x), recip's NaN for mu and v) choosing between the
//   corrections and the division, so a check can hold the term and that
//   choice against the division bit for bit.
// - posterior mode (hsmm_mix_post_launch) replaces :147-154
//   (_responsibilities, called per (model, state, stream) segment): one
//   thread a frame of one stream, its row's components scored with the
//   twin's ll_c arithmetic (a division a term), then z - max_c z (no
//   finiteness test, as numpy), exp, divided by the sum over c.
//
// Bound: operations, on the FP64 pipes (per (b, t, k, component, column) a
// subtract, three multiplies, four fmas and an add in chain mode, with the
// range checks once a column of a thread's tile; per
// (frame, component, column) a subtract, a square and a divide-add in
// posterior mode), against a few bytes per frame, per gathered row and per
// output.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;       // posterior mode
constexpr double LOG_2PI = 1.8378770664093453;
constexpr int MAXS = 8;            // streams
constexpr int CC = 4;              // columns a chunk
constexpr int NS = 4;              // chunks in flight (cp.async stages)
constexpr int TF = 2;              // frames a lane
constexpr int NF = 32 * TF;        // frames a block
constexpr int KGMAX = 8;           // warps a block

// chain mode's tile for C components: states a thread (TK), a block's most
// states, doubles a stage (the frame tile, (mu, v) pairs, 1/v) and the
// dynamic shared memory (the stages, then the totals)
template <int NC>
struct Tile {
  static constexpr int TK = NC <= 2 ? 4 : NC <= 4 ? 2 : 1;
  static constexpr int NKMAX = KGMAX * TK;
  static constexpr int STAGE = CC * NF + 3 * CC * NKMAX * NC;
  static constexpr int SMEM = NS * STAGE + NF * (NKMAX + 1);
};

// Per stream: column start, width, MSD flag, row count, the offsets of its
// tables in the buffer ((mu, v) pairs (R, C, D), 1/v (R, C, D), sum log v
// (R, C), log w_c (R, C), log w and log1p(-w) of the MSD weight (R,)), its
// weight and its (B, Kb) row ids.
struct Streams {
  int n;
  int a[MAXS], d[MAXS], msd[MAXS], R[MAXS];
  long long mv[MAXS], rv[MAXS], slv[MAXS], lw[MAXS], ml[MAXS], m1[MAXS];
  double wt[MAXS];
  const long long* rows[MAXS];
};

// max that propagates NaN, as jnp.max / torch.amax / numpy's max do
__device__ __forceinline__ double nan_max(double m, double z) {
  return (z > m || isnan(z)) ? z : m;
}

// x is 0 or of magnitude in [2^-400, 2^479) (integer tests on its bits)
__device__ __forceinline__ bool in_range(double x) {
  const unsigned h = (unsigned)__double2hiint(x);
  return ((h >> 20) & 0x7ffu) - 623u < 879u
         || ((h & 0x7fffffffu) | (unsigned)__double2loint(x)) == 0u;
}

// 1/v where the quotient corrections hold for v (and, given mu, for every
// term of the row element), NaN elsewhere (those terms divide)
__device__ __forceinline__ double recip(double v, bool mu_ok = true) {
  const double a = fabs(v);
  return (mu_ok && a >= 0x1p-60 && a <= 0x1p60)
      ? 1.0 / v : __longlong_as_double(0x7ff8000000000000LL);
}

// RN(dd / v) from rv = RN(1/v), dd and v in the range of the head of the
// file: q0 = dd rv, then two corrections
__device__ __forceinline__ double quot(double dd, double v, double rv) {
  double q = dd * rv;
  double r = fma(-v, q, dd);
  q = fma(r, rv, q);
  r = fma(-v, q, dd);
  return fma(r, rv, q);
}

// The row prologue: on entry mv holds the (mu, v) pairs and ml the raw MSD
// weights; a thread takes one (row, component) of one stream.
__global__ void mix_rows_kernel(const Streams st, int C, int total,
                                double* __restrict__ tabs) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int s = 0;
  while (g >= st.R[s] * C) g -= st.R[s++] * C;
  const long long rc = g;                    // row * C + component
  const int Ds = st.d[s];
  const double2* mv = reinterpret_cast<const double2*>(tabs + st.mv[s])
      + rc * Ds;
  double* rv = tabs + st.rv[s] + rc * Ds;
  double slv = 0.0;
  for (int j = 0; j < Ds; ++j) {
    const double v = mv[j].y;
    slv += log(v);
    rv[j] = recip(v, in_range(mv[j].x));
  }
  tabs[st.slv[s] + rc] = slv;
  if (st.msd[s] && rc % C == 0) {
    const long long r = rc / C;
    const double w = fmin(fmax(tabs[st.ml[s] + r], 1e-4), 1.0 - 1e-4);
    tabs[st.ml[s] + r] = log(w);
    tabs[st.m1[s] + r] = log1p(-w);
  }
}

// asynchronous copies to shared memory, zero-filled where !ok
__device__ __forceinline__ void copy8(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(ok ? src : nullptr), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(ok ? src : nullptr), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// chunk g of the stream-ordered sequence: its stream and first column
__device__ __forceinline__ void chunk_at(const Streams& st, int g, int& s,
                                         int& c0) {
  s = 0;
  int n = (st.d[0] + CC - 1) / CC;
  while (g >= n) {
    g -= n;
    n = (st.d[++s] + CC - 1) / CC;
  }
  c0 = g * CC;
}

template <int NC>
__global__ void __launch_bounds__(32 * KGMAX, 2)
mix_chain_kernel(const double* __restrict__ frames, int Tb, int D, int Kb,
                 int KG, int nK, const Streams st,
                 const double* __restrict__ tabs, double* __restrict__ out) {
  using T = Tile<NC>;
  constexpr int TK = T::TK, NKMAX = T::NKMAX;
  extern __shared__ __align__(16) double smem[];
  __shared__ long long rr[MAXS][NKMAX];       // the tile's row ids
  double (*tot)[NKMAX + 1] =
      reinterpret_cast<double (*)[NKMAX + 1]>(smem + NS * T::STAGE);
  const int b = blockIdx.y;
  const int kt = blockIdx.x % nK, ft = blockIdx.x / nK;
  const int NK = TK * KG;
  const int t0 = ft * NF, k0 = kt * NK;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, kg = tid >> 5;   // frames by lane, states by warp
  const double* fb = frames + (size_t)b * Tb * D;
  for (int i = tid; i < st.n * NK; i += nth) {
    const int s = i / NK, k = i - s * NK;
    rr[s][k] = k0 + k < Kb ? st.rows[s][(size_t)b * Kb + k0 + k] : -1;
  }
  for (int i = tid; i < NF * (NKMAX + 1); i += nth) (&tot[0][0])[i] = 0.0;
  int G = 0;
  for (int s = 0; s < st.n; ++s) G += (st.d[s] + CC - 1) / CC;
  __syncthreads();

  // stage g: the frame tile's CC columns (xs[j][f]) and, per column, state
  // and component, the rows' (mu, v) (mv) and 1/v (rv); columns past the
  // stream's width and padding states are zeros
  auto stage = [&](int g) {
    int s, c0;
    chunk_at(st, g, s, c0);
    double* xs = smem + (g % NS) * T::STAGE;
    double2* mv = reinterpret_cast<double2*>(xs + CC * NF);
    double* rv = xs + CC * NF + 2 * CC * NKMAX * NC;
    const int a = st.a[s], Ds = st.d[s];
    for (int i = tid; i < NF * CC; i += nth) {
      const int f = i / CC, j = i % CC, t = t0 + f;
      copy8(xs + j * NF + f, fb + (size_t)t * D + a + c0 + j,
            t < Tb && c0 + j < Ds);
    }
    const double2* mvs = reinterpret_cast<const double2*>(tabs + st.mv[s]);
    const double* rvs = tabs + st.rv[s];
    for (int i = tid; i < NK * NC * CC; i += nth) {
      const int j = i % CC, kc = i / CC, k = kc / NC, c = kc % NC;
      const long long r = rr[s][k];
      const bool ok = r >= 0 && c0 + j < Ds;
      const long long src = (r * NC + c) * Ds + c0 + j;
      const int dst = (j * NKMAX + k) * NC + c;
      copy16(mv + dst, mvs + src, ok);
      copy8(rv + dst, rvs + src, ok);
    }
  };

  double acc[TF][TK][NC];
  bool present[TF];
#pragma unroll
  for (int f = 0; f < TF; ++f) {
    present[f] = false;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[f][kk][c] = 0.0;
  }
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < G) stage(g);
    copy_commit();
  }
  for (int g = 0; g < G; ++g) {
    if (g + NS - 1 < G) stage(g + NS - 1);
    copy_commit();
    copy_wait<NS - 1>();
    __syncthreads();
    int s, c0;
    chunk_at(st, g, s, c0);
    const double* xs = smem + (g % NS) * T::STAGE;
    const double2* mv = reinterpret_cast<const double2*>(xs + CC * NF);
    const double* rv = xs + CC * NF + 2 * CC * NKMAX * NC;
    if (c0 == 0) {
#pragma unroll
      for (int f = 0; f < TF; ++f) present[f] = xs[lane + 32 * f] != 0.0;
    }
#pragma unroll 1
    for (int j = 0; j < CC; ++j) {
      double x[TF], rvv[TK][NC];
      bool ok = true;
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        x[f] = xs[j * NF + lane + 32 * f];
        ok &= in_range(x[f]);
      }
#pragma unroll
      for (int kk = 0; kk < TK; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          rvv[kk][c] = rv[(j * NKMAX + kg + KG * kk) * NC + c];
          ok &= rvv[kk][c] == rvv[kk][c];
        }
      if (ok) {
#pragma unroll
        for (int kk = 0; kk < TK; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const double2 m = mv[(j * NKMAX + kg + KG * kk) * NC + c];
#pragma unroll
            for (int f = 0; f < TF; ++f) {
              const double dx = x[f] - m.x;
              acc[f][kk][c] += quot(dx * dx, m.y, rvv[kk][c]);
            }
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < TK; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const double2 m = mv[(j * NKMAX + kg + KG * kk) * NC + c];
#pragma unroll
            for (int f = 0; f < TF; ++f) {
              const double dx = x[f] - m.x;
              acc[f][kk][c] += dx * dx / m.y;
            }
          }
      }
    }
    if (c0 + CC >= st.d[s]) {                 // the stream's last chunk
      const bool msd = st.msd[s] != 0;
      const double c2pi = (double)st.d[s] * LOG_2PI, wt = st.wt[s];
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const int k = kg + KG * kk;
        const long long r = rr[s][k];
        double lw[NC], slv[NC], lwm = 0.0, l1 = 0.0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          lw[c] = r >= 0 ? tabs[st.lw[s] + r * NC + c] : 0.0;
          slv[c] = r >= 0 ? tabs[st.slv[s] + r * NC + c] : 0.0;
        }
        if (msd && r >= 0) {
          lwm = tabs[st.ml[s] + r];
          l1 = tabs[st.m1[s] + r];
        }
#pragma unroll
        for (int f = 0; f < TF; ++f) {
          double z[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            z[c] = lw[c] + -0.5 * ((acc[f][kk][c] + slv[c]) + c2pi);
            acc[f][kk][c] = 0.0;
          }
          double mx = z[0];
#pragma unroll
          for (int c = 1; c < NC; ++c) mx = nan_max(mx, z[c]);
          if (!isfinite(mx)) mx = 0.0;
          double sum = 0.0;
#pragma unroll
          for (int c = 0; c < NC; ++c) sum += exp(z[c] - mx);
          double ll = log(sum) + mx;
          if (msd) ll = present[f] ? lwm + ll : l1;
          double& o = tot[lane + 32 * f][k];
          o = o + wt * ll;
        }
      }
    }
    __syncthreads();                          // stage g % NS free again
  }
  copy_wait<0>();
  __syncthreads();
  for (int i = tid; i < NF * NK; i += nth) {
    const int f = i / NK, k = i - f * NK;
    const int t = t0 + f, kk = k0 + k;
    if (t < Tb && kk < Kb) out[((size_t)b * Tb + t) * Kb + kk] = tot[f][k];
  }
}

// one term (x - mu)^2 / v a thread, decided and computed as the chain
// kernel does for each of a column's terms
__global__ void mix_quot_kernel(const double* __restrict__ x,
                                const double* __restrict__ mu,
                                const double* __restrict__ v, long long n,
                                double* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const double rv = recip(v[i], in_range(mu[i]));
    const double dx = x[i] - mu[i];
    out[i] = in_range(x[i]) && rv == rv ? quot(dx * dx, v[i], rv)
                                        : dx * dx / v[i];
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
                 const Streams& st, const double* tabs, double* out,
                 cudaStream_t s) {
  using T = Tile<NC>;
  const int smem = (int)(sizeof(double) * T::SMEM);
  const cudaError_t e = cudaFuncSetAttribute(
      mix_chain_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  // state tiles: nK tiles of TK KG states (KG <= 8 warps) covering Kb with
  // little padding; frame tiles of NF
  const int nF = (Tb + NF - 1) / NF;
  const int nK = (Kb + T::NKMAX - 1) / T::NKMAX;
  const int KG = ((Kb + nK - 1) / nK + T::TK - 1) / T::TK;
  const dim3 grid(nF * nK, B);
  mix_chain_kernel<NC><<<grid, 32 * KG, smem, s>>>(frames, Tb, D, Kb, KG,
                                                   nK, st, tabs, out);
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

// meta (host, n_streams x 10 int64): column start, stop, msd flag, rows R,
// and the offsets in `tabs` of the stream's (mu, v) pairs (R, C, D_s)
// (even), 1/v (R, C, D_s), sum log v (R, C), log w_c (R, C), and log w and
// log1p(-w) of the MSD weight (R,); wts (host, n_streams doubles); rows
// (host, n_streams device pointers to (B, Kb) int64).  prep != 0 runs the
// row prologue over `tabs` first (its 1/v, sum log v and log1p(-w) regions
// are then filled, and the MSD log w region holds the raw weights).
extern "C" int hsmm_mix_loglik_launch(const double* frames, int B, int Tb,
                                      int D, int Kb, int n_streams, int C,
                                      const long long* meta,
                                      const double* wts,
                                      const void* const* rows, double* tabs,
                                      int prep, double* out,
                                      cudaStream_t s) {
  if (n_streams < 1 || n_streams > MAXS || C < 1 || C > 8)
    return (int)cudaErrorInvalidValue;
  Streams st;
  st.n = n_streams;
  int total = 0;
  for (int i = 0; i < n_streams; ++i) {
    const long long* m = meta + 10 * i;
    st.a[i] = (int)m[0];
    st.d[i] = (int)(m[1] - m[0]);
    st.msd[i] = (int)m[2];
    st.R[i] = (int)m[3];
    st.mv[i] = m[4];
    st.rv[i] = m[5];
    st.slv[i] = m[6];
    st.lw[i] = m[7];
    st.ml[i] = m[8];
    st.m1[i] = m[9];
    st.wt[i] = wts[i];
    st.rows[i] = static_cast<const long long*>(rows[i]);
    total += st.R[i] * C;
  }
  if (prep && total > 0)
    mix_rows_kernel<<<(total + 127) / 128, 128, 0, s>>>(st, C, total, tabs);
  if (B <= 0 || Tb <= 0 || Kb <= 0) return (int)cudaGetLastError();
  switch (C) {
#define K33_CHAIN(n)                                                      \
  case n:                                                                 \
    return chain_launch<n>(frames, B, Tb, D, Kb, st, tabs, out, s);
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

// out[i] = (x[i] - mu[i])^2 / v[i] as the chain kernel forms a term: by its
// corrections (quot, 1/v as the row prologue forms it) where its range
// tests pass, else divided
extern "C" int hsmm_mix_quot_launch(const double* x, const double* mu,
                                    const double* v, long long n,
                                    double* out, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + 255) / 256;
  mix_quot_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      x, mu, v, n, out);
  return (int)cudaGetLastError();
}
