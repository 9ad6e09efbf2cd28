// K17: gathered MSD diagonal-Gaussian log-likelihoods of a padded batch of
// utterance chains, float64.
//
// Replaces hts_train_world_tpu/models/hsmm.py:147-171 (_gauss_ll,
// frame_loglik) as hsmm_batch.py:194-201 vmaps it over a bucket: per
// utterance a (T, K, D_s) broadcast of (x - mu)^2 / v per stream, which XLA
// materialises.
//
// Per (b, t, k) and every stream s, in stream order:
//   ll = -0.5 * ((sum_j (x_j - mu_j)^2 / v_j + sum_j log v_j) + D_s log 2pi)
// an MSD stream scores log w + ll where frames[b, t, a_s] != 0, else
// log1p(-w), w clipped to [1e-4, 1 - 1e-4]; total = total + weight * ll.
// A stream of weight 0.0 (bap) is scored too, as hsmm.py:170 does: for a
// finite ll the total is unchanged, and a NaN or inf in its columns makes
// the total NaN, as in the JAX package.
//
// Two stages.  The row prologue (hsmm_loglik_rows_kernel, a thread a row)
// turns each stream's variance rows into 1/v and sum_j log v and each MSD
// weight into log w and log1p(-w), in place in the caller's table buffer;
// the wrapper caches that buffer per model set, so the prologue runs once
// and not at every launch.  The main kernel is a "distance GEMM": a block
// takes 128 frames x 4 KG chain states of one utterance (KG warps; the
// launcher sizes KG so the state tiles cover Kb with little padding) and
// walks every stream's columns in chunks of C = 4, the chunks of all the
// streams in one sequence.  cp.async copies the frame tile and the tile's
// gathered (mu, 1/v) rows of each chunk into shared memory, NS - 1 chunks
// ahead of the one in use, so the block neither waits on nor spends
// registers for its loads.  A thread keeps a 4 x 4 register tile of
// quadratic forms: 4 frames by its lane (a warp's reads of x are 32
// neighbours), 4 states by its warp (its reads of (mu, 1/v) are
// broadcasts), and adds, per column, d = x - mu and (d d)(1/v): the
// difference form (the expanded [x^2, x, 1] product would cancel to ~eps
// x^2 / v where x ~ mu), each term rounded as d d, then times 1/v, and
// added in column order, unfused (--fmad=false).  A fused fma(d / v, d,
// q) is as accurate, but on chip_smoke.py's voice corpus it moves a
// rounding tie in the recipe's M-step (an MSD leaf's voiced occupancy at
// its 2.0 threshold), and with it the card's voice away from the CPU's
// beyond that comparison's 1e-8.  Columns past a stream's width are
// staged as zeros and add nothing.  The totals leave through shared
// memory, each frame's states in one coalesced run.
//
// Bound: operations, on the FP64 pipes (four float64 instructions per
// (b, t, k, column): a subtract, two multiplies and an add, against a few
// bytes per frame, per gathered row and per output).  The staging and the
// shared-memory reads, not the pipes, hold the kernel back (see PERF.md).
#include "common.cuh"

namespace {

constexpr int MAXS = 8;            // streams
constexpr int C = 4;               // columns a chunk
constexpr int NS = 4;              // chunks in flight (cp.async stages)
constexpr int NF = 128;            // frames a block: 4 a lane of a warp
constexpr int KGMAX = 8;           // warps a block: 4 states each
constexpr int NKMAX = 4 * KGMAX;
constexpr int NT = 32 * KGMAX;     // most threads a block
// shared memory: the stages' frame tiles and rows, then the output tile
constexpr int STAGE = C * NF + 2 * C * NKMAX;          // doubles a stage
constexpr int SMEM = NF * (NKMAX + 1) > NS * STAGE ? NF * (NKMAX + 1)
                                                   : NS * STAGE;
constexpr double LOG_2PI = 1.8378770664093453;

// Per stream: column start, width, MSD flag, row count, the offsets of its
// tables in the buffer (means (R, D), 1/v (R, D), sum log v (R,), log w
// (R,), log1p(-w) (R,)), its weight and its (B, Kb) row ids.
struct Streams {
  int n;
  int a[MAXS], d[MAXS], msd[MAXS], R[MAXS];
  long long mu[MAXS], iv[MAXS], slv[MAXS], lw[MAXS], l1[MAXS];
  double wt[MAXS];
  const long long* rows[MAXS];
};

// The row prologue: on entry iv holds the variances and lw the raw MSD
// weights; a thread takes one row of one stream.
__global__ void hsmm_loglik_rows_kernel(const Streams st, int total,
                                        double* __restrict__ tabs) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int s = 0;
  while (g >= st.R[s]) g -= st.R[s++];
  const long long r = g;
  const int Ds = st.d[s];
  double* iv = tabs + st.iv[s] + r * Ds;
  double slv = 0.0;
  for (int j = 0; j < Ds; ++j) {
    const double v = iv[j];
    slv += log(v);
    iv[j] = 1.0 / v;
  }
  tabs[st.slv[s] + r] = slv;
  if (st.msd[s]) {
    const double w = fmin(fmax(tabs[st.lw[s] + r], 1e-4), 1.0 - 1e-4);
    tabs[st.lw[s] + r] = log(w);
    tabs[st.l1[s] + r] = log1p(-w);
  }
}

// an 8-byte asynchronous copy to shared memory, zero-filled where !ok
__device__ __forceinline__ void copy8(void* dst, const double* src,
                                      bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(ok ? src : nullptr), "r"(ok ? 8 : 0)
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
  int n = (st.d[0] + C - 1) / C;
  while (g >= n) {
    g -= n;
    n = (st.d[++s] + C - 1) / C;
  }
  c0 = g * C;
}

__global__ void __launch_bounds__(NT, 2)
hsmm_loglik_kernel(const double* __restrict__ frames, int Tb, int D, int Kb,
                   int KG, int nK, const Streams st,
                   const double* __restrict__ tabs,
                   double* __restrict__ out) {
  __shared__ __align__(16) double smem[SMEM];
  __shared__ long long rr[MAXS][NKMAX];       // the tile's row ids
  const int b = blockIdx.y;
  const int kt = blockIdx.x % nK, ft = blockIdx.x / nK;
  const int NK = 4 * KG;
  const int t0 = ft * NF, k0 = kt * NK;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, kg = tid >> 5;   // frames by lane, states by warp
  const double* fb = frames + (size_t)b * Tb * D;
  for (int i = tid; i < st.n * NK; i += nth) {
    const int s = i / NK, k = i - s * NK;
    rr[s][k] = k0 + k < Kb ? st.rows[s][(size_t)b * Kb + k0 + k] : -1;
  }
  int G = 0;
  for (int s = 0; s < st.n; ++s) G += (st.d[s] + C - 1) / C;
  __syncthreads();

  // stage g: the frame tile's C columns (xs[j][f]) and the tile rows'
  // (mu, 1/v) (mv[j][k]); columns past the stream's width are zeros
  auto stage = [&](int g) {
    int s, c0;
    chunk_at(st, g, s, c0);
    double* xs = smem + (g % NS) * STAGE;
    double* mv = xs + C * NF;
    const int a = st.a[s], Ds = st.d[s];
    for (int i = tid; i < NF * C; i += nth) {
      const int f = i / C, j = i % C, t = t0 + f;
      copy8(xs + j * NF + f, fb + (size_t)t * D + a + c0 + j,
            t < Tb && c0 + j < Ds);
    }
    const double* mu = tabs + st.mu[s];
    const double* iv = tabs + st.iv[s];
    for (int i = tid; i < NK * C; i += nth) {
      const int k = i / C, j = i % C;
      const long long r = rr[s][k];
      const bool ok = r >= 0 && c0 + j < Ds;
      copy8(mv + 2 * (j * NKMAX + k), mu + r * Ds + c0 + j, ok);
      copy8(mv + 2 * (j * NKMAX + k) + 1, iv + r * Ds + c0 + j, ok);
    }
  };

  double total[4][4], q[4][4];
  bool present[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) total[i][k] = 0.0;
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
    const bool msd = st.msd[s] != 0;
    const double* xs = smem + (g % NS) * STAGE;
    const double2* mv = reinterpret_cast<const double2*>(xs + C * NF);
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        present[i] = xs[lane + 32 * i] != 0.0;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[i][k] = 0.0;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      double x[4];
      double2 m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[j * NF + lane + 32 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = mv[j * NKMAX + kg + KG * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double d = x[i] - m[k].x;
          q[i][k] += d * d * m[k].y;
        }
    }
    if (c0 + C >= st.d[s]) {                  // the stream's last chunk
      const double c = (double)st.d[s] * LOG_2PI, wt = st.wt[s];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long r = rr[s][kg + KG * k];
        double slv = 0.0, lw = 0.0, l1 = 0.0;
        if (r >= 0) {
          slv = tabs[st.slv[s] + r];
          if (msd) {
            lw = tabs[st.lw[s] + r];
            l1 = tabs[st.l1[s] + r];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          double ll = -0.5 * ((q[i][k] + slv) + c);
          if (msd) ll = present[i] ? lw + ll : l1;
          total[i][k] = total[i][k] + wt * ll;
        }
      }
    }
    __syncthreads();                          // stage g % NS free again
  }
  // through shared memory, so each frame's states go out in one run
  copy_wait<0>();
  __syncthreads();
  double (*ot)[NKMAX + 1] = reinterpret_cast<double (*)[NKMAX + 1]>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) ot[lane + 32 * i][kg + KG * k] = total[i][k];
  __syncthreads();
  for (int i = tid; i < NF * NK; i += nth) {
    const int f = i / NK, k = i - f * NK;
    const int t = t0 + f, kk = k0 + k;
    if (t < Tb && kk < Kb) out[((size_t)b * Tb + t) * Kb + kk] = ot[f][k];
  }
}

}  // namespace

// meta (host, n_streams x 9 int64): column start, stop, msd flag, rows R,
// and the offsets of the stream's means (R, D_s), 1/v (R, D_s), sum log v,
// log w and log1p(-w) (R,) in `tabs`; wts (host, n_streams doubles); rows
// (host, n_streams device pointers to (B, Kb) int64).  prep != 0 runs the
// row prologue over `tabs` first (its 1/v and log w regions then hold the
// variances and the raw weights).
extern "C" int hsmm_loglik_launch(const double* frames, int B, int Tb, int D,
                                  int Kb, int n_streams,
                                  const long long* meta, const double* wts,
                                  const void* const* rows, double* tabs,
                                  int prep, double* out, cudaStream_t s) {
  if (n_streams < 1 || n_streams > MAXS) return (int)cudaErrorInvalidValue;
  Streams st;
  st.n = n_streams;
  int total_rows = 0;
  for (int i = 0; i < n_streams; ++i) {
    const long long* m = meta + 9 * i;
    st.a[i] = (int)m[0];
    st.d[i] = (int)(m[1] - m[0]);
    st.msd[i] = (int)m[2];
    st.R[i] = (int)m[3];
    st.mu[i] = m[4];
    st.iv[i] = m[5];
    st.slv[i] = m[6];
    st.lw[i] = m[7];
    st.l1[i] = m[8];
    st.wt[i] = wts[i];
    st.rows[i] = static_cast<const long long*>(rows[i]);
    total_rows += st.R[i];
  }
  if (prep && total_rows > 0)
    hsmm_loglik_rows_kernel<<<(total_rows + 127) / 128, 128, 0, s>>>(
        st, total_rows, tabs);
  if (B > 0 && Tb > 0 && Kb > 0) {
    // state tiles: nK tiles of 4 KG states (a warp each 4), KG <= 8,
    // covering Kb with little padding; frame tiles of 128
    const int nF = (Tb + NF - 1) / NF;
    const int nK = (Kb + NKMAX - 1) / NKMAX;
    const int KG = ((Kb + nK - 1) / nK + 3) / 4;
    const dim3 grid(nF * nK, B);
    hsmm_loglik_kernel<<<grid, 32 * KG, 0, s>>>(frames, Tb, D, Kb, KG, nK,
                                                st, tabs, out);
  }
  return (int)cudaGetLastError();
}
