// K34: Gales' semi-tied covariance update, float64, for J independent
// (stream, block) jobs of any block size d.
//
// Replaces hts_train_world_tpu/models/hsmm_variants.py:257-294
// (semitied_block): a jitted lax.scan of n_iter outer steps around a
// fori_loop over the d rows, each row an einsum over the G scatters, a
// determinant, an inverse and a solve.  Per outer step:
//   sigmas_gj = max(a_j^T W_g a_j, 1e-10)      (fixed for the whole step)
//   for r in 0..d-1, in place (Gauss-Seidel over the rows):
//     G_r = sum_g (beta_g / sigma_gr) W_g
//     cof = det(A) * inv(A)[:, r]              (LU of A, partial pivoting)
//     u   = G_r^-1 cof                         (LU of G_r, partial pivoting)
//     row r of A = u * sqrt(beta_tot / max(cof . u, 1e-300))
//   aux = beta_tot log|det A| - 0.5 sum_g beta_g sum_j log sigma'_gj,
//   sigma' the sigmas of the new A (the next step's).
//
// The sigmas, and so every G_r, are fixed for the whole outer step, so the
// launcher splits each step into a parallel part over the whole card and
// a serial part, five kernels on the stream:
//   1. sig_kernel: the sigmas, a block per (g, job), a warp per row j
//      (also the next step's sigmas and the final ones);
//   2. gr_kernel: every row's G_r at once, per job the (d x G) coefficients
//      beta_g / sigma_gr times the (G x d^2) scatters, a tiled float64
//      product on the FP64 pipes into a (J, d, d, d) stack in device memory
//      (27 MB at d = 150, held in L2);
//   3. gr_lu_kernel: the LU factors of every G_r at once, a block per
//      (job, r), in shared memory while d^2 doubles fit, in place in device
//      memory past that;
//   4. sweep_kernel: the rows in order, a block per job.  A fresh LU of A
//      (LAPACK getf2's right-looking LU with partial pivoting, the first
//      largest |pivot| winning, by the whole block; lu_block) gives det A
//      and inv(A) at the step's start; then per row the cofactor in the
//      JAX package's two steps (det times a column of the inverse, so the
//      clamp sees the same magnitude), u from G_r's stored factors (warp
//      solves, getrs order), the new row, and Sherman and Morrison's
//      rank-one update of inv(A) and det A for the changed row: O(d^2)
//      work over the block and three barriers, where a fresh LU a row (the
//      twin's arithmetic) is a chain of d pivot steps, each a warp
//      reduction and a block barrier deep.  The updates start afresh from
//      an LU every outer step, and the step ends with a fresh LU of the new
//      A for aux's det;
//   5. aux_kernel: aux from that det and the new sigmas.
// In the sweep, inv(A) sits in shared memory while a d x d matrix fits
// (d <= 160), then also G_r's factors (staged by cp.async while the
// cofactor is formed; d <= 118) and A's LU (d <= 96); past that they stay
// in device memory, the same code on other addresses (a template
// instantiation for each placement, so that shared-memory accesses are
// compiled as such).  Shared rows are padded to an odd stride, so a
// column's reads take distinct banks.
//
// Bound: operations (per outer step about 4 G d^3 float64 operations for
// G_r and the sigmas, 2/3 d^4 for G_r's LUs, ~4 d^3 for the sweep); the
// sweep is a chain of d rows, each a chain of ~2d dependent solve steps,
// so it is latency-bound at small d.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int BM = 32, BN = 64, BK = 16;      // gr_kernel's tile

__device__ __forceinline__ double floor_sig(double s) {
  return (s > 1e-10 || isnan(s)) ? s : 1e-10;   // jnp.maximum(s, 1e-10)
}

// an 8-byte asynchronous copy to shared memory
__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The multiplier of a pivot column entry x, by LAPACK getf2's rule: times
// the pivot's reciprocal rp, divided where |pivot| is below the smallest
// normal (`tiny`), left as it is where the pivot is 0 (rp is then 1).
// Both conditions are the same for the whole block.
__device__ __forceinline__ double scaled(double x, double pv, double rp,
                                         bool tiny) {
  if (tiny) return x / pv;
  return x * rp;
}

// LU with partial pivoting of the n x n row-major M (row stride ld; shared
// or device memory), in place, by the whole block, one barrier a pivot
// step.  Rows are pivoted through a permutation: `perm` (shared, 2n ints)
// holds two copies, the one a step reads and the one it writes (the step's
// swap and the previous step's), and the returned pointer is the final
// one: logical row i of L\U is row ret[i] of M.  Every warp finds the
// pivot itself (the first largest |value| of the column, as LAPACK's
// idamax: a max over the warp, then the least row index holding it), then
// the block updates the trailing matrix, a row to a group of threads, each
// thread loading a batch of rows before it stores them (M's rows may
// alias, so a store would order every later load behind it); the column's
// multipliers are written a step late (step k writes column k - 1), so
// that no warp still searching column k reads a scaled value.  `sign` gets
// the permutation's sign.  Inlined into kernels whose M provably lies in
// shared memory, the accesses are shared-memory ones.
__device__ __forceinline__ const int* lu_block(double* M, int n, int ld,
                                               int* perm, double* sign) {
  const int tid = threadIdx.x, lane = tid & 31, nth = blockDim.x;
  for (int i = tid; i < n; i += nth) perm[i] = perm[n + i] = i;
  __syncthreads();
  int swaps = 0, pprev = 0;
  double pvp = 1.0, rpp = 1.0;
  bool tinyp = false;
  for (int k = 0; k < n; ++k) {
    const int* cur = perm + (k & 1) * n;
    int* nxt = perm + ((k + 1) & 1) * n;
    double best = -1.0;
    int bi = k;
#pragma unroll 2
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(M[(size_t)cur[i] * ld + k]);
      if (v > best) {
        best = v;
        bi = i;
      }
    }
    double mx = best;
    for (int o = 16; o > 0; o >>= 1)
      mx = fmax(mx, __shfl_xor_sync(FULL, mx, o));
    const int p = (int)__reduce_min_sync(
        FULL, (unsigned)(best == mx ? bi : 0x7fffffff));
    const int Pk = cur[p], Ck = cur[k];
    if (tid == 0) {
      if (k > 0) {
        nxt[k - 1] = cur[k - 1];
        nxt[pprev] = cur[pprev];
      }
      nxt[k] = Pk;
      nxt[p] = Ck;
    }
    swaps += p != k;
    const double* prow = M + (size_t)Pk * ld;
    const double pv = prow[k];
    const double rp = pv == 0.0 ? 1.0 : 1.0 / pv;
    const bool tiny = pv != 0.0 && fabs(pv) < 2.2250738585072014e-308;
    // the trailing (m x m) update: a row to 2^lg threads (the fewest of
    // 4, 8, 16, 32 that span m columns), two columns and up to four rows
    // of a thread at a time
    const int m = n - k - 1;
    if (m > 0) {
      const int lg = m > 16 ? 5 : m > 8 ? 4 : m > 4 ? 3 : 2;
      const int cw = 1 << lg, rs = nth >> lg;
      for (int c0 = k + 1 + (tid & (cw - 1)); c0 < n; c0 += 2 * cw) {
        const int c1 = c0 + cw;
        const bool h1 = c1 < n;
        const double p0 = prow[c0], p1 = h1 ? prow[c1] : 0.0;
        for (int i0 = k + 1 + (tid >> lg); i0 < n; i0 += 4 * rs) {
          double* rw[4];
          double x[4], a0[4], a1[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * rs;
            rw[u] = i < n ? M + (size_t)(i == p ? Ck : cur[i]) * ld : nullptr;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (rw[u]) {
              x[u] = rw[u][k];
              a0[u] = rw[u][c0];
              a1[u] = h1 ? rw[u][c1] : 0.0;
            }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (rw[u]) {
              const double l = scaled(x[u], pv, rp, tiny);
              rw[u][c0] = fma(-l, p0, a0[u]);
              if (h1) rw[u][c1] = fma(-l, p1, a1[u]);
            }
        }
      }
    }
    // the previous column's multipliers, rows k.. (no warp reads it now)
    if (k > 0)
      for (int i = k + tid; i < n; i += nth) {
        double* row = M + (size_t)(i == k ? Pk : i == p ? Ck : cur[i]) * ld;
        row[k - 1] = scaled(row[k - 1], pvp, rpp, tinyp);
      }
    pprev = p;
    pvp = pv;
    rpp = rp;
    tinyp = tiny;
    __syncthreads();
  }
  *sign = (swaps & 1) ? -1.0 : 1.0;
  return perm + (n & 1) * n;
}

// det of lu's factors from its sign, by warp 0: the lanes' products of the
// diagonal, multiplied across the warp
__device__ __forceinline__ double lu_det(const double* M, int n, int ld,
                                         const int* perm, double sign) {
  const int lane = threadIdx.x & 31;
  double part = 1.0;
  for (int i = lane; i < n; i += 32) part *= M[(size_t)perm[i] * ld + i];
  for (int o = 16; o > 0; o >>= 1) part *= __shfl_xor_sync(FULL, part, o);
  return sign * part;
}

// v[q] at a run-time q, by selects (v stays in registers)
template <int N>
__device__ __forceinline__ double pick(const double (&v)[N], int q) {
  double r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i == q) r = v[i];
  return r;
}

// Solve with lu_block's factors (row stride ld) by one warp: y (shared, n)
// holds b's rows in the factors' order (y[i] = b[perm[i]]) on entry and
// the solution on return.  Forward substitution with the unit lower
// triangle, then back substitution with the upper, column by column
// (getrs), by the reciprocals of U's diagonal formed ahead of the chain
// (as optimised trsm kernels do); lane l keeps rows l, l + 32, ... (n <=
// 32 NR) in registers, and each step's value goes round the warp by a
// shuffle.
template <int NR>
__device__ __forceinline__ void lu_solve_reg(const double* M, int n, int ld,
                                             const int* perm, double* y) {
  const int lane = threadIdx.x & 31;
  double v[NR], rd[NR];
  const double* row[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int i = lane + 32 * q;
    v[q] = i < n ? y[i] : 0.0;
    row[q] = M + (size_t)(i < n ? perm[i] : 0) * ld;
    rd[q] = i < n ? 1.0 / row[q][i] : 0.0;
  }
  for (int k = 0; k < n; ++k) {
    const double yk = __shfl_sync(FULL, pick(v, k >> 5), k & 31);
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int i = lane + 32 * q;
      if (i > k && i < n) v[q] = fma(-yk, row[q][k], v[q]);
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    const int q0 = k >> 5;
    const double yk =
        __shfl_sync(FULL, pick(v, q0) * pick(rd, q0), k & 31);
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int i = lane + 32 * q;
      if (i == k) v[q] = yk;
      if (i < k) v[q] = fma(-yk, row[q][k], v[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int i = lane + 32 * q;
    if (i < n) y[i] = v[q];
  }
  __syncwarp();
}

// The same for any n, the vector in shared memory.
__device__ __forceinline__ void lu_solve_smem(const double* M, int n, int ld,
                                              const int* perm, double* y) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < n; ++k) {
    __syncwarp();
    const double yk = y[k];
    for (int i = k + 1 + lane; i < n; i += 32)
      y[i] = fma(-yk, M[(size_t)perm[i] * ld + k], y[i]);
  }
  for (int k = n - 1; k >= 0; --k) {
    __syncwarp();
    const double yk = y[k] * (1.0 / M[(size_t)perm[k] * ld + k]);
    __syncwarp();
    if (lane == 0) y[k] = yk;
    for (int i = lane; i < k; i += 32)
      y[i] = fma(-yk, M[(size_t)perm[i] * ld + k], y[i]);
  }
  __syncwarp();
}

__device__ __forceinline__ void lu_solve(const double* M, int n, int ld,
                                         const int* perm, double* y) {
  if (n <= 64)
    lu_solve_reg<2>(M, n, ld, perm, y);
  else if (n <= 256)
    lu_solve_reg<8>(M, n, ld, perm, y);
  else
    lu_solve_smem(M, n, ld, perm, y);
}

__global__ void identity_kernel(double* A, int d) {
  const size_t dd = (size_t)d * d;
  double* a = A + blockIdx.x * dd;
  for (size_t e = threadIdx.x; e < dd; e += blockDim.x)
    a[e] = (e / d == e % d) ? 1.0 : 0.0;
}

// sig[job, g, j] = max(a_j^T W_g a_j, 1e-10): a block per (g, job), a warp
// per row j: its lanes take columns c of (A W_g)[j, c] and the row dot.
__global__ void __launch_bounds__(256)
sig_kernel(const double* A, const double* __restrict__ W, int G, int d,
           double* __restrict__ sig) {
  const int g = blockIdx.x, job = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t dd = (size_t)d * d;
  const double* a = A + job * dd;
  const double* w = W + ((size_t)job * G + g) * dd;
  for (int j = warp; j < d; j += nw) {
    const double* aj = a + (size_t)j * d;
    double part = 0.0;
    for (int c = lane; c < d; c += 32) {
      double t = 0.0;
      for (int k = 0; k < d; ++k) t = fma(aj[k], w[(size_t)k * d + c], t);
      part = fma(t, aj[c], part);
    }
    part = warp_sum(part);
    if (lane == 0) sig[((size_t)job * G + g) * d + j] = floor_sig(part);
  }
}

// Gst[job, r, :] = sum_g (beta_g / sig[job, g, r]) W[job, g, :] for every
// row r at once: a (d x G) by (G x d^2) product a job, BM x BN tiles over
// BK-deep slices in shared memory, 2 x 4 outputs a thread.
__global__ void __launch_bounds__(256)
gr_kernel(const double* __restrict__ betas, const double* __restrict__ sig,
          const double* __restrict__ W, int G, int d,
          double* __restrict__ Gst) {
  __shared__ double As[BK][BM], Bs[BK][BN];
  const size_t dd = (size_t)d * d;
  const int job = blockIdx.z;
  const size_t n0 = (size_t)blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const double* Wj = W + (size_t)job * G * dd;
  const double* sj = sig + (size_t)job * G * d;
  double acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  for (int g0 = 0; g0 < G; g0 += BK) {
    for (int e = tid; e < BK * BM; e += 256) {
      const int kk = e / BM, m = e % BM, g = g0 + kk, r = r0 + m;
      As[kk][m] = (g < G && r < d) ? betas[g] / sj[(size_t)g * d + r] : 0.0;
    }
    for (int e = tid; e < BK * BN; e += 256) {
      const int kk = e / BN, nn = e % BN, g = g0 + kk;
      const size_t n = n0 + nn;
      Bs[kk][nn] = (g < G && n < dd) ? Wj[(size_t)g * dd + n] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i;
      const size_t n = n0 + tx + 16 * j;
      if (r < d && n < dd) Gst[((size_t)job * d + r) * dd + n] = acc[i][j];
    }
}

// LU of every G_r, a block per (r, job): in shared memory (rows padded to
// an odd stride, so a column's reads take distinct banks) when SH, else in
// place in device memory; the factors back into the stack and the
// permutation into gperm[job, r, :].
template <bool SH>
__global__ void __launch_bounds__(512)
gr_lu_kernel(double* Gst, int d, int* __restrict__ gperm) {
  extern __shared__ double sm[];
  const size_t dd = (size_t)d * d;
  const int r = blockIdx.x, job = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int ld = SH ? (d | 1) : d;
  double* g = Gst + ((size_t)job * d + r) * dd;
  double* M = SH ? sm : g;
  int* perm = reinterpret_cast<int*>(sm + (SH ? (size_t)d * ld : 0));
  if (SH) {
    for (int i = warp; i < d; i += nw)
      for (int c = lane; c < d; c += 32) M[(size_t)i * ld + c] = g[(size_t)i * d + c];
    __syncthreads();
  }
  double sign;
  const int* pf = lu_block(M, d, ld, perm, &sign);
  if (SH)
    for (int i = warp; i < d; i += nw)
      for (int c = lane; c < d; c += 32) g[(size_t)i * d + c] = M[(size_t)i * ld + c];
  int* gp = gperm + ((size_t)job * d + r) * d;
  for (int i = tid; i < d; i += blockDim.x) gp[i] = pf[i];
}

// The row sweep of one outer step, a block per job.  It starts from a
// fresh LU of A: det A and inv(A) (d warp solves).  Per row r: the
// cofactor det(A) inv(A)[:, r]; u from G_r's factors (warp 0); the new row
// a = u sqrt(beta_tot / max(cof.u, 1e-300)); then, with delta = a - A[r],
// z^T = delta^T inv(A) and s = 1 + z_r, Sherman and Morrison's rank-one
// update inv(A) -= inv(A)[:, r] z^T / s and det(A) *= s, so a row costs
// O(d^2) parallel work instead of a fresh LU.  s needs no guard against
// cancelling toward 0: s = (cof . a) / (cof . A[r]), the new det over the
// old, and in exact arithmetic |s| >= 1 (with the old row a_o at the
// step's start, a_o^T G_r a_o = sum_g beta_g sigma_gr / max(sigma_gr,
// 1e-10) <= beta_tot, so by Cauchy and Schwarz in G_r's inner product
// (cof . a_o)^2 <= (cof^T G_r^-1 cof) beta_tot = (cof . a)^2).  Ends with a
// fresh LU of the new A for aux's det.  WHERE: bit 0 inv(A) in shared memory (else AIg),
// bit 1 G_r's factors staged in shared memory (else read from the stack),
// bit 2 A's LU in shared memory (else LAg); shared rows are padded to an
// odd stride.  A itself stays in device memory.
template <int WHERE>
__global__ void __launch_bounds__(512)
sweep_kernel(const double* __restrict__ betas, int G, int d,
             const double* __restrict__ Gst, const int* __restrict__ gperm,
             double* Ag, double* AIg, double* LAg,
             double* __restrict__ detA) {
  constexpr bool AI_SH = WHERE & 1, GR_SH = WHERE & 2, LA_SH = WHERE & 4;
  extern __shared__ double sm[];
  __shared__ double s_btot, s_det;
  const int job = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const size_t dd = (size_t)d * d;
  const int lds = d | 1;
  const size_t ms = (size_t)d * lds;          // a padded matrix
  const int ldI = AI_SH ? lds : d, ldG = GR_SH ? lds : d;
  const int ldL = LA_SH ? lds : d;
  double* AI = AI_SH ? sm : AIg + job * dd;
  double* GR = sm + (AI_SH ? ms : 0);
  double* LA = LA_SH ? sm + (AI_SH ? ms : 0) + (GR_SH ? ms : 0)
                     : LAg + job * dd;
  double* A = Ag + job * dd;
  double* vx = sm + (AI_SH ? ms : 0) + (GR_SH ? ms : 0) + (LA_SH ? ms : 0);
  double* vu = vx + d;            // u, then the new row
  double* w = vu + d;             // inv(A)[:, r] before the update
  double* dl = w + d;             // the new row minus the old
  double* z = dl + d;             // delta^T inv(A)
  double* yw = z + d;             // a solve vector a warp (nw x d)
  int* perm = reinterpret_cast<int*>(yw + (size_t)nw * d);   // 2d
  int* gp = perm + 2 * d;

  if (tid == 0) {
    double s = 0.0;
    for (int g = 0; g < G; ++g) s += betas[g];
    s_btot = s;
  }
  // det A and inv(A), from a fresh LU
  for (int i = warp; i < d; i += nw)
    for (int c = lane; c < d; c += 32)
      LA[(size_t)i * ldL + c] = A[(size_t)i * d + c];
  __syncthreads();
  double sg;
  const int* pa = lu_block(LA, d, ldL, perm, &sg);
  if (warp == 0) {
    const double det = lu_det(LA, d, ldL, pa, sg);
    if (lane == 0) s_det = det;
  }
  for (int j = warp; j < d; j += nw) {
    double* y = yw + (size_t)warp * d;
    for (int i = lane; i < d; i += 32) y[i] = pa[i] == j ? 1.0 : 0.0;
    __syncwarp();
    lu_solve(LA, d, ldL, pa, y);
    for (int i = lane; i < d; i += 32) AI[(size_t)i * ldI + j] = y[i];
    __syncwarp();
  }
  __syncthreads();
  const double* Gj = Gst + (size_t)job * d * dd;
  for (int r = 0; r < d; ++r) {
    const double* Gr = Gj + (size_t)r * dd;
    if (GR_SH) {
      for (int i = warp; i < d; i += nw)
        for (int c = lane; c < d; c += 32)
          copy8(GR + (size_t)i * ldG + c, Gr + (size_t)i * d + c);
      copy_commit();
    }
    const double det = s_det;
    for (int i = tid; i < d; i += nth) {
      gp[i] = gperm[((size_t)job * d + r) * d + i];
      const double a = AI[(size_t)i * ldI + r];
      w[i] = a;
      vx[i] = det * a;                        // the cofactor
    }
    if (GR_SH) copy_wait_all();
    __syncthreads();
    if (warp == 0) {
      for (int i = lane; i < d; i += 32) vu[i] = vx[gp[i]];
      __syncwarp();
      if (GR_SH)
        lu_solve(GR, d, ldG, gp, vu);
      else
        lu_solve(Gr, d, ldG, gp, vu);
      double part = 0.0;
      for (int i = lane; i < d; i += 32) part += vx[i] * vu[i];
      const double dot = warp_sum(part);
      const double den = (dot > 1e-300 || isnan(dot)) ? dot : 1e-300;
      const double scale = sqrt(s_btot / den);
      for (int c = lane; c < d; c += 32) {
        const double a = vu[c] * scale;
        dl[c] = a - A[(size_t)r * d + c];
        A[(size_t)r * d + c] = a;
      }
    }
    __syncthreads();
    for (int j = tid; j < d; j += nth) {
      double s0 = 0.0, s1 = 0.0;
      int i = 0;
      for (; i + 1 < d; i += 2) {
        s0 = fma(dl[i], AI[(size_t)i * ldI + j], s0);
        s1 = fma(dl[i + 1], AI[(size_t)(i + 1) * ldI + j], s1);
      }
      if (i < d) s0 = fma(dl[i], AI[(size_t)i * ldI + j], s0);
      z[j] = s0 + s1;
    }
    __syncthreads();
    const double sr = 1.0 + z[r];
    for (int j = lane; j < d; j += 32) {
      const double zj = z[j] / sr;
      for (int i = warp; i < d; i += nw)
        AI[(size_t)i * ldI + j] = fma(-w[i], zj, AI[(size_t)i * ldI + j]);
    }
    if (tid == 0) s_det = det * sr;
    __syncthreads();
  }
  // det of the new A, from a fresh LU
  for (int i = warp; i < d; i += nw)
    for (int c = lane; c < d; c += 32)
      LA[(size_t)i * ldL + c] = A[(size_t)i * d + c];
  __syncthreads();
  pa = lu_block(LA, d, ldL, perm, &sg);
  if (warp == 0) {
    const double det = lu_det(LA, d, ldL, pa, sg);
    if (lane == 0) detA[job] = det;
  }
}

// aux[job, it] = beta_tot log|det A| - 0.5 sum_g beta_g sum_j log sig_gj
__global__ void __launch_bounds__(256)
aux_kernel(const double* __restrict__ betas, const double* __restrict__ sig,
           int G, int d, const double* __restrict__ detA,
           double* __restrict__ aux, int it, int n_iter) {
  __shared__ double red[32];
  const int job = blockIdx.x;
  const double* s = sig + (size_t)job * G * d;
  double part = 0.0;
  for (int e = threadIdx.x; e < G * d; e += blockDim.x)
    part += betas[e / d] * log(s[e]);
  const double tot = block_sum(part, red);
  if (threadIdx.x == 0) {
    double bt = 0.0;
    for (int g = 0; g < G; ++g) bt += betas[g];
    aux[(size_t)job * n_iter + it] = bt * log(fabs(detA[job])) - 0.5 * tot;
  }
}

}  // namespace

// work: the G_r stack (J, d, d, d), inv(A) and A's LU scratch (J, d, d)
// each and det A (J) in doubles; iwork: G_r's permutations (J, d, d) in
// ints.
extern "C" int semitied_launch(const double* betas, const double* scat,
                               int J, int G, int d, int n_iter, double* A,
                               double* sig, double* aux, double* work,
                               int* iwork, cudaStream_t st) {
  if (J <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  const size_t dd = (size_t)d * d;
  double* Gst = work;
  double* AIg = Gst + (size_t)J * d * dd;
  double* LAg = AIg + (size_t)J * dd;
  double* detA = LAg + (size_t)J * dd;
  const int nt = d <= 64 ? 256 : 512;
  // shared memory: the sweep's vectors, then inv(A), G_r's factors and A's
  // LU while each fits (rows padded to an odd stride); an LU of G_r's
  // matrix and permutation
  const size_t ms = sizeof(double) * (size_t)d * (d | 1);
  size_t sw = sizeof(double) * (5 + nt / 32) * (size_t)d
      + sizeof(int) * 3 * (size_t)d;
  int where = 0;
  for (int bit = 1; bit <= 4; bit <<= 1)
    if (sw + ms <= MAX_SMEM) {
      where |= bit;
      sw += ms;
    }
  const size_t lu_idx = sizeof(int) * 2 * (size_t)d;
  const bool lu_sm = lu_idx + ms <= MAX_SMEM;
  const size_t slu = lu_idx + (lu_sm ? ms : 0);
  void (*sweep)(const double*, int, int, const double*, const int*, double*,
                double*, double*, double*) =
      where == 7 ? sweep_kernel<7> : where == 3 ? sweep_kernel<3>
      : where == 1 ? sweep_kernel<1> : sweep_kernel<0>;
  void (*grlu)(double*, int, int*) =
      lu_sm ? gr_lu_kernel<true> : gr_lu_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sw);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(grlu,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)slu);
  if (e != cudaSuccess) return (int)e;
  identity_kernel<<<J, 256, 0, st>>>(A, d);
  const dim3 gs(G, J);
  sig_kernel<<<gs, 256, 0, st>>>(A, scat, G, d, sig);
  const dim3 gg((unsigned)((dd + BN - 1) / BN), (d + BM - 1) / BM, J);
  for (int it = 0; it < n_iter; ++it) {
    gr_kernel<<<gg, 256, 0, st>>>(betas, sig, scat, G, d, Gst);
    grlu<<<dim3(d, J), nt, slu, st>>>(Gst, d, iwork);
    sweep<<<J, nt, sw, st>>>(betas, G, d, Gst, iwork, A, AIg, LAg, detA);
    sig_kernel<<<gs, 256, 0, st>>>(A, scat, G, d, sig);
    aux_kernel<<<J, 256, 0, st>>>(betas, sig, G, d, detA, aux, it, n_iter);
  }
  return (int)cudaGetLastError();
}
