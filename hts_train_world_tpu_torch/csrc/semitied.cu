// K34: Gales' semi-tied covariance update, float64, one block of threads a
// (stream, block) job.
//
// Replaces hts_train_world_tpu/models/hsmm_variants.py:257-294
// (semitied_block): a jitted lax.scan of n_iter outer steps around a
// fori_loop over the d rows, each row an einsum over the G scatters, a
// determinant, an inverse and a solve.  Here one CTA runs one job to the
// end.  Per outer step:
//   sigmas_gj = max(a_j^T W_g a_j, 1e-10)      (fixed for the whole step)
//   for r in 0..d-1, in place (Gauss-Seidel over the rows):
//     G_r = sum_g (beta_g / sigma_gr) W_g
//     cof = det(A) * inv(A)[:, r]              (LU of A, partial pivoting)
//     u   = G_r^-1 cof                         (LU of G_r, partial pivoting)
//     row r of A = u * sqrt(beta_tot / max(cof . u, 1e-300))
//   aux = beta_tot log|det A| - 0.5 sum_g beta_g sum_j log sigma'_gj,
//   sigma' the sigmas of the new A (the next step's).
// The cofactor keeps the JAX package's two steps (det times a column of
// the inverse, not one solve scaled afterwards), so the clamp sees the
// same magnitude.  Both factorisations are LAPACK getrf's right-looking
// LU with partial pivoting (the first largest |pivot| wins), det the
// product of U's diagonal times the permutation's sign.
//
// Layout: A, a d x d work matrix (A's LU, or A W_g while the sigmas are
// formed) and G_r (or W_g) in shared memory, with the G coefficients, four
// d-vectors and the pivots; the scatters (J, G, d, d) stay in device memory
// (4 MB at G = 200, d = 50, read from L2 once per row).  The sums over g
// (G_r, the sigmas) use every thread; the two LUs run at once on warps 0
// and 1 (a chain of d dependent steps each, synchronised by __syncwarp),
// then warp 0 solves and writes the row.
//
// Bound: operations (per outer step about 4 G d^3 float64 operations for
// G_r and the sigmas and 4/3 d^4 for the LUs), but the d dependent rows,
// each a chain of 2d pivot steps, and one SM a job make it latency-bound.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// LU with partial pivoting of the n x n row-major M, in place, by one warp:
// piv[k] the row swapped with k at step k; returns the permutation's sign.
__device__ double lu_warp(double* M, int n, int* piv) {
  const int lane = threadIdx.x & 31;
  double sign = 1.0;
  for (int k = 0; k < n; ++k) {
    double best = -1.0;
    int bi = n;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(M[i * n + k]);
      if (v > best) {
        best = v;
        bi = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    const int p = __shfl_sync(0xffffffffu, bi, 0);
    if (lane == 0) piv[k] = p;
    if (p != k) {
      for (int c = lane; c < n; c += 32) {
        const double t = M[k * n + c];
        M[k * n + c] = M[p * n + c];
        M[p * n + c] = t;
      }
      sign = -sign;
    }
    __syncwarp();
    const double pv = M[k * n + k];
    if (pv != 0.0)
      for (int i = k + 1 + lane; i < n; i += 32) M[i * n + k] /= pv;
    __syncwarp();
    const int m = n - k - 1;
    for (int e = lane; e < m * m; e += 32) {
      const int i = k + 1 + e / m, c = k + 1 + e % m;
      M[i * n + c] -= M[i * n + k] * M[k * n + c];
    }
    __syncwarp();
  }
  return sign;
}

// Solve (LU) x = P b in place in b by one warp (getrs: the interchanges in
// order, then the unit-lower and the upper triangle, column by column).
__device__ void lu_solve_warp(const double* M, int n, const int* piv,
                              double* b) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    for (int k = 0; k < n; ++k) {
      const int p = piv[k];
      if (p != k) {
        const double t = b[k];
        b[k] = b[p];
        b[p] = t;
      }
    }
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    const double bk = b[k];
    for (int i = k + 1 + lane; i < n; i += 32) b[i] -= bk * M[i * n + k];
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    if (lane == 0) b[k] /= M[k * n + k];
    __syncwarp();
    const double bk = b[k];
    for (int i = lane; i < k; i += 32) b[i] -= bk * M[i * n + k];
    __syncwarp();
  }
}

__device__ __forceinline__ double floor_sig(double s) {
  return (s > 1e-10 || isnan(s)) ? s : 1e-10;   // jnp.maximum(s, 1e-10)
}

// sig[g, j] = max(a_j^T W_g a_j, 1e-10) for every g, by the whole block:
// W_g into Wt, A W_g into T, then the row dots.
__device__ void diag_sig(const double* A, const double* W, int G, int d,
                         double* Wt, double* T, double* sig) {
  const int dd = d * d;
  for (int g = 0; g < G; ++g) {
    const double* Wg = W + (size_t)g * dd;
    for (int e = threadIdx.x; e < dd; e += blockDim.x) Wt[e] = Wg[e];
    __syncthreads();
    for (int e = threadIdx.x; e < dd; e += blockDim.x) {
      const int j = e / d, c = e % d;
      double s = 0.0;
      for (int a = 0; a < d; ++a) s += A[j * d + a] * Wt[a * d + c];
      T[e] = s;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      double s = 0.0;
      for (int c = 0; c < d; ++c) s += T[j * d + c] * A[j * d + c];
      sig[(size_t)g * d + j] = floor_sig(s);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
semitied_kernel(const double* __restrict__ betas,
                const double* __restrict__ scat, int G, int d, int n_iter,
                double* __restrict__ A_out, double* __restrict__ sig_out,
                double* __restrict__ aux_out) {
  extern __shared__ double sm[];
  const int dd = d * d;
  double* A = sm;
  double* L = A + dd;          // A's LU; A W_g in diag_sig
  double* Gr = L + dd;         // G_r and its LU; W_g in diag_sig
  double* coef = Gr + dd;      // G
  double* cof = coef + G;      // d
  double* u = cof + d;         // d
  double* red = u + 2 * d;     // 64
  int* pivA = reinterpret_cast<int*>(red + 64);
  int* pivG = pivA + d;
  __shared__ double beta_tot, detA;

  const int job = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const double* W = scat + (size_t)job * G * dd;
  double* sig = sig_out + (size_t)job * G * d;

  if (tid == 0) {
    double s = 0.0;
    for (int g = 0; g < G; ++g) s += betas[g];
    beta_tot = s;
  }
  for (int e = tid; e < dd; e += blockDim.x)
    A[e] = (e / d == e % d) ? 1.0 : 0.0;
  __syncthreads();
  diag_sig(A, W, G, d, Gr, L, sig);

  for (int it = 0; it < n_iter; ++it) {
    for (int r = 0; r < d; ++r) {
      for (int g = tid; g < G; g += blockDim.x)
        coef[g] = betas[g] / sig[(size_t)g * d + r];
      __syncthreads();
      for (int e = tid; e < dd; e += blockDim.x) {
        double s = 0.0;
        for (int g = 0; g < G; ++g) s += coef[g] * W[(size_t)g * dd + e];
        Gr[e] = s;
        L[e] = A[e];
      }
      __syncthreads();
      if (warp == 0) {
        const double sg = lu_warp(L, d, pivA);
        if (lane == 0) {
          double det = sg;
          for (int k = 0; k < d; ++k) det *= L[k * d + k];
          detA = det;
        }
        for (int i = lane; i < d; i += 32) cof[i] = i == r ? 1.0 : 0.0;
        __syncwarp();
        lu_solve_warp(L, d, pivA, cof);       // column r of inv(A)
        for (int i = lane; i < d; i += 32) cof[i] *= detA;
      } else if (warp == 1) {
        lu_warp(Gr, d, pivG);
      }
      __syncthreads();
      if (warp == 0) {
        for (int i = lane; i < d; i += 32) u[i] = cof[i];
        __syncwarp();
        lu_solve_warp(Gr, d, pivG, u);
        double dot = 0.0;
        for (int i = 0; i < d; ++i) dot += cof[i] * u[i];
        const double den = (dot > 1e-300 || isnan(dot)) ? dot : 1e-300;
        const double scale = sqrt(beta_tot / den);
        for (int c = lane; c < d; c += 32) A[r * d + c] = u[c] * scale;
      }
      __syncthreads();
    }
    diag_sig(A, W, G, d, Gr, L, sig);
    for (int e = tid; e < dd; e += blockDim.x) L[e] = A[e];
    __syncthreads();
    if (warp == 0) {
      const double sg = lu_warp(L, d, pivA);
      if (lane == 0) {
        double det = sg;
        for (int k = 0; k < d; ++k) det *= L[k * d + k];
        detA = det;
      }
    }
    double part = 0.0;
    for (int e = tid; e < G * d; e += blockDim.x)
      part += betas[e / d] * log(sig[e]);
    const double tot = block_sum(part, red);   // synchronises the block
    if (tid == 0)
      aux_out[(size_t)job * n_iter + it] =
          beta_tot * log(fabs(detA)) - 0.5 * tot;
  }
  for (int e = tid; e < dd; e += blockDim.x)
    A_out[(size_t)job * dd + e] = A[e];
}

}  // namespace

extern "C" int semitied_launch(const double* betas, const double* scat,
                               int J, int G, int d, int n_iter, double* A,
                               double* sig, double* aux, cudaStream_t st) {
  if (J <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(double) * (3 * (size_t)d * d + G + 4 * d + 64)
      + sizeof(int) * 2 * d;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        semitied_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  semitied_kernel<<<J, THREADS, smem, st>>>(betas, scat, G, d, n_iter, A,
                                            sig, aux);
  return (int)cudaGetLastError();
}
