// K38: mel-cepstral analysis (SPTK mcep), the Newton loop inside a block.
//
// Replaces hts_train_world_tpu/ops/sptk.py:103-158 (theq_dense, mcep),
// which on the TPU ran the initial cepstrum (irfft of the log spectrum,
// ends halved, freqt to order m at alpha), then a lax.scan of `itr` Newton
// steps over every frame at once: a freqt product to N/2 at -alpha, an
// rfft, exp, the ratio to the periodogram, an irfft, a frqtr product to
// 2m, the Toeplitz-plus-Hankel system and a batched dense solve.
//
// Each linear chain is folded into one float64 table, read through L2
// (ops/sptk.py mcep_tables): A0 (m+1, N/2+1) for the initial cepstrum,
// Tb (m+1, N/2+1) for freqt then Re rfft, Tr (2m+1, N/2+1) for irfft then
// frqtr.  One block a frame keeps the periodogram, the spectrum, the
// (m+1)^2 system and the cepstrum in shared memory; a step is two skinny
// products (a thread a bin for the spectrum, a warp a lag for r), an exp
// and a divide a bin, the system built from r as sptkfunctions.cpp:130-150
// forms it, and an LU with partial pivoting (the first largest |pivot|, as
// LAPACK's getrf that jnp.linalg.solve calls), then the two triangular
// solves.  The folding changes the rounding order: the kernel is held to
// its twin at 1e-9 of max |mc|.
//
// Bound: operations.  A step's (m+1 + 2m+1)(N/2+1) multiply-adds and
// (m+1)^3 / 3 for the LU, against the log spectrum read and the cepstrum
// written once.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXM1 = 128;

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[j] = sum_k x[k] tab[j F + k] for j < rows: a warp a row
template <typename T>
__device__ void rows_dot(const T* __restrict__ tab, const T* x, int F,
                         int rows, T* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int j = w; j < rows; j += WARPS) {
    T s = (T)0;
    for (int k = lane; k < F; k += 32) s = s + x[k] * tab[(size_t)j * F + k];
    s = warp_sum_t(s);
    if (lane == 0) out[j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mcep_newton_kernel(const T* __restrict__ logp, int F, int m,
                   const T* __restrict__ A0, const T* __restrict__ Tb,
                   const T* __restrict__ Tr, const T* __restrict__ al,
                   int itr, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = m + 1, R = 2 * m + 1;
  T* xh = sm;              // F: the periodogram
  T* buf = xh + F;         // F: the log spectrum, then the ratio
  T* mc = buf + F;         // n
  T* r = mc + n;           // R
  T* rhs = r + R;          // n
  T* A = rhs + n;          // n x n
  __shared__ int piv;
  const int f = blockIdx.x;
  const T* lp = logp + (size_t)f * F;

  for (int k = threadIdx.x; k < F; k += THREADS) {
    buf[k] = lp[k];
    xh[k] = exp(lp[k]);
  }
  __syncthreads();
  rows_dot(A0, buf, F, n, mc);
  __syncthreads();
  for (int it = 0; it < itr; ++it) {
    for (int k = threadIdx.x; k < F; k += THREADS) {
      T s = (T)0;
      for (int j = 0; j < n; ++j) s = s + mc[j] * Tb[(size_t)j * F + k];
      buf[k] = xh[k] / exp((T)2 * s);
    }
    __syncthreads();
    rows_dot(Tr, buf, F, R, r);
    __syncthreads();
    // A = Toeplitz(t) + Hankel(y), rhs = r - al
    for (int e = threadIdx.x; e < n * n; e += THREADS) {
      const int i = e / n, j = e % n;
      const int d = i > j ? i - j : j - i, h = i + j;
      T t = d == 0 ? (T)2 * r[0]
                   : ((d % 2 == 0) ? r[d] + r[0] : r[d]);
      const T y = (h % 2 == 0) ? r[h] - r[0] : r[h];
      A[e] = t + y;
    }
    for (int i = threadIdx.x; i < n; i += THREADS) rhs[i] = r[i] - al[i];
    __syncthreads();
    // LU with partial pivoting, the right side carried along
    for (int k = 0; k < n; ++k) {
      if (threadIdx.x < 32) {
        T best = (T)-1;
        int bi = k;
        for (int i = k + threadIdx.x; i < n; i += 32) {
          const T a = fabs(A[i * n + k]);
          if (a > best) {
            best = a;
            bi = i;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const T ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
        }
        if (threadIdx.x == 0) piv = bi;
      }
      __syncthreads();
      const int p = piv;
      if (p != k) {
        for (int j = threadIdx.x; j <= n; j += THREADS) {
          T* a = j < n ? &A[k * n + j] : &rhs[k];
          T* b = j < n ? &A[p * n + j] : &rhs[p];
          const T tmp = *a;
          *a = *b;
          *b = tmp;
        }
        __syncthreads();
      }
      for (int i = k + 1 + threadIdx.x; i < n; i += THREADS)
        A[i * n + k] = A[i * n + k] / A[k * n + k];
      __syncthreads();
      const int w = n - k;     // columns k+1 .. n-1, then the right side
      for (int e = threadIdx.x; e < (n - k - 1) * w; e += THREADS) {
        const int i = k + 1 + e / w, j = k + 1 + e % w;
        const T l = A[i * n + k];
        if (j < n)
          A[i * n + j] = A[i * n + j] - l * A[k * n + j];
        else
          rhs[i] = rhs[i] - l * rhs[k];
      }
      __syncthreads();
    }
    // back substitution, a column at a time
    for (int i = n - 1; i >= 0; --i) {
      if (threadIdx.x == 0) rhs[i] = rhs[i] / A[i * n + i];
      __syncthreads();
      const T x = rhs[i];
      for (int q = threadIdx.x; q < i; q += THREADS)
        rhs[q] = rhs[q] - A[q * n + i] * x;
      __syncthreads();
    }
    for (int j = threadIdx.x; j < n; j += THREADS) mc[j] = mc[j] + rhs[j];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += THREADS)
    out[(size_t)f * n + j] = mc[j];
}

template <typename T>
int launch(const void* logp, int Tn, int F, int m, const void* A0,
           const void* Tb, const void* Tr, const void* al, int itr, void* out,
           cudaStream_t s) {
  const int n = m + 1;
  const size_t smem =
      (2 * (size_t)F + 2 * n + (2 * m + 1) + (size_t)n * n) * sizeof(T);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mcep_newton_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mcep_newton_kernel<T><<<Tn, THREADS, smem, s>>>(
      (const T*)logp, F, m, (const T*)A0, (const T*)Tb, (const T*)Tr,
      (const T*)al, itr, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// logp (T, F) log spectra, F = N/2 + 1; A0, Tb (m+1, F) and Tr (2m+1, F)
// the folded tables; al (m+1,) = (-alpha)^j; out (T, m+1); f64 picks
// double.
extern "C" int mcep_newton_launch(const void* logp, int T, int F, int m,
                                  const void* A0, const void* Tb,
                                  const void* Tr, const void* al, int itr,
                                  int f64, void* out, cudaStream_t s) {
  if (m < 0 || m + 1 > MAXM1 || F < 2 || itr < 0)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  return f64 ? launch<double>(logp, T, F, m, A0, Tb, Tr, al, itr, out, s)
             : launch<float>(logp, T, F, m, A0, Tb, Tr, al, itr, out, s);
}
