// K40: a batched inverse of half spectra in the WORLD convention,
// unnormalised: (Re, Im) (R, N/2+1) -> irfft(X) * N, its first n_out
// samples (n_out = N, or N/2+1).
//
// Replaces hts_train_world_tpu/ops/fftmat.py:86-108 (irfft_scaled_matmul,
// irfft(X) * N as two matmuls against w_k cos / -w_k sin tables),
// :158-168 (sym_rfft_real_mat, irfft_half_mats: CheapTrick's cepstrum and
// its inverse, the first N/2+1 samples of the same c2r; the first is
// Re rfft of the mirrored row, which equals it) and the inverse half of
// :122-155 (minphase_mats: the cepstrum of the log half spectrum, then
// K39's fold).  The TPU ran them as MXU matmuls (MATMUL_FFT_LIMIT); on the
// H100 those were float32 SGEMMs, O(N^2) a row.
//
// Design: one block a row, the inverse of K39's split.  Each thread forms
// Z_k = (X_k + conj X_{M-k}) + i W_N^-k (X_k - conj X_{M-k}) for k < M =
// N/2 from the two bins it reads (Im X_0 and Im X_{N/2} are taken as 0,
// as the tables' sin rows are), the inverse unnormalised N/2-point FFT
// runs in shared memory in float64 (fft_stockham.cuh), and the result,
// z_m = y_2m + i y_2m+1 with y = irfft(X) * N, is the output row's own
// layout: its first n_out words are written once, rounded once to the
// rows' type.  Im may be null (zero).  Shared memory as K39's: 8 N bytes.
//
// Bound: bytes (the two input arrays read once, the output written once).
//
// A template on float and double rows; N a power of two in [64, 8192].
#include "common.cuh"
#include "fft_stockham.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fft::MAX_THREADS)
fft_c2r_kernel(const T* __restrict__ re, const T* __restrict__ im, int N,
               int n_out, const double2* __restrict__ tw,
               T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double2* z = reinterpret_cast<double2*>(smem);
  const double* s = reinterpret_cast<const double*>(smem);
  const int M = N >> 1, H = M + 1;
  const T* rr = re + (size_t)blockIdx.x * H;
  const T* ir = im ? im + (size_t)blockIdx.x * H : nullptr;
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const int k2 = M - k;
    const double ar = rr[k], ai = (ir && k) ? (double)ir[k] : 0.0;
    const double br = rr[k2], bi = (ir && k2 < M) ? -(double)ir[k2] : 0.0;
    double2 d = make_double2(ar - br, ai - bi);
    fft::turn<true>(d, tw, k);                 // W_N^-k (A - B)
    z[k] = make_double2((ar + br) - d.y,       // + i W_N^-k (A - B)
                        (ai + bi) + d.x);
  }
  __syncthreads();
  fft::stockham<true>(z, M, N, tw);
  T* o = out + (size_t)blockIdx.x * n_out;
  for (int n = threadIdx.x; n < n_out; n += blockDim.x) o[n] = (T)s[n];
}

template <typename T>
int launch(const void* re, const void* im, int R, int N, int n_out,
           const void* tw, void* out, cudaStream_t s) {
  if (!fft::size_ok(N) || R < 0 || (n_out != N && n_out != N / 2 + 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const size_t bytes = fft::smem_bytes(N);
  cudaError_t e = fft::allow_smem(fft_c2r_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  fft_c2r_kernel<T><<<R, fft::block_threads(N / 2), bytes, s>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), N, n_out,
      static_cast<const double2*>(tw), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// re, im (R, N/2+1) contiguous (im null: zero); tw the (N, 2) float64
// twiddle table; out (R, n_out), n_out = N or N/2+1.  f64: 0 for
// float, 1 for double.
extern "C" int fft_c2r_launch(const void* re, const void* im, int R, int N,
                              int n_out, const void* tw, int f64, void* out,
                              cudaStream_t s) {
  return f64 ? launch<double>(re, im, R, N, n_out, tw, out, s)
             : launch<float>(re, im, R, N, n_out, tw, out, s);
}
