// K39: a batched real forward DFT, rows x (R, L) zero-padded to N points
// -> the N/2+1 bins of rfft(x, N).
//
// Replaces hts_train_world_tpu/ops/fftmat.py:46-83,171-176 (rfft_matmul,
// rfft_power_matmul) and the forward half of :122-155 (minphase_mats):
// on the TPU every per-frame and per-pulse DFT up to 4096 points ran as a
// matmul against cos/sin tables (MATMUL_FFT_LIMIT, :38-43), since XLA's
// TPU FFT ran ~4x off the MXU's pace.  On the H100 those products are
// float32 SGEMMs on the FMA pipes doing O(L N) work a row; this is an
// FFT, O(N log N) a row.
//
// Modes:
//   0 reim:  planar Re and Im (R, N/2+1) (rfft_matmul);
//   1 power: Re^2 + Im^2 (R, N/2+1) (rfft_power_matmul);
//   2 fold:  reim of the input scaled by w_n / N at load, w = 1 at n = 0
//            and n = N/2, else 2 (the cepstral fold of the minimum-phase
//            log spectrum; its first half is K40's half output).
// Design: one block a row.  The row is read once into shared memory as
// z_m = x_2m + i x_2m+1 (the real row's own layout), an N/2-point complex
// FFT runs there in float64 (fft_stockham.cuh, which says why float64),
// and the split X_k = (Z_k + conj Z_{M-k}) / 2 - i W_N^k (Z_k -
// conj Z_{M-k}) / 2, k = 0..N/2, writes each bin once, rounded once to
// the rows' type.  Shared memory: N/2 double2, 8 N bytes (N = 4096: 32
// KB; N = 8192 opts in to 64 KB).  --fmad=false: the butterflies round
// unfused.
//
// Bound: bytes.  Each input word is read once and each output word
// written once; the ~2.5 N log2 N float64 operations a row take less than
// the bytes' time at these sizes.
//
// A template on float and double rows; N a power of two in [64, 8192],
// L <= N.
#include "common.cuh"
#include "fft_stockham.cuh"

namespace {

enum { REIM = 0, POWER = 1, FOLD = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(fft::MAX_THREADS)
fft_r2c_kernel(const T* __restrict__ x, int L, int N,
               const double2* __restrict__ tw, T* __restrict__ out0,
               T* __restrict__ out1) {
  extern __shared__ __align__(16) unsigned char smem[];
  double2* z = reinterpret_cast<double2*>(smem);
  double* s = reinterpret_cast<double*>(smem);
  const int M = N >> 1;
  const T* row = x + (size_t)blockIdx.x * L;
  const double inv_n = 1.0 / N;           // exact: N is a power of two
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    double v = n < L ? (double)row[n] : 0.0;
    if (MODE == FOLD) v = v * ((n == 0 || n == M) ? inv_n : 2.0 * inv_n);
    s[n] = v;
  }
  __syncthreads();
  fft::stockham<false>(z, M, N, tw);
  const int H = M + 1;
  T* o0 = out0 + (size_t)blockIdx.x * H;
  T* o1 = MODE == POWER ? nullptr : out1 + (size_t)blockIdx.x * H;
  for (int k = threadIdx.x; k <= M; k += blockDim.x) {
    const double2 a = z[k & (M - 1)], b = z[(M - k) & (M - 1)];
    // E = (A + conj B) / 2, O = (A - conj B) / (2 i)
    const double er = (a.x + b.x) * 0.5, ei = (a.y - b.y) * 0.5;
    double2 o = make_double2((a.y + b.y) * 0.5, -((a.x - b.x) * 0.5));
    fft::turn<false>(o, tw, k);
    const double xr = er + o.x, xi = ei + o.y;
    if (MODE == POWER) {
      o0[k] = (T)(xr * xr + xi * xi);
    } else {
      o0[k] = (T)xr;
      o1[k] = (T)xi;
    }
  }
}

template <typename T, int MODE>
int launch_mode(const void* x, int R, int L, int N, const void* tw,
                void* out0, void* out1, cudaStream_t s) {
  const size_t bytes = fft::smem_bytes(N);
  cudaError_t e = fft::allow_smem(fft_r2c_kernel<T, MODE>, bytes);
  if (e != cudaSuccess) return (int)e;
  fft_r2c_kernel<T, MODE><<<R, fft::block_threads(N / 2), bytes, s>>>(
      static_cast<const T*>(x), L, N, static_cast<const double2*>(tw),
      static_cast<T*>(out0), static_cast<T*>(out1));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, int R, int L, int N, int mode, const void* tw,
           void* out0, void* out1, cudaStream_t s) {
  if (!fft::size_ok(N) || L < 1 || L > N || R < 0
      || (mode != POWER && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  switch (mode) {
    case REIM: return launch_mode<T, REIM>(x, R, L, N, tw, out0, out1, s);
    case POWER: return launch_mode<T, POWER>(x, R, L, N, tw, out0, out1, s);
    case FOLD: return launch_mode<T, FOLD>(x, R, L, N, tw, out0, out1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (R, L) contiguous; tw the (N, 2) float64 twiddle table; mode 0
// (out0 = Re, out1 = Im), 1 (out0 = power, out1 unused) or 2 (as 0, on
// the folded input); outputs (R, N/2+1).  f64: 0 for float, 1 for double.
extern "C" int fft_r2c_launch(const void* x, int R, int L, int N, int mode,
                              const void* tw, int f64, void* out0,
                              void* out1, cudaStream_t s) {
  return f64 ? launch<double>(x, R, L, N, mode, tw, out0, out1, s)
             : launch<float>(x, R, L, N, mode, tw, out0, out1, s);
}
