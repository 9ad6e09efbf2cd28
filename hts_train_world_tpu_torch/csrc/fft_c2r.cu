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
// Design: K39's register core (fft_r2c_core.cuh) run backward, as K37's
// frames run it.  A row has M/16 threads (M = N/2), 16 points a thread.
// Each thread reads the bins of its 16 first-pass inputs k = t + i M/16
// and their partners M - k straight from the row (every load issued at
// once), and forms the inverse split in registers, Z_k = (X_k + conj
// X_(M-k)) + i W_N^-k (X_k - conj X_(M-k)) (Im X_0 and Im X_(N/2) taken as
// 0, as the tables' sin rows take them; W_N^-k from the split entries of
// the launch size's table, -W_N^(M-k) past M/2).  The M-point inverse is
// the forward passes on conj Z (radix 16/8, conflict-free exchanges
// through the padded planes, per-pass twiddle tables), whose last pass
// leaves w = conj(z) in registers: z_m = y_2m + i y_2m+1 with y = irfft(X)
// * N, so output r of the last pass's butterfly j is the pair (Re w_m,
// -Im w_m) at samples 2m, 2m+1 (m = j + r M/R): a warp stores 32
// consecutive pairs, and only those below n_out, rounded once to the
// rows' type.  Im may be null (zero).  Float64 inside, as K39.
//
// Bound: bytes (the two input arrays read once, the output written once).
//
// A template on float and double rows and on M; N a power of two in
// [64, 8192].
#include "common.cuh"
#include "fft_r2c_core.cuh"

namespace {

using r2c::C2;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T, int M>
__global__ void __launch_bounds__(r2c::Geometry<M>::THREADS)
fft_c2r_kernel(const T* __restrict__ re, const T* __restrict__ im, int R,
               int n_out, const double2* __restrict__ tw,
               T* __restrict__ out) {
  using G = r2c::Geometry<M>;
  constexpr int P = r2c::P;
  extern __shared__ __align__(16) double smem[];
  const int q = threadIdx.x / G::T, t = threadIdx.x % G::T;
  const long long row = (long long)blockIdx.x * G::RPB + q;
  const bool live = row < R;
  double* sre = smem + (size_t)q * 2 * G::MP;
  double* sim = sre + G::MP;
  const long long at = (live ? row : 0) * (M + 1);
  const T* rr = re + at;
  const T* ir = im ? im + at : nullptr;
  // X_k and X_(M-k) for k = t + i T, all loads in flight together
  T ar[P], br[P], ai[P], bi[P];
#pragma unroll
  for (int i = 0; i < P; i++) {
    const int k = t + i * G::T;
    ar[i] = rr[k];
    br[i] = rr[M - k];
  }
  if (ir) {
#pragma unroll
    for (int i = 0; i < P; i++) {
      const int k = t + i * G::T;
      ai[i] = ir[k];
      bi[i] = ir[M - k];
    }
  }
  C2 v[P];
#pragma unroll
  for (int i = 0; i < P; i++) {
    const int k = t + i * G::T;
    const double xr = ar[i], yr = br[i];
    const double xi = (ir && k) ? (double)ai[i] : 0.0;
    const double yi = (ir && k) ? (double)bi[i] : 0.0;   // k = 0: X_(N/2)
    const double sr = xr + yr, si = xi - yi;             // X_k + conj X_(M-k)
    const double dr = xr - yr, di = xi + yi;             // X_k - conj X_(M-k)
    // W_N^-k = conj W_N^k (k <= M/2), -W_N^(M-k) past it
    const double2 w = tw[k <= M / 2 ? k : M - k];
    const double wr = k <= M / 2 ? w.x : -w.x, wi = -w.y;
    const double pr = __fma_rn(dr, wr, -(di * wi));      // W_N^-k D
    const double pi = __fma_rn(dr, wi, di * wr);
    v[i] = {sr - pi, -(si + pr)};                        // conj(S + i W D)
  }
  r2c::passes<M, false, 0, false, true>(v, sre, sim, tw, t);
  if (!live) return;
  constexpr int RL = r2c::last_radix(M, false), B = P / RL;
  T* o = out + row * (long long)n_out;
  if (n_out == 2 * M) {
    using T2 = typename Pair<T>::type;
    T2* o2 = reinterpret_cast<T2*>(o);
#pragma unroll
    for (int b = 0; b < B; b++) {
#pragma unroll
      for (int r = 0; r < RL; r++) {
        const C2 u = v[b * RL + r];
        o2[t + b * G::T + r * (M / RL)] = {(T)u.x, (T)(-u.y)};
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < B; b++) {
#pragma unroll
      for (int r = 0; r < RL; r++) {
        const int m = t + b * G::T + r * (M / RL);
        const C2 u = v[b * RL + r];
        if (2 * m < n_out) o[2 * m] = (T)u.x;
        if (2 * m + 1 < n_out) o[2 * m + 1] = (T)(-u.y);
      }
    }
  }
}

template <typename T, int M>
int launch_m(const void* re, const void* im, int R, int n_out,
             const void* tw, void* out, cudaStream_t s) {
  using G = r2c::Geometry<M>;
  if constexpr (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_c2r_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (R + G::RPB - 1) / G::RPB;
  fft_c2r_kernel<T, M><<<blocks, G::THREADS, G::SMEM, s>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), R, n_out,
      static_cast<const double2*>(tw), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* re, const void* im, int R, int N, int n_out,
           const void* tw, void* out, cudaStream_t s) {
  if (R < 0 || (n_out != N && n_out != N / 2 + 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  switch (N) {
    case 64: return launch_m<T, 32>(re, im, R, n_out, tw, out, s);
    case 128: return launch_m<T, 64>(re, im, R, n_out, tw, out, s);
    case 256: return launch_m<T, 128>(re, im, R, n_out, tw, out, s);
    case 512: return launch_m<T, 256>(re, im, R, n_out, tw, out, s);
    case 1024: return launch_m<T, 512>(re, im, R, n_out, tw, out, s);
    case 2048: return launch_m<T, 1024>(re, im, R, n_out, tw, out, s);
    case 4096: return launch_m<T, 2048>(re, im, R, n_out, tw, out, s);
    case 8192: return launch_m<T, 4096>(re, im, R, n_out, tw, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// re, im (R, N/2+1) contiguous (im null: zero); tw the launch size's dense
// table (fftmat._r2c_table(N, False)); out (R, n_out), n_out = N or
// N/2+1.  f64: 0 for float, 1 for double.
extern "C" int fft_c2r_launch(const void* re, const void* im, int R, int N,
                              int n_out, const void* tw, int f64, void* out,
                              cudaStream_t s) {
  return f64 ? launch<double>(re, im, R, N, n_out, tw, out, s)
             : launch<float>(re, im, R, N, n_out, tw, out, s);
}
