// K25: CheapTrick's floor -> log -> lifter -> exp chain, three launches
// around the two cepstrum matmuls.
//
// Replaces hts_train_world_tpu/ops/cheaptrick.py:163-191 (the slab
// branch's peak-relative floor, log, SmoothingWithRecovery's lifter
// sl * cl / N and exp), which on the TPU ran as elementwise XLA passes
// over the (frames, N/2+1) spectra and the (frames, N/2+1) sl and cl
// tables.  Here:
//   mode 0, one block a row: the row maximum, floor max(peak * 1e-7,
//           tiny), log(max(ps, floor));
//   mode 1, one thread a bin: sl = sin(pi f0 q) / (pi f0 q) (1 at bin 0)
//           and cl = (1 - 2 q1) + 2 q1 cos(2 pi q f0) for q = k / fs,
//           computed in the kernel from the frame's f0 (no tables), times
//           the cepstrum, / N;
//   mode 2, one thread a bin: exp, written into the (B, T, N/2+1) output.
// The operations are the twin's float32 ones in its order (true
// divisions, float32 pi and 2 pi, --fmad=false); sinf, cosf, logf and
// expf are CUDA's, a few ulps from the CPU's.
//
// Bound: bytes.  Each mode reads one (R, N/2+1) array and writes one;
// mode 1 adds a sin, a cos and ~10 operations a bin.
//
// A template on the scalar type.  float64 is the parity analysis
// (cheaptrick.py:161-191, the JAX package's f64 frame): there mode 0 is
// the parity log, which adds AddInfinitesimalNoise's |randn| * eps, read
// from the reseeded stream at each row's offset, and floors at the
// absolute tiny (the fast path's peak-relative floor is for float32's
// cancellation); modes 1 and 2 take pi and 2 pi in double.  The caller
// asks for the parity log by name and the wrapper gives it float64 rows,
// the fast log float32 rows: each instantiation carries one of the two.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned NEG_INF = 0xff800000u;
constexpr double K_EPS = 2.220446049250313e-16;

// pi and 2 pi in each type (float: the float32 roundings)
template <typename T> struct Pi;
template <> struct Pi<float> {
  static constexpr float one = 3.1415927f, two = 6.2831855f;
};
template <> struct Pi<double> {
  static constexpr double one = 3.141592653589793, two = 6.283185307179586;
};

__device__ __forceinline__ float sin_t(float a) { return sinf(a); }
__device__ __forceinline__ double sin_t(double a) { return sin(a); }
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }
__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }

__global__ void __launch_bounds__(THREADS)
log_floor_kernel(const float* __restrict__ ps, int H, float tiny,
                 float* __restrict__ out) {
  __shared__ float red[32];
  const float* row = ps + (size_t)blockIdx.x * H;
  float* o = out + (size_t)blockIdx.x * H;
  float m = __uint_as_float(NEG_INF);
  for (int j = threadIdx.x; j < H; j += THREADS) m = fmaxf(m, row[j]);
  for (int s = 16; s > 0; s >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? red[threadIdx.x]
                                   : __uint_as_float(NEG_INF);
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (threadIdx.x == 0) red[0] = m;
  }
  __syncthreads();
  const float fl = fmaxf(red[0] * 1e-7f, tiny);
  for (int j = threadIdx.x; j < H; j += THREADS)
    o[j] = logf(fmaxf(row[j], fl));
}

// the parity log: log(max(ps + |noise| * eps, tiny)), one thread a bin
__global__ void __launch_bounds__(THREADS)
log_noise_kernel(const double* __restrict__ ps, long long n, int H,
                 double tiny, const double* __restrict__ noise,
                 const long long* __restrict__ noff,
                 double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  double v = ps[i];
  if (noise) v = v + fabs(noise[noff[i / H] + i % H]) * K_EPS;
  out[i] = log(fmax(v, tiny));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lifter_kernel(const T* __restrict__ c, const T* __restrict__ cf0,
              long long n, int H, T fsf, T nf, T c0, T c1,
              T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int k = (int)(i % H);
  const T f0 = cf0[i / H];
  const T q = (T)k / fsf;
  const T qf = (Pi<T>::one * f0) * q;
  const T sl = k == 0 ? T(1) : sin_t(qf) / qf;
  const T cl = c0 + c1 * cos_t((Pi<T>::two * q) * f0);
  out[i] = ((c[i] * sl) * cl) / nf;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
exp_kernel(const T* __restrict__ x, long long n, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = exp_t(x[i]);
}

template <typename T>
int launch(int mode, const void* x, const void* cf0, int R, int H,
           double fs, int fft_size, double c0, double c1, double tiny,
           const void* noise, const long long* noff, void* out,
           cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (mode == 0) {
    if (sizeof(T) == 8)
      log_noise_kernel<<<blocks, THREADS, 0, s>>>(
          static_cast<const double*>(x), n, H, tiny,
          static_cast<const double*>(noise), noff,
          static_cast<double*>(out));
    else
      log_floor_kernel<<<R, THREADS, 0, s>>>(
          static_cast<const float*>(x), H, (float)tiny,
          static_cast<float*>(out));
  } else if (mode == 1) {
    lifter_kernel<T><<<blocks, THREADS, 0, s>>>(
        xt, static_cast<const T*>(cf0), n, H, (T)fs, (T)fft_size, (T)c0,
        (T)c1, ot);
  } else if (mode == 2) {
    exp_kernel<T><<<blocks, THREADS, 0, s>>>(xt, n, ot);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: x = power rows -> log of the floored rows (float32: the floor
// relative to the row's peak; float64: + |noise[noff[r] + k]| * eps where
// noise is given, then the absolute floor `tiny`); mode 1: x = real
// cepstrum -> liftered cepstrum (cf0, fs, N, c0 = 1 - 2 q1, c1 = 2 q1);
// mode 2: x -> exp(x).  f64: 0 for float tensors, 1 for double.
extern "C" int cheaptrick_lifter_launch(int mode, const void* x,
                                        const void* cf0, int R, int H,
                                        double fs, int fft_size, double c0,
                                        double c1, double tiny,
                                        const void* noise,
                                        const long long* noff, int f64,
                                        void* out, cudaStream_t s) {
  return f64 ? launch<double>(mode, x, cf0, R, H, fs, fft_size, c0, c1, tiny,
                              noise, noff, out, s)
             : launch<float>(mode, x, cf0, R, H, fs, fft_size, c0, c1, tiny,
                             noise, noff, out, s);
}
