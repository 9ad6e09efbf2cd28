// K27: D4C's coarse aperiodicity and its interpolation onto the
// CheapTrick frequency axis, one thread an output bin.
//
// Replaces hts_train_world_tpu/ops/d4c.py:196-208 (10 log10 of the
// top-k remainder over the band power) and 409-418 (the f0 correction
// (cf0 - 100) / 50, the clamp at 0 dB, GetAperiodicity's interp1 with the
// -60 dB and -kMySafeGuardMinimum ends, 10^(x/20) and the `process`
// mask), which on the TPU ran as XLA passes over (frames, n_ap) and
// (frames, fft/2+1).  A block's first n_ap threads form its row's coarse
// values in shared memory from the band totals `den` and top-k sums (K3);
// every thread then finds its bin's segment on the n_ap + 2 point axis
// (the count of axis points <= its frequency, as searchsorted right) and
// writes the linear aperiodicity.  The operations are the twin's float32
// ones in its order; log10f and powf are CUDA's.
//
// Bound: bytes (the (R, fft/2+1) output; the inputs are 2 n_ap + 2 words
// a frame).
//
// A template on the scalar type.  float64 is the parity analysis: there
// the band's numerator comes in directly (`num` = 1), the cumulative sum
// of its ascending-sorted power up to half - boundary - 1 (K31,
// d4c_band_sort.cu; d4c.py:190-194), instead of total minus top-k.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_AP = 32;

__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
// the double forms propagate a NaN, as the JAX package's jnp.maximum /
// jnp.minimum and the twin's torch.clamp do
__device__ __forceinline__ double max_t(double a, double b) {
  return isnan(a) ? a : fmax(a, b);
}
__device__ __forceinline__ float min_t(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_t(double a, double b) {
  return isnan(a) ? a : fmin(a, b);
}
__device__ __forceinline__ float log10_t(float a) { return log10f(a); }
__device__ __forceinline__ double log10_t(double a) { return log10(a); }
__device__ __forceinline__ float pow_t(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ double pow_t(double a, double b) {
  return pow(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
aperiodicity_kernel(const T* __restrict__ den, const T* __restrict__ second,
                    int second_is_num, const T* __restrict__ cf0,
                    const unsigned char* __restrict__ process, int n_ap,
                    int H, T fsf, T nf, T tiny, T* __restrict__ coarse,
                    T* __restrict__ ap) {
  __shared__ T axis[MAX_AP + 2], vals[MAX_AP + 2];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  if (t < n_ap) {
    const T d = den[r * n_ap + t];
    const T num = second_is_num ? second[r * n_ap + t]
                                : d - second[r * n_ap + t];
    const T ca = T(10) * log10_t(max_t(num, tiny) / max_t(d, tiny));
    const T c = min_t(ca + (cf0[r] - T(100)) / T(50), T(0));
    vals[t + 1] = c;
    if (blockIdx.y == 0) coarse[r * n_ap + t] = c;
  }
  if (t <= n_ap) axis[t] = (T)t * T(3000);
  if (t == 0) {
    axis[n_ap + 1] = fsf / T(2);
    vals[0] = T(-60);
    vals[n_ap + 1] = T(-1e-12);
  }
  __syncthreads();
  const int k = blockIdx.y * THREADS + t;
  if (k >= H) return;
  const size_t o = (size_t)r * H + k;
  if (!process[r]) {
    ap[o] = T(1) - T(1e-12);
    return;
  }
  const T xi = ((T)k * fsf) / nf;
  const int n = n_ap + 2;
  int c = 0;                      // #(axis <= xi), clamped to [1, n - 1]
  for (int j = 0; j < n; ++j) c += axis[j] <= xi;
  c = min(max(c, 1), n - 1);
  const T x0 = axis[c - 1], x1 = axis[c];
  const T y0 = vals[c - 1], y1 = vals[c];
  const T s = (xi - x0) / (x1 - x0);
  ap[o] = pow_t(T(10), (y0 + s * (y1 - y0)) / T(20));
}

}  // namespace

// second: the band's top-k sum (num = 0: the numerator is den - second)
// or its numerator itself (num = 1).  f64: 0 for float tensors, 1 for
// double.
extern "C" int d4c_aperiodicity_launch(const void* den, const void* second,
                                       int num, const void* cf0,
                                       const unsigned char* process, int R,
                                       int n_ap, int H, double fs,
                                       int fft_size, double tiny, int f64,
                                       void* coarse, void* ap,
                                       cudaStream_t s) {
  // n_ap = 0 at fs <= 12 kHz: the axis is 0 and fs/2 alone
  if (n_ap < 0 || n_ap > MAX_AP) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    dim3 grid(R, (H + THREADS - 1) / THREADS);
    if (f64)
      aperiodicity_kernel<double><<<grid, THREADS, 0, s>>>(
          (const double*)den, (const double*)second, num,
          (const double*)cf0, process, n_ap, H, fs, (double)fft_size, tiny,
          (double*)coarse, (double*)ap);
    else
      aperiodicity_kernel<float><<<grid, THREADS, 0, s>>>(
          (const float*)den, (const float*)second, num, (const float*)cf0,
          process, n_ap, H, (float)fs, (float)fft_size, (float)tiny,
          (float*)coarse, (float*)ap);
  }
  return (int)cudaGetLastError();
}
