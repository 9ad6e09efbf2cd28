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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float PI_F32 = 3.1415927f;          // float32(pi)
constexpr float TWO_PI_F32 = 6.2831855f;      // float32(2 pi)
constexpr unsigned NEG_INF = 0xff800000u;

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

__global__ void __launch_bounds__(THREADS)
lifter_kernel(const float* __restrict__ c, const float* __restrict__ cf0,
              long long n, int H, float fsf, float nf, float c0, float c1,
              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int k = (int)(i % H);
  const float f0 = cf0[i / H];
  const float q = (float)k / fsf;
  const float qf = (PI_F32 * f0) * q;
  const float sl = k == 0 ? 1.f : sinf(qf) / qf;
  const float cl = c0 + c1 * cosf((TWO_PI_F32 * q) * f0);
  out[i] = ((c[i] * sl) * cl) / nf;
}

__global__ void __launch_bounds__(THREADS)
exp_kernel(const float* __restrict__ x, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = expf(x[i]);
}

}  // namespace

// mode 0: x = power rows -> log of the floored rows; mode 1: x = real
// cepstrum -> liftered cepstrum (cf0, fs, N, c0 = 1 - 2 q1, c1 = 2 q1);
// mode 2: x -> exp(x).
extern "C" int cheaptrick_lifter_launch(int mode, const float* x,
                                        const float* cf0, int R, int H,
                                        float fs, int fft_size, float c0,
                                        float c1, float tiny, float* out,
                                        cudaStream_t s) {
  const long long n = (long long)R * H;
  if (n > 0) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    if (mode == 0)
      log_floor_kernel<<<R, THREADS, 0, s>>>(x, H, tiny, out);
    else if (mode == 1)
      lifter_kernel<<<blocks, THREADS, 0, s>>>(x, cf0, n, H, fs,
                                               (float)fft_size, c0, c1, out);
    else if (mode == 2)
      exp_kernel<<<blocks, THREADS, 0, s>>>(x, n, out);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
