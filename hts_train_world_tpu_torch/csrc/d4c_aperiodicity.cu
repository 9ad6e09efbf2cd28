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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_AP = 32;
constexpr float FREQUENCY_INTERVAL = 3000.0f;

__global__ void __launch_bounds__(THREADS)
aperiodicity_kernel(const float* __restrict__ den,
                    const float* __restrict__ topk,
                    const float* __restrict__ cf0,
                    const unsigned char* __restrict__ process, int n_ap,
                    int H, float fsf, float nf, float tiny,
                    float* __restrict__ coarse, float* __restrict__ ap) {
  __shared__ float axis[MAX_AP + 2], vals[MAX_AP + 2];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  if (t < n_ap) {
    const float d = den[r * n_ap + t];
    const float num = d - topk[r * n_ap + t];
    const float ca = 10.0f * log10f(fmaxf(num, tiny) / fmaxf(d, tiny));
    const float c = fminf(ca + (cf0[r] - 100.0f) / 50.0f, 0.0f);
    vals[t + 1] = c;
    if (blockIdx.y == 0) coarse[r * n_ap + t] = c;
  }
  if (t <= n_ap) axis[t] = (float)t * FREQUENCY_INTERVAL;
  if (t == 0) {
    axis[n_ap + 1] = fsf / 2.0f;
    vals[0] = -60.0f;
    vals[n_ap + 1] = -1e-12f;
  }
  __syncthreads();
  const int k = blockIdx.y * THREADS + t;
  if (k >= H) return;
  const size_t o = (size_t)r * H + k;
  if (!process[r]) {
    ap[o] = 1.0f - 1e-12f;
    return;
  }
  const float xi = ((float)k * fsf) / nf;
  const int n = n_ap + 2;
  int c = 0;                      // #(axis <= xi), clamped to [1, n - 1]
  for (int j = 0; j < n; ++j) c += axis[j] <= xi;
  c = min(max(c, 1), n - 1);
  const float x0 = axis[c - 1], x1 = axis[c];
  const float y0 = vals[c - 1], y1 = vals[c];
  const float s = (xi - x0) / (x1 - x0);
  ap[o] = powf(10.0f, (y0 + s * (y1 - y0)) / 20.0f);
}

}  // namespace

extern "C" int d4c_aperiodicity_launch(const float* den, const float* topk,
                                       const float* cf0,
                                       const unsigned char* process, int R,
                                       int n_ap, int H, float fs,
                                       int fft_size, float tiny,
                                       float* coarse, float* ap,
                                       cudaStream_t s) {
  // n_ap = 0 at fs <= 12 kHz: the axis is 0 and fs/2 alone
  if (n_ap < 0 || n_ap > MAX_AP) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    dim3 grid(R, (H + THREADS - 1) / THREADS);
    aperiodicity_kernel<<<grid, THREADS, 0, s>>>(
        den, topk, cf0, process, n_ap, H, fs, (float)fft_size, tiny, coarse,
        ap);
  }
  return (int)cudaGetLastError();
}
