// K1: F0-adaptive windowed frames, one block per (utterance, frame).
//
// Replaces the JAX package's slab-window formulation:
//   hts_train_world_tpu/ops/d4c.py:71-119 (_slab_frames, _slab_window),
//   ops/cheaptrick.py:113-125 (slab_wave), ops/stonemask.py:91-108 (windows).
// On the TPU every frame was laid out in a regular slab row built from
// static slices (no gathers) and the window floated inside the row.  Here
// each block reads x directly at its frame's offset (clamped to x[0] /
// x[L-1], the JAX edge padding) and writes the 2h+1 windowed samples at
// offset 0 of a zero-padded row, so the DFT downstream is the true DFT.
//
// Bound: bytes.  Each frame reads <= W samples of x (L2-resident: frames
// overlap) and writes one or two rows of W floats; the arithmetic is a
// few cosines per sample.  Design: one block per frame, the window staged
// in shared memory, three block reductions (sum w, sum w^2, sum x*w).
// Per-frame integers (centre, half-length) come from the caller, so the
// kernel and its plain twin read the same samples.  Built with
// --fmad=false: the products and differences round like the plain
// PyTorch twin's separate operations.
#include "common.cuh"

namespace {

// The window is part of the mode: MEAN is Hann, MEAN_BLACKMAN Blackman,
// CHEAPTRICK Hann, CENTROID Blackman, STONEMASK its own Blackman of
// absolute time.
constexpr int MEAN = 0, CHEAPTRICK = 1, CENTROID = 2, STONEMASK = 3,
              MEAN_BLACKMAN = 4;
constexpr int THREADS = 256;
constexpr float PI_F = 3.14159265358979f;  // (float)pi
constexpr float TWO_PI_F = 6.28318530717959f;
constexpr float FOUR_PI_F = 12.5663706143592f;

template <bool BLACKMAN>
__device__ __forceinline__ float window_at(int j, int h, float f0, float fs,
                                           float ratio) {
  // position = (2*(j-h)/ratio)/fs; arg = (pi*position)*f0
  const float position = __fdiv_rn(__fdiv_rn(2.0f * (float)(j - h), ratio), fs);
  const float arg = __fmul_rn(__fmul_rn(PI_F, position), f0);
  if (BLACKMAN)
    return 0.42f + 0.5f * cosf(arg) + 0.08f * cosf(arg * 2.0f);
  return 0.5f * cosf(arg) + 0.5f;
}

template <int MODE, bool BLACKMAN>
__global__ void __launch_bounds__(THREADS)
frame_window_kernel(const float* __restrict__ x, int L, int T,
                    const int* __restrict__ origin, const int* __restrict__ hh,
                    const float* __restrict__ f0v,
                    const float* __restrict__ posv, float fs, float ratio,
                    int W, float* __restrict__ out1,
                    float* __restrict__ out2) {
  extern __shared__ float w[];  // the window, W floats
  __shared__ float red[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* xr = x + (size_t)(r / T) * L;
  const int h = hh[r], o = origin[r], n = 2 * h + 1;
  float* o1 = out1 + (size_t)r * W;
  float* o2 = out2 ? out2 + (size_t)r * W : nullptr;

  if (MODE == STONEMASK) {
    // stonemask.cpp:40-55 on absolute time: t_j = (o-h+j)/fs - pos
    const float pos = posv[r];
    const float wt = __fdiv_rn((float)n, fs);
    for (int j = tid; j < W; j += THREADS) {
      float v = 0.f;
      if (j < n) {
        const float tmp = __fsub_rn(__fdiv_rn((float)(o - h + j), fs), pos);
        const float a1 = __fdiv_rn(__fmul_rn(TWO_PI_F, tmp), wt);
        const float a2 = __fdiv_rn(__fmul_rn(FOUR_PI_F, tmp), wt);
        v = 0.42f + 0.5f * cosf(a1) + 0.08f * cosf(a2);
      }
      w[j] = v;
    }
    __syncthreads();
    for (int j = tid; j < W; j += THREADS) {
      float m = 0.f, d = 0.f;
      if (j < n) {
        const float xs = xr[min(max(o - h + j, 0), L - 1)];
        const float wp = j + 1 < W ? w[j + 1] : 0.f;
        const float wm = j > 0 ? w[j - 1] : 0.f;
        m = xs * w[j];
        d = xs * (-(wp - wm) / 2.0f);
      }
      o1[j] = m;
      o2[j] = d;
    }
    return;
  }

  const float f0 = f0v[r];
  float sw = 0.f, sw2 = 0.f;
  for (int j = tid; j < W; j += THREADS) {
    const float v = j < n ? window_at<BLACKMAN>(j, h, f0, fs, ratio) : 0.f;
    w[j] = v;
    sw += v;
    sw2 += v * v;
  }
  if (MODE == CHEAPTRICK) {  // w / sqrt(sum w^2), then sums of the new w
    const float nrm = sqrtf(block_sum(sw2, red));
    sw = 0.f;
    for (int j = tid; j < W; j += THREADS) {
      const float v = w[j] / nrm;
      w[j] = v;
      sw += v;
    }
  }
  float sxw = 0.f;
  for (int j = tid; j < n; j += THREADS)
    sxw += xr[min(max(o - h + j, 0), L - 1)] * w[j];
  const float sum_w = block_sum(sw, red);
  const float coef = block_sum(sxw, red) / sum_w;

  float sq = 0.f;
  for (int j = tid; j < W; j += THREADS) {
    float v = 0.f;
    if (j < n) v = xr[min(max(o - h + j, 0), L - 1)] * w[j] - w[j] * coef;
    o1[j] = v;
    sq += v * v;
  }
  if (MODE == CENTROID) {  // unit energy; second row weighted by j+1
    const float nrm = sqrtf(block_sum(sq, red));
    for (int j = tid; j < W; j += THREADS) {
      const float v = o1[j] / nrm;
      o1[j] = v;
      o2[j] = v * (float)(j + 1);
    }
  }
}

template <int MODE, bool BLACKMAN>
void launch(const float* x, int L, int T, const int* origin, const int* h,
            const float* f0, const float* pos, float fs, float ratio,
            int rows, int W, float* out1, float* out2, cudaStream_t s) {
  frame_window_kernel<MODE, BLACKMAN><<<rows, THREADS, W * sizeof(float), s>>>(
      x, L, T, origin, h, f0, pos, fs, ratio, W, out1, out2);
}

}  // namespace

extern "C" int frame_window_launch(const float* x, int L, int T,
                                   const int* origin, const int* h,
                                   const float* f0, const float* pos,
                                   float fs, float ratio, int rows, int W,
                                   int mode, float* out1, float* out2,
                                   cudaStream_t s) {
  if (rows > 0) {
    if ((size_t)W * sizeof(float) > 46 * 1024) return (int)cudaErrorInvalidValue;
    if (mode == STONEMASK)
      launch<STONEMASK, true>(x, L, T, origin, h, f0, pos, fs, ratio, rows,
                              W, out1, out2, s);
    else if (mode == MEAN_BLACKMAN)
      launch<MEAN, true>(x, L, T, origin, h, f0, pos, fs, ratio, rows, W,
                         out1, out2, s);
    else if (mode == MEAN)
      launch<MEAN, false>(x, L, T, origin, h, f0, pos, fs, ratio, rows, W,
                          out1, out2, s);
    else if (mode == CHEAPTRICK)
      launch<CHEAPTRICK, false>(x, L, T, origin, h, f0, pos, fs, ratio, rows,
                                W, out1, out2, s);
    else if (mode == CENTROID)
      launch<CENTROID, true>(x, L, T, origin, h, f0, pos, fs, ratio, rows, W,
                             out1, out2, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
