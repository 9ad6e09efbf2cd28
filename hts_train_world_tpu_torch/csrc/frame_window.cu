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
//
// The kernel is a template on the scalar type.  float32 is the fast path.
// float64 is the parity analysis, which replaces the JAX package's generic
// windows: cheaptrick.py:127-148 (the frame at any position), d4c.py:35-68
// (_windowed_waveform) and stonemask.py:179-205 (the bucket path's
// refine).  There each window also adds the reference's noise,
// randn * 1e-12, read from the reseeded stream at the frame's own offset
// (`noff`, a device tensor: cumulative sums of the frames' draw counts),
// and STONEMASK_ROUNDED, the bucket path's STONEMASK, reads sample j at
// its own rounded index round((pos + (j-h)/fs) * fs) (stonemask.cpp's
// per-element rounding).  The caller names that mode; the scalar type only
// picks the instantiation.
// A row may name its utterance (`rowutt`), so a caller can window a
// compacted set of frames.
#include "common.cuh"

namespace {

// The window is part of the mode: MEAN is Hann, MEAN_BLACKMAN Blackman,
// CHEAPTRICK Hann, CENTROID Blackman, STONEMASK its own Blackman of
// absolute time (STONEMASK_ROUNDED too, each sample at its own index).
constexpr int MEAN = 0, CHEAPTRICK = 1, CENTROID = 2, STONEMASK = 3,
              MEAN_BLACKMAN = 4, STONEMASK_ROUNDED = 5;
constexpr int THREADS = 256;

// pi, 2 pi and 4 pi in each type (float: the float32 roundings)
template <typename T> struct Pi;
template <> struct Pi<float> {
  static constexpr float one = 3.14159265358979f, two = 6.28318530717959f,
                         four = 12.5663706143592f;
};
template <> struct Pi<double> {
  static constexpr double one = 3.141592653589793, two = 6.283185307179586,
                          four = 12.566370614359172;
};

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

template <typename T, bool BLACKMAN>
__device__ __forceinline__ T window_at(int j, int h, T f0, T fs, T ratio) {
  // position = (2*(j-h)/ratio)/fs; arg = (pi*position)*f0
  const T position = div_rn(div_rn(T(2) * (T)(j - h), ratio), fs);
  const T arg = mul_rn(mul_rn(Pi<T>::one, position), f0);
  if (BLACKMAN)
    return T(0.42) + T(0.5) * cos_t(arg) + T(0.08) * cos_t(arg * T(2));
  return T(0.5) * cos_t(arg) + T(0.5);
}

template <typename T, int MODE, bool BLACKMAN>
__global__ void __launch_bounds__(THREADS)
frame_window_kernel(const T* __restrict__ x, int L, int T_, 
                    const int* __restrict__ rowutt,
                    const int* __restrict__ origin, const int* __restrict__ hh,
                    const T* __restrict__ f0v, const T* __restrict__ posv,
                    T fs, T ratio, int W, const T* __restrict__ noise,
                    const long long* __restrict__ noff,
                    T* __restrict__ out1, T* __restrict__ out2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // the window, W values
  __shared__ T red[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)(rowutt ? rowutt[r] : r / T_) * L;
  const int h = hh[r], o = origin[r], n = 2 * h + 1;
  const T* nz = noise && noff[r] >= 0 ? noise + noff[r] : nullptr;
  T* o1 = out1 + (size_t)r * W;
  T* o2 = out2 ? out2 + (size_t)r * W : nullptr;

  if (MODE == STONEMASK || MODE == STONEMASK_ROUNDED) {
    // stonemask.cpp:40-55 on absolute time: t_j = idx_j/fs - pos, idx_j =
    // o-h+j (STONEMASK, the fast path's contiguous run) or round((pos +
    // (j-h)/fs)*fs) - 1 (STONEMASK_ROUNDED, each sample rounded on its own)
    constexpr bool PER_SAMPLE = MODE == STONEMASK_ROUNDED;
    const T pos = posv[r];
    const T wt = div_rn((T)n, fs);
    const T inv_fs = div_rn(T(1), fs);
    for (int j = tid; j < W; j += THREADS) {
      T v = T(0);
      if (j < n) {
        long long idx = o - h + j;
        if (PER_SAMPLE) {
          // pos + (j-h)/fs as XLA compiles the JAX package's, a fused
          // multiply-add with 1/fs: at 44.1 kHz the frame grid puts
          // samples on rounding ties, and this decides them alike
          const T u = fma((T)(j - h), inv_fs, pos) * fs;
          idx = (long long)trunc(u > T(0) ? u + T(0.5) : u - T(0.5)) - 1;
        }
        const T tmp = sub_rn(div_rn((T)idx, fs), pos);
        const T a1 = div_rn(mul_rn(Pi<T>::two, tmp), wt);
        const T a2 = div_rn(mul_rn(Pi<T>::four, tmp), wt);
        v = T(0.42) + T(0.5) * cos_t(a1) + T(0.08) * cos_t(a2);
        if (PER_SAMPLE) o1[j] = (T)idx;  // the index, read back below
      }
      w[j] = v;
    }
    __syncthreads();
    for (int j = tid; j < W; j += THREADS) {
      T m = T(0), d = T(0);
      if (j < n) {
        const long long idx = PER_SAMPLE ? (long long)o1[j] : o - h + j;
        const T xs = xr[min(max(idx, 0LL), (long long)L - 1)];
        const T wp = j + 1 < W ? w[j + 1] : T(0);
        const T wm = j > 0 ? w[j - 1] : T(0);
        m = xs * w[j];
        d = xs * (-(wp - wm) / T(2));
      }
      o1[j] = m;
      o2[j] = d;
    }
    return;
  }

  const T f0 = f0v[r];
  T sw = T(0), sw2 = T(0);
  for (int j = tid; j < W; j += THREADS) {
    const T v = j < n ? window_at<T, BLACKMAN>(j, h, f0, fs, ratio) : T(0);
    w[j] = v;
    sw += v;
    sw2 += v * v;
  }
  if (MODE == CHEAPTRICK) {  // w / sqrt(sum w^2), then sums of the new w
    const T nrm = sqrt_t(block_sum(sw2, red));
    sw = T(0);
    for (int j = tid; j < W; j += THREADS) {
      const T v = w[j] / nrm;
      w[j] = v;
      sw += v;
    }
  }
  // the windowed sample, plus the reference's noise where there is one
  auto wave = [&](int j) {
    const T v = xr[min(max(o - h + j, 0), L - 1)] * w[j];
    return nz ? v + nz[j] * T(1e-12) : v;
  };
  T sxw = T(0);
  for (int j = tid; j < n; j += THREADS) sxw += wave(j);
  const T sum_w = block_sum(sw, red);
  const T coef = block_sum(sxw, red) / sum_w;

  T sq = T(0);
  for (int j = tid; j < W; j += THREADS) {
    T v = T(0);
    if (j < n) v = wave(j) - w[j] * coef;
    o1[j] = v;
    sq += v * v;
  }
  if (MODE == CENTROID) {  // unit energy; second row weighted by j+1
    const T nrm = sqrt_t(block_sum(sq, red));
    for (int j = tid; j < W; j += THREADS) {
      const T v = o1[j] / nrm;
      o1[j] = v;
      o2[j] = v * (T)(j + 1);
    }
  }
}

template <typename T, int MODE, bool BLACKMAN>
void launch(const void* x, int L, int T_, const int* rowutt,
            const int* origin, const int* h, const void* f0, const void* pos,
            double fs, double ratio, int rows, int W, const void* noise,
            const long long* noff, void* out1, void* out2, cudaStream_t s) {
  frame_window_kernel<T, MODE, BLACKMAN><<<rows, THREADS, W * sizeof(T), s>>>(
      static_cast<const T*>(x), L, T_, rowutt, origin, h,
      static_cast<const T*>(f0), static_cast<const T*>(pos), (T)fs, (T)ratio,
      W, static_cast<const T*>(noise), noff, static_cast<T*>(out1),
      static_cast<T*>(out2));
}

template <typename T>
int dispatch(const void* x, int L, int T_, const int* rowutt,
             const int* origin, const int* h, const void* f0,
             const void* pos, double fs, double ratio, int rows, int W,
             int mode, const void* noise, const long long* noff, void* out1,
             void* out2, cudaStream_t s) {
  if ((size_t)W * sizeof(T) > 46 * 1024) return (int)cudaErrorInvalidValue;
  if (mode == STONEMASK)
    launch<T, STONEMASK, true>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                               ratio, rows, W, noise, noff, out1, out2, s);
  else if (mode == STONEMASK_ROUNDED)
    launch<T, STONEMASK_ROUNDED, true>(x, L, T_, rowutt, origin, h, f0, pos,
                                       fs, ratio, rows, W, noise, noff, out1,
                                       out2, s);
  else if (mode == MEAN_BLACKMAN)
    launch<T, MEAN, true>(x, L, T_, rowutt, origin, h, f0, pos, fs, ratio,
                          rows, W, noise, noff, out1, out2, s);
  else if (mode == MEAN)
    launch<T, MEAN, false>(x, L, T_, rowutt, origin, h, f0, pos, fs, ratio,
                           rows, W, noise, noff, out1, out2, s);
  else if (mode == CHEAPTRICK)
    launch<T, CHEAPTRICK, false>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                                 ratio, rows, W, noise, noff, out1, out2, s);
  else if (mode == CENTROID)
    launch<T, CENTROID, true>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                              ratio, rows, W, noise, noff, out1, out2, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L), per row: utterance (rowutt, or r / T when null), centre, half
// length, f0 and position; noise (the stream) and noff (each row's first
// draw, < 0 for a row without noise) or null; f64: 0 for float tensors, 1
// for double.
extern "C" int frame_window_launch(const void* x, int L, int T,
                                   const int* rowutt, const int* origin,
                                   const int* h, const void* f0,
                                   const void* pos, double fs, double ratio,
                                   int rows, int W, int mode,
                                   const void* noise, const long long* noff,
                                   int f64, void* out1, void* out2,
                                   cudaStream_t s) {
  if (rows <= 0) return (int)cudaGetLastError();
  return f64 ? dispatch<double>(x, L, T, rowutt, origin, h, f0, pos, fs,
                                ratio, rows, W, mode, noise, noff, out1, out2,
                                s)
             : dispatch<float>(x, L, T, rowutt, origin, h, f0, pos, fs, ratio,
                               rows, W, mode, noise, noff, out1, out2, s);
}
