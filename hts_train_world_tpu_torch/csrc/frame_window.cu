// K1: F0-adaptive windowed frames, each (utterance, frame) by one block.
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
// overlap) and writes one or two rows of W values.  The arithmetic is not
// far under it: each window sample takes two IEEE divisions and one or two
// cosines (~60-100 instructions), ~32 M samples a copy-synthesis batch.
// Design: only the window's samples are computed, and the rows' stores
// are the traffic.  As many blocks as fit on the card at once each work
// their frames in turn.  A block of NT threads (`window_plan` in
// ops/frames.py: 128 up to W = 2048, 256 up to 4096, ...) holds a frame
// in registers: thread t owns the chunks of four consecutive samples c =
// t + NT i (i < K <= 4), so each chunk is one 16-byte store (two for
// double) and a warp stores 512 contiguous bytes.  A thread computes only
// its chunks that hold window samples (a real branch: the compiler would
// otherwise evaluate the cosines of the whole row and select); x is read
// once a sample; the window and the windowed samples stay in registers
// between the sums; each block sum is a warp's butterfly plus one
// exchange through shared memory: one barrier a reduction (MEAN and
// MEAN_BLACKMAN one, CHEAPTRICK and CENTROID two).  The chunks past the
// window (most of a row: 721 samples of 2048 at f0 200 Hz) are stored
// first, as zeros without arithmetic, so that their traffic overlaps the
// window's arithmetic; CENTROID's normalised row and its (j+1)-weighted
// twin are both written from registers.  Integers enter the arithmetic as
// one conversion a chunk plus exact small additions.  STONEMASK needs no
// sum: its window is computed once a sample into shared memory (one
// barrier), then each chunk reads its four values and its two
// neighbours' for the centred difference, recomputes its samples' indices
// in registers (STONEMASK_ROUNDED: each rounded on its own) and stores
// both rows.  Per-frame integers (centre, half-length) come from the
// caller, so the kernel and its plain twin read the same samples.  Built
// with --fmad=false: the products and differences round like the plain
// PyTorch twin's separate operations; the elements differ from the
// twin's only through the order of the frame sums.
//
// A window wider than the row is cut at the row's end, as the twin cuts
// it (the sums too): no chunk past the row is computed or stored.
//
// The kernel is a template on the scalar type.  float32 is the fast path.
// float64 keeps the window in shared memory instead of registers (a row of
// doubles in registers left too few frames on an SM to hide the float64
// cosines' latency) and computes each windowed sample again where it is
// needed; the block shapes and the sums' order are float32's.
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
#include <cstdint>

#include "common.cuh"

namespace {

// The window is part of the mode: MEAN is Hann, MEAN_BLACKMAN Blackman,
// CHEAPTRICK Hann, CENTROID Blackman, STONEMASK its own Blackman of
// absolute time (STONEMASK_ROUNDED too, each sample at its own index).
constexpr int MEAN = 0, CHEAPTRICK = 1, CENTROID = 2, STONEMASK = 3,
              MEAN_BLACKMAN = 4, STONEMASK_ROUNDED = 5;

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

// jh = j - h, an integer held exactly in T
template <typename T, bool BLACKMAN>
__device__ __forceinline__ T window_at(T jh, T f0, T fs, T ratio) {
  // position = (2*(j-h)/ratio)/fs; arg = (pi*position)*f0
  const T position = div_rn(div_rn(T(2) * jh, ratio), fs);
  const T arg = mul_rn(mul_rn(Pi<T>::one, position), f0);
  if (BLACKMAN)
    return T(0.42) + T(0.5) * cos_t(arg) + T(0.08) * cos_t(arg * T(2));
  return T(0.5) * cos_t(arg) + T(0.5);
}

// Samples j0..j0+3 of a row: one 16-byte store (float) or two (double)
// where the row is 16-byte aligned (`vec`), else single stores below W.
__device__ __forceinline__ void put4(float* p, int j0, int W, bool vec,
                                     const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + j0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (j0 + e < W) p[j0 + e] = v[e];
}
__device__ __forceinline__ void put4(double* p, int j0, int W, bool vec,
                                     const double (&v)[4]) {
  if (vec) {
    reinterpret_cast<double2*>(p + j0)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p + j0)[1] = make_double2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (j0 + e < W) p[j0 + e] = v[e];
}

// Four values at a 16-byte aligned place of shared memory
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// The block sums of M values, returned to every thread: each warp's
// butterfly, then the warp totals through `red` (M x NT/32 words that no
// other reduction of the block uses), added in warp order.  One barrier.
template <int NT, int M, typename T>
__device__ __forceinline__ void block_sums(T (&v)[M], T (*red)[NT / 32]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = warp_sum(v[m]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[m][wid] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T s = red[m][0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) s += red[m][w];
    v[m] = s;
  }
}

// 64 registers a thread: float64's unrolled window took 72-88, which left
// three blocks of 256 an SM, too few to hide its cosines' latency (48
// spilled); float32 stays at the 64 ptxas gives it without a block count
template <typename T, int MODE, bool BLACKMAN, int NT, int K>
__global__ void __launch_bounds__(NT, 1024 / NT)
frame_window_kernel(const T* __restrict__ x, int L, int T_,
                    const int* __restrict__ rowutt,
                    const int* __restrict__ origin, const int* __restrict__ hh,
                    const T* __restrict__ f0v, const T* __restrict__ posv,
                    T fs, T ratio, int rows, int W,
                    const T* __restrict__ noise,
                    const long long* __restrict__ noff,
                    T* __restrict__ out1, T* __restrict__ out2) {
  const int t = threadIdx.x;
  const bool vec = (W & 3) == 0
      && (((uintptr_t)out1 | (uintptr_t)(out2 ? out2 : out1)) & 15) == 0;
  const int nq = (W + 3) >> 2;      // chunks of four in a row
  const T zero[4] = {T(0), T(0), T(0), T(0)};
  // a block works its frames in turn: r, r + gridDim.x, ...
  for (int r = blockIdx.x, it = 0; r < rows; r += gridDim.x, ++it) {
    const T* xr = x + (size_t)(rowutt ? rowutt[r] : r / T_) * L;
    const int h = hh[r], o = origin[r], n = 2 * h + 1;
    const T* nz = noise && noff[r] >= 0 ? noise + noff[r] : nullptr;
    T* o1 = out1 + (size_t)r * W;
    T* o2 = out2 ? out2 + (size_t)r * W : nullptr;
    // a window wider than the row is cut at the row's end, as the twin's
    const int ne = min(n, W);
    const int live = (ne + 3) >> 2;  // the chunks holding window samples

    if constexpr (MODE == STONEMASK || MODE == STONEMASK_ROUNDED) {
      // stonemask.cpp:40-55 on absolute time: t_j = idx_j/fs - pos, idx_j
      // = o-h+j (STONEMASK, the fast path's contiguous run) or round((pos
      // + (j-h)/fs)*fs) - 1 (STONEMASK_ROUNDED, each sample rounded on its
      // own)
      constexpr bool PER_SAMPLE = MODE == STONEMASK_ROUNDED;
      extern __shared__ __align__(16) unsigned char smem_raw[];
      T* ws = reinterpret_cast<T*>(smem_raw);  // ws[4 + j]: the window at j
      const T pos = posv[r];
      const T wt = div_rn((T)n, fs);
      const T inv_fs = div_rn(T(1), fs);
      auto index = [&](int j) -> long long {
        if (!PER_SAMPLE) return (long long)(o - h + j);
        // pos + (j-h)/fs as XLA compiles the JAX package's, a fused
        // multiply-add with 1/fs: at 44.1 kHz the frame grid puts samples
        // on rounding ties, and this decides them alike
        const T u = fma((T)(j - h), inv_fs, pos) * fs;
        return (long long)trunc(u > T(0) ? u + T(0.5) : u - T(0.5)) - 1;
      };
      // the rows past the window first: zeros, on their way to memory
      // while the window is computed
      for (int c = live + t; c < nq; c += NT) {
        put4(o1, 4 * c, W, vec, zero);
        put4(o2, 4 * c, W, vec, zero);
      }
      // the window once a sample, 0 at j = -1 and past the window
      for (int c = t; c < live; c += NT) {
        T a[4];
        const T i0 = (T)(o - h + 4 * c);  // the chunk's first index, exact
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = T(0);
          const int j = 4 * c + e;
          if (j < ne) {
            const T idx = PER_SAMPLE ? (T)index(j) : i0 + T(e);
            const T tmp = sub_rn(div_rn(idx, fs), pos);
            const T a1 = div_rn(mul_rn(Pi<T>::two, tmp), wt);
            const T a2 = div_rn(mul_rn(Pi<T>::four, tmp), wt);
            a[e] = T(0.42) + T(0.5) * cos_t(a1) + T(0.08) * cos_t(a2);
          }
        }
        st4(ws + 4 + 4 * c, a);
      }
      if (t == 0) {
        ws[3] = T(0);
        ws[4 + 4 * live] = T(0);
      }
      __syncthreads();
      // x w and x dw (dw the centred difference), the index recomputed
      for (int c = t; c < live; c += NT) {
        const int j0 = 4 * c;
        T m[4] = {T(0), T(0), T(0), T(0)}, d[4] = {T(0), T(0), T(0), T(0)};
        T wv[6];  // the window at j0-1 .. j0+4
        wv[0] = ws[3 + j0];
        ld4(ws + 4 + j0, wv + 1);
        wv[5] = ws[8 + j0];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + e < ne) {
            const long long idx = index(j0 + e);
            const T xs = xr[min(max(idx, 0LL), (long long)L - 1)];
            m[e] = xs * wv[e + 1];
            d[e] = xs * (-(wv[e + 2] - wv[e]) / T(2));
          }
        }
        put4(o1, j0, W, vec, m);
        put4(o2, j0, W, vec, d);
      }
      __syncthreads();  // the window is read before the next frame's lands
    } else {
      // the reductions' words, a set for odd and one for even frames (a
      // frame has a barrier, so no warp is two frames ahead of another)
      __shared__ T red[2][3][2][NT / 32];
      // float64 (STAGED) keeps the window in shared memory, each thread's
      // own chunks there (no barrier), and computes a windowed sample again
      // where it is needed: a block then holds no row in registers, and
      // enough frames are in flight to hide the float64 cosines
      constexpr bool STAGED = sizeof(T) == 8;
      extern __shared__ __align__(16) unsigned char smem_raw[];
      T* ws = reinterpret_cast<T*>(smem_raw);  // ws[j]: the window (STAGED)
      // thread t's chunks are c = t + NT i; the first `kl` of them hold
      // window samples, and only those are computed
      const int kl = t < live ? (live - 1 - t) / NT + 1 : 0;
      // the rows past the window first: zeros, on their way to memory
      // while the window is computed
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = t + NT * i;
        if (c >= nq) break;
        if (i >= kl) {
          put4(o1, 4 * c, W, vec, zero);
          if (MODE == CENTROID) put4(o2, 4 * c, W, vec, zero);
        }
      }
      const T f0 = f0v[r];
      T wr[STAGED ? 1 : 4 * K], vr[STAGED ? 1 : 4 * K];
      // the window at chunk i's sample e
      auto wat = [&](int i, int e) -> T& {
        if constexpr (STAGED) return ws[4 * (t + NT * i) + e];
        else return wr[4 * i + e];
      };
      // the windowed sample, plus the reference's noise where there is one
      auto wave = [&](int i, int e) -> T {
        const int j = 4 * (t + NT * i) + e;
        T a = T(0);
        if (j < ne) {
          a = xr[min(max(o - h + j, 0), L - 1)] * wat(i, e);
          if (nz) a = a + nz[j] * T(1e-12);
        }
        return a;
      };
      T s[2] = {T(0), T(0)};  // sum w, sum w^2
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= kl) break;
        const T jh0 = (T)(4 * (t + NT * i) - h);  // the chunk's first j - h
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * (t + NT * i) + e;
          const T a =
              j < ne ? window_at<T, BLACKMAN>(jh0 + T(e), f0, fs, ratio)
                     : T(0);
          wat(i, e) = a;
          s[0] += a;
          s[1] += a * a;
        }
      }
      if (MODE == CHEAPTRICK) {  // w / sqrt(sum w^2), then sums of new w
        T q[1] = {s[1]};
        block_sums<NT>(q, red[it & 1][0]);
        const T nrm = sqrt_t(q[0]);
        s[0] = T(0);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i >= kl) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T a = wat(i, e) / nrm;
            wat(i, e) = a;
            s[0] += a;
          }
        }
      }
      s[1] = T(0);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= kl) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T a = wave(i, e);
          if constexpr (!STAGED) vr[4 * i + e] = a;
          s[1] += a;
        }
      }
      block_sums<NT>(s, red[it & 1][1]);
      const T coef = s[1] / s[0];
      // the mean-removed sample
      auto centred = [&](int i, int e) -> T {
        const int j = 4 * (t + NT * i) + e;
        if (j >= ne) return T(0);
        if constexpr (STAGED) return wave(i, e) - wat(i, e) * coef;
        else return vr[4 * i + e] - wat(i, e) * coef;
      };
      T nrm = T(1);
      if (MODE == CENTROID) {  // unit energy; second row weighted by j+1
        T sq[1] = {T(0)};
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i >= kl) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T a = centred(i, e);
            sq[0] += a * a;
          }
        }
        block_sums<NT>(sq, red[it & 1][2]);
        nrm = sqrt_t(sq[0]);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= kl) break;
        const int j0 = 4 * (t + NT * i);
        const T j1 = (T)(j0 + 1);  // the weight of sample j0, exact
        T a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = MODE == CENTROID ? centred(i, e) / nrm : centred(i, e);
          b[e] = a[e] * (j1 + T(e));
        }
        put4(o1, j0, W, vec, a);
        if (MODE == CENTROID) put4(o2, j0, W, vec, b);
      }
      // past the window CENTROID's rows hold 0 / nrm, as the twin's
      // division of the whole row gives them: NaN where the row has no
      // energy
      const T z = T(0) / nrm;
      if (MODE == CENTROID && z != T(0)) {
        const T zz[4] = {z, z, z, z};
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int c = t + NT * i;
          if (c >= nq) break;
          if (i >= kl) {
            put4(o1, 4 * c, W, vec, zz);
            put4(o2, 4 * c, W, vec, zz);
          }
        }
      }
    }
  }
}

template <typename T, int MODE, bool BLACKMAN, int NT, int K>
void launch(const void* x, int L, int T_, const int* rowutt,
            const int* origin, const int* h, const void* f0, const void* pos,
            double fs, double ratio, int rows, int W, const void* noise,
            const long long* noff, void* out1, void* out2, cudaStream_t s) {
  // STONEMASK's window, or float64's (each chunk's four values)
  const size_t smem = MODE == STONEMASK || MODE == STONEMASK_ROUNDED
                          ? (size_t)(W + 8) * sizeof(T)
                          : sizeof(T) == 8 ? (size_t)(W + 3) / 4 * 4 * 8 : 0;
  // as many blocks as fit on the card at once, each working its frames in
  // turn
  auto kern = frame_window_kernel<T, MODE, BLACKMAN, NT, K>;
  int dev = 0, sms = 0, fit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, NT, smem);
  kern<<<max(1, min(rows, sms * fit)), NT, smem, s>>>(
      static_cast<const T*>(x), L, T_, rowutt, origin, h,
      static_cast<const T*>(f0), static_cast<const T*>(pos), (T)fs, (T)ratio,
      rows, W, static_cast<const T*>(noise), noff, static_cast<T*>(out1),
      static_cast<T*>(out2));
}

// The block shape of a mode with sums: NT threads of K chunks of four,
// the fewest that hold W samples, at most 4 chunks a thread (16 values,
// twice in float32: the window and the samples).  `frames.window_plan`
// copies it for the CPU's emulation; the card tests hold the two alike.
void plan_of(int W, int* nt, int* k) {
  const int nq = (W + 3) / 4;
  *k = nq <= 128 * 2 ? 2 : 4;
  *nt = nq <= 128 * 4 ? 128 : nq <= 256 * 4 ? 256 : nq <= 512 * 4 ? 512
                                                                  : 1024;
}

template <typename T, int MODE, bool BLACKMAN>
void launch_sized(const void* x, int L, int T_, const int* rowutt,
                  const int* origin, const int* h, const void* f0,
                  const void* pos, double fs, double ratio, int rows, int W,
                  const void* noise, const long long* noff, void* out1,
                  void* out2, cudaStream_t s) {
#define FW_LAUNCH(NT, K)                                                     \
  launch<T, MODE, BLACKMAN, NT, K>(x, L, T_, rowutt, origin, h, f0, pos, fs, \
                                   ratio, rows, W, noise, noff, out1, out2, s)
  int nt = 0, k = 0;
  plan_of(W, &nt, &k);
  if (k == 2) FW_LAUNCH(128, 2);
  else if (nt == 128) FW_LAUNCH(128, 4);
  else if (nt == 256) FW_LAUNCH(256, 4);
  else if (nt == 512) FW_LAUNCH(512, 4);
  // float64 rows stop at 46 KB, 1472 chunks
  else if constexpr (sizeof(T) == 4) FW_LAUNCH(1024, 4);
#undef FW_LAUNCH
}

template <typename T>
int dispatch(const void* x, int L, int T_, const int* rowutt,
             const int* origin, const int* h, const void* f0,
             const void* pos, double fs, double ratio, int rows, int W,
             int mode, const void* noise, const long long* noff, void* out1,
             void* out2, cudaStream_t s) {
  // 46 KB a row (STONEMASK's and float64's windows in shared memory)
  if ((size_t)W * sizeof(T) > 46 * 1024) return (int)cudaErrorInvalidValue;
  if (mode == STONEMASK)
    launch<T, STONEMASK, true, 128, 1>(x, L, T_, rowutt, origin, h, f0, pos,
                                       fs, ratio, rows, W, noise, noff, out1,
                                       out2, s);
  else if (mode == STONEMASK_ROUNDED)
    launch<T, STONEMASK_ROUNDED, true, 128, 1>(x, L, T_, rowutt, origin, h,
                                               f0, pos, fs, ratio, rows, W,
                                               noise, noff, out1, out2, s);
  else if (mode == MEAN_BLACKMAN)
    launch_sized<T, MEAN, true>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                                ratio, rows, W, noise, noff, out1, out2, s);
  else if (mode == MEAN)
    launch_sized<T, MEAN, false>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                                 ratio, rows, W, noise, noff, out1, out2, s);
  else if (mode == CHEAPTRICK)
    launch_sized<T, CHEAPTRICK, false>(x, L, T_, rowutt, origin, h, f0, pos,
                                       fs, ratio, rows, W, noise, noff, out1,
                                       out2, s);
  else if (mode == CENTROID)
    launch_sized<T, CENTROID, true>(x, L, T_, rowutt, origin, h, f0, pos, fs,
                                    ratio, rows, W, noise, noff, out1, out2,
                                    s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L), per row: utterance (rowutt, or r / T when null), centre, half
// length, f0 and position; noise (the stream) and noff (each row's first
// draw, < 0 for a row without noise) or null; f64: 0 for float tensors, 1
// for double.
// The block of a mode with sums at width W: NT threads, K chunks a thread
extern "C" void frame_window_plan(int W, int* nt, int* k) {
  plan_of(W, nt, k);
}

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
