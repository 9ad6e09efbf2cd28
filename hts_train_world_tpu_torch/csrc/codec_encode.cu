// K6: the feature encoder's spectral half, mgc and bap in one launch.
//
// Replaces hts_train_world_tpu/ops/codec.py:106-118 (code_spectral_envelope:
// log -> mel-axis gather-lerp -> DCT matmul) as cli.py:45-53 applies it to
// sp and ap (scale by 1e4, sp's zero floor, mgc[0] += 12, bap[0] -= LN_1E4
// with the small-positive snap).  On the TPU that was an XLA elementwise
// pass writing the (rows, N/2) mel-log rows and an MXU matmul reading them
// back.  Here one block takes FR frames: it forms their mel-log rows of sp
// and of ap in shared memory (log of the two neighbouring bins, then the
// lerp), and each warp then walks the DCT rows: one table element loaded
// from L2 serves all FR frames.  The mel rows never touch device memory.
//
// Bound: bytes and f32 operations about equal at the 48 kHz shapes (sp and
// ap read once, 2 x 4 x 1025 bytes per frame; 2 x 1024 x 75 operations per
// frame).  Built with --fmad=false so the lerp rounds like the plain twin's
// separate operations; the DCT sums in another order than cuBLAS, so the
// check holds it within 1e-5 of each row's largest value.
//
// A template on the scalar type: float for the feature lane, double for
// the `analysis` command's parity output (the JAX CLI under x64,
// cli.py:42-56), where the floor, logs, lerp, DCT sums and c0 fixes are
// all in double.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FR_MAX = 8;

// the CLIs' constants in each type (float: the float32 literals)
template <typename T> struct Lit;
template <> struct Lit<float> {
  static constexpr float ln1e4 = 9.210340f, scale = 1e4f, floor = 1e-4f,
                         c0 = 12.0f;
};
template <> struct Lit<double> {
  static constexpr double ln1e4 = 9.210340, scale = 1e4, floor = 1e-4,
                          c0 = 12.0;
};

__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
codec_encode_kernel(const T* __restrict__ sp, const T* __restrict__ ap,
                    int R, int n, const int* __restrict__ kt,
                    const T* __restrict__ st, int M, int fr,
                    const T* __restrict__ dm, int n_m,
                    const T* __restrict__ db, int n_b,
                    T* __restrict__ mgc, T* __restrict__ bap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* mel_s = reinterpret_cast<T*>(smem_raw);  // fr x M
  T* mel_a = mel_s + (size_t)fr * M;          // fr x M
  const int row0 = blockIdx.x * fr, tid = threadIdx.x;

  // mel-log rows of the block's frames, sp then ap, in one flat pass: each
  // entry takes the log of its two neighbouring bins (floored and scaled
  // as the twin does) and lerps between them
  for (int idx = tid; idx < 2 * fr * M; idx += THREADS) {
    const int which = idx / (fr * M), f = (idx / M) % fr, m = idx % M;
    const int r = row0 + f;
    T v = T(0);
    if (r < R) {
      const T* x = (which == 0 ? sp : ap) + (size_t)r * n;
      const int k = kt[m];
      T u0 = x[k - 1] * Lit<T>::scale, u1 = x[min(k, n - 1)] * Lit<T>::scale;
      if (which == 0) {  // sp's zero floor
        if (u0 == T(0)) u0 = Lit<T>::floor;
        if (u1 == T(0)) u1 = Lit<T>::floor;
      }
      const T v0 = log_t(u0), v1 = log_t(u1);
      v = v0 + st[m] * (v1 - v0);
    }
    (which == 0 ? mel_s : mel_a)[(size_t)f * M + m] = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < n_m + n_b; d += WARPS) {
    const bool is_m = d < n_m;
    const T* drow = is_m ? dm + (size_t)d * M : db + (size_t)(d - n_m) * M;
    const T* mel = is_m ? mel_s : mel_a;
    T acc[FR_MAX];
#pragma unroll
    for (int f = 0; f < FR_MAX; ++f) acc[f] = T(0);
    for (int m = lane; m < M; m += 32) {
      const T dv = drow[m];
#pragma unroll
      for (int f = 0; f < FR_MAX; ++f)
        if (f < fr) acc[f] += mel[(size_t)f * M + m] * dv;
    }
#pragma unroll
    for (int f = 0; f < FR_MAX; ++f) {
      if (f >= fr) break;
      const T v = warp_sum(acc[f]);
      const int r = row0 + f;
      if (lane == 0 && r < R) {
        if (is_m) {
          mgc[(size_t)r * n_m + d] = d == 0 ? v + Lit<T>::c0 : v;
        } else {
          const int e = d - n_m;
          T o = v;
          if (e == 0) {
            o = v - Lit<T>::ln1e4;  // LN_1E4, the CLIs' literal
            if (o > T(0) && o < Lit<T>::floor) o = T(0);
          }
          bap[(size_t)r * n_b + e] = o;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* sp, const void* ap, int R, int n, const int* kt,
           const void* st, int M, const void* dm, int n_m, const void* db,
           int n_b, void* mgc, void* bap, cudaStream_t s) {
  const size_t budget = 200 * 1024;
  int fr = (int)(budget / (2 * (size_t)M * sizeof(T)));
  fr = fr > FR_MAX ? FR_MAX : fr;
  if (fr < 1 || n != M + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)fr * M * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      codec_encode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (R + fr - 1) / fr;
  codec_encode_kernel<T><<<blocks, THREADS, smem, s>>>(
      static_cast<const T*>(sp), static_cast<const T*>(ap), R, n, kt,
      static_cast<const T*>(st), M, fr, static_cast<const T*>(dm), n_m,
      static_cast<const T*>(db), n_b, static_cast<T*>(mgc),
      static_cast<T*>(bap));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors (sp, ap, st, dm, db, mgc, bap), 1 for double.
extern "C" int codec_encode_launch(const void* sp, const void* ap, int R,
                                   int n, const int* kt, const void* st,
                                   int M, const void* dm, int n_m,
                                   const void* db, int n_b, int f64,
                                   void* mgc, void* bap, cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  return f64 ? launch<double>(sp, ap, R, n, kt, st, M, dm, n_m, db, n_b, mgc,
                              bap, s)
             : launch<float>(sp, ap, R, n, kt, st, M, dm, n_m, db, n_b, mgc,
                             bap, s);
}
