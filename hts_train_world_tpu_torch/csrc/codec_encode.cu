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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FR_MAX = 8;

__global__ void __launch_bounds__(THREADS)
codec_encode_kernel(const float* __restrict__ sp, const float* __restrict__ ap,
                    int R, int n, const int* __restrict__ kt,
                    const float* __restrict__ st, int M, int fr,
                    const float* __restrict__ dm, int n_m,
                    const float* __restrict__ db, int n_b,
                    float* __restrict__ mgc, float* __restrict__ bap) {
  extern __shared__ float smem[];
  float* mel_s = smem;                        // fr x M
  float* mel_a = mel_s + (size_t)fr * M;      // fr x M
  const int row0 = blockIdx.x * fr, tid = threadIdx.x;

  // mel-log rows of the block's frames, sp then ap, in one flat pass: each
  // entry takes the log of its two neighbouring bins (floored and scaled
  // as the twin does) and lerps between them
  for (int idx = tid; idx < 2 * fr * M; idx += THREADS) {
    const int which = idx / (fr * M), f = (idx / M) % fr, m = idx % M;
    const int r = row0 + f;
    float v = 0.f;
    if (r < R) {
      const float* x = (which == 0 ? sp : ap) + (size_t)r * n;
      const int k = kt[m];
      float u0 = x[k - 1] * 1e4f, u1 = x[min(k, n - 1)] * 1e4f;
      if (which == 0) {  // sp's zero floor
        if (u0 == 0.f) u0 = 1e-4f;
        if (u1 == 0.f) u1 = 1e-4f;
      }
      const float v0 = logf(u0), v1 = logf(u1);
      v = v0 + st[m] * (v1 - v0);
    }
    (which == 0 ? mel_s : mel_a)[(size_t)f * M + m] = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < n_m + n_b; d += WARPS) {
    const bool is_m = d < n_m;
    const float* drow = is_m ? dm + (size_t)d * M : db + (size_t)(d - n_m) * M;
    const float* mel = is_m ? mel_s : mel_a;
    float acc[FR_MAX];
#pragma unroll
    for (int f = 0; f < FR_MAX; ++f) acc[f] = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float dv = drow[m];
#pragma unroll
      for (int f = 0; f < FR_MAX; ++f)
        if (f < fr) acc[f] += mel[(size_t)f * M + m] * dv;
    }
#pragma unroll
    for (int f = 0; f < FR_MAX; ++f) {
      if (f >= fr) break;
      const float v = warp_sum(acc[f]);
      const int r = row0 + f;
      if (lane == 0 && r < R) {
        if (is_m) {
          mgc[(size_t)r * n_m + d] = d == 0 ? v + 12.0f : v;
        } else {
          const int e = d - n_m;
          float o = v;
          if (e == 0) {
            o = v - 9.210340f;  // LN_1E4, the CLIs' literal
            if (o > 0.f && o < 1e-4f) o = 0.f;
          }
          bap[(size_t)r * n_b + e] = o;
        }
      }
    }
  }
}

}  // namespace

extern "C" int codec_encode_launch(const float* sp, const float* ap, int R,
                                   int n, const int* kt, const float* st,
                                   int M, const float* dm, int n_m,
                                   const float* db, int n_b, float* mgc,
                                   float* bap, cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  const size_t budget = 200 * 1024;
  int fr = (int)(budget / (2 * (size_t)M * sizeof(float)));
  fr = fr > FR_MAX ? FR_MAX : fr;
  if (fr < 1 || n != M + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)fr * M * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      codec_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (R + fr - 1) / fr;
  codec_encode_kernel<<<blocks, THREADS, smem, s>>>(sp, ap, R, n, kt, st, M,
                                                    fr, dm, n_m, db, n_b, mgc,
                                                    bap);
  return (int)cudaGetLastError();
}
