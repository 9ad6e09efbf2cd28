// K12: the synth CLI's feature decode, (lf0, mgc, bap) -> (f0, sp, ap).
//
// Replaces hts_train_world_tpu/ops/codec.py:121-132 (decode_spectral_
// envelope: IDCT matmul -> boundary pad -> Hz-axis gather-lerp -> exp),
// :198-208 (mgc2sp_real: freqt matmul -> real FFT) and cli.py:58-71
// (decode_features: exp(lf0), mgc[0] -= 12, / 1e4, bap[0] += 9.210340,
// the odd-apl rule, exp / 1e4 on the first apl bins, zeros beyond).  On
// the TPU: two MXU matmuls, an FFT and XLA passes writing the (rows, N/2)
// mel rows and the (rows, N/2+1) cepstra to HBM.
//
// One block takes FR frames: it computes their IDCT rows into shared
// memory (each Dinv element loaded once serves all FR frames), pads them,
// lerps them onto the Hz axis and writes sp.  The bap decode is two linear
// maps, freqt then the real part of a DFT, so the host composes them into
// W (m + 1, apl) and the block applies it directly: no FFT.  f0 is exp
// in float64 rounded to f32, as the twin computes it.
//
// Bound: bytes, sp and ap written once (2 x 4 (N/2+1) bytes a frame); the
// IDCT's 2 x mgc_dim x N/2 operations a frame are of the same order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FR = 8;

__global__ void __launch_bounds__(THREADS)
codec_decode_kernel(const float* __restrict__ lf0,
                    const float* __restrict__ mgc,
                    const float* __restrict__ bap, int R, int Dm, int Db,
                    int H, const int* __restrict__ kt,
                    const float* __restrict__ st,
                    const float* __restrict__ dinv,
                    const float* __restrict__ w, int wr, int wc,
                    float* __restrict__ f0, float* __restrict__ sp,
                    float* __restrict__ ap) {
  extern __shared__ float smem[];
  const int M = H - 1;                 // N / 2
  const int W = M + 2;                 // padded mel row
  float* coded = smem;                 // FR x Dm, mgc with c0 - 12
  float* mel = smem + FR * Dm;         // FR x (M + 2)
  const int row0 = blockIdx.x * FR, tid = threadIdx.x;
  const float ln1e4 = (float)9.210340, inv_scale = (float)1e4;

  for (int i = tid; i < FR * Dm; i += THREADS) {
    const int f = i / Dm, d = i % Dm, r = row0 + f;
    float v = r < R ? mgc[(size_t)r * Dm + d] : 0.0f;
    if (d == 0) v = v - 12.0f;
    coded[i] = v;
  }
  if (tid < FR && row0 + tid < R) {
    const float l = lf0[row0 + tid];
    f0[row0 + tid] = l != 0.0f ? (float)exp((double)l) : 0.0f;
  }
  __syncthreads();
  for (int m = tid; m < M; m += THREADS) {
    float acc[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) acc[f] = 0.0f;
    for (int d = 0; d < Dm; ++d) {
      const float dv = dinv[(size_t)d * M + m];
#pragma unroll
      for (int f = 0; f < FR; ++f) acc[f] += coded[f * Dm + d] * dv;
    }
#pragma unroll
    for (int f = 0; f < FR; ++f) mel[f * W + m + 1] = acc[f];
  }
  __syncthreads();
  if (tid < FR) {                      // boundary duplication
    mel[tid * W] = mel[tid * W + 1];
    mel[tid * W + M + 1] = mel[tid * W + M];
  }
  __syncthreads();
  for (int i = tid; i < FR * H; i += THREADS) {
    const int f = i / H, h = i % H, r = row0 + f;
    if (r >= R) continue;
    const int k = kt[h];
    const float* row = mel + f * W;
    const float v0 = row[k - 1], v1 = row[k < W - 1 ? k : W - 1];
    const float x = v0 + st[h] * (v1 - v0);
    sp[(size_t)r * H + h] = expf(x / (float)M) / inv_scale;
    float a = 0.0f;
    if (h < wc) {
      const float* b = bap + (size_t)r * Db;
      float acc = (b[0] + ln1e4) * w[h];
      for (int j = 1; j < wr; ++j) acc += b[j] * w[(size_t)j * wc + h];
      a = expf(acc) / inv_scale;
    }
    ap[(size_t)r * H + h] = a;
  }
}

}  // namespace

extern "C" int codec_decode_launch(const float* lf0, const float* mgc,
                                   const float* bap, int R, int Dm, int Db,
                                   int H, const int* kt, const float* st,
                                   const float* dinv, const float* w, int wr,
                                   int wc, float* f0, float* sp, float* ap,
                                   cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  if (H < 3 || Dm < 1 || wr < 1 || wr > Db || wc >= H)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)FR * (Dm + H + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        codec_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  codec_decode_kernel<<<(R + FR - 1) / FR, THREADS, smem, s>>>(
      lf0, mgc, bap, R, Dm, Db, H, kt, st, dinv, w, wr, wc, f0, sp, ap);
  return (int)cudaGetLastError();
}
