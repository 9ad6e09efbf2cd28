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
// W (m + 1, apl) and the block applies it directly: no FFT.
//
// A template on the scalar type: float for the fast path (f0 is exp in
// float64 rounded to f32, as the twin computes it), double for the parity
// path (the synth CLI's default, which reads the float32 files into
// float64 as the JAX CLI does under x64).  In double the composed W and
// the per-frame IDCT sums round differently from the twin's matmul and
// FFT, within a few float64 ulps of the log values (the check states the
// bound).
//
// Bound: bytes, sp and ap written once (2 (N/2+1) values a frame); the
// IDCT's 2 x mgc_dim x N/2 operations a frame are of the same order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FR = 8;

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
codec_decode_kernel(const T* __restrict__ lf0, const T* __restrict__ mgc,
                    const T* __restrict__ bap, int R, int Dm, int Db, int H,
                    const int* __restrict__ kt, const T* __restrict__ st,
                    const T* __restrict__ dinv, const T* __restrict__ w,
                    int wr, int wc, T* __restrict__ f0, T* __restrict__ sp,
                    T* __restrict__ ap) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int M = H - 1;                 // N / 2
  const int W = M + 2;                 // padded mel row
  T* coded = smem;                     // FR x Dm, mgc with c0 - 12
  T* mel = smem + FR * Dm;             // FR x (M + 2)
  const int row0 = blockIdx.x * FR, tid = threadIdx.x;
  const T ln1e4 = (T)9.210340, inv_scale = (T)1e4;

  for (int i = tid; i < FR * Dm; i += THREADS) {
    const int f = i / Dm, d = i % Dm, r = row0 + f;
    T v = r < R ? mgc[(size_t)r * Dm + d] : (T)0;
    if (d == 0) v = v - (T)12;
    coded[i] = v;
  }
  if (tid < FR && row0 + tid < R) {
    const T l = lf0[row0 + tid];
    f0[row0 + tid] = l != (T)0 ? (T)exp((double)l) : (T)0;
  }
  __syncthreads();
  for (int m = tid; m < M; m += THREADS) {
    T acc[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) acc[f] = (T)0;
    for (int d = 0; d < Dm; ++d) {
      const T dv = dinv[(size_t)d * M + m];
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
    const T* row = mel + f * W;
    const T v0 = row[k - 1], v1 = row[k < W - 1 ? k : W - 1];
    const T x = v0 + st[h] * (v1 - v0);
    sp[(size_t)r * H + h] = exp_(x / (T)M) / inv_scale;
    T a = (T)0;
    if (h < wc) {
      const T* b = bap + (size_t)r * Db;
      T acc = (b[0] + ln1e4) * w[h];
      for (int j = 1; j < wr; ++j) acc += b[j] * w[(size_t)j * wc + h];
      a = exp_(acc) / inv_scale;
    }
    ap[(size_t)r * H + h] = a;
  }
}

template <typename T>
int launch(const void* lf0, const void* mgc, const void* bap, int R, int Dm,
           int Db, int H, const int* kt, const void* st, const void* dinv,
           const void* w, int wr, int wc, void* f0, void* sp, void* ap,
           cudaStream_t s) {
  const size_t smem = (size_t)FR * (Dm + H + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        codec_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  codec_decode_kernel<T><<<(R + FR - 1) / FR, THREADS, smem, s>>>(
      static_cast<const T*>(lf0), static_cast<const T*>(mgc),
      static_cast<const T*>(bap), R, Dm, Db, H, kt,
      static_cast<const T*>(st), static_cast<const T*>(dinv),
      static_cast<const T*>(w), wr, wc, static_cast<T*>(f0),
      static_cast<T*>(sp), static_cast<T*>(ap));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float arrays and tables, 1 for double (kt stays int32).
extern "C" int codec_decode_launch(const void* lf0, const void* mgc,
                                   const void* bap, int R, int Dm, int Db,
                                   int H, const int* kt, const void* st,
                                   const void* dinv, const void* w, int wr,
                                   int wc, int f64, void* f0, void* sp,
                                   void* ap, cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  if (H < 3 || Dm < 1 || wr < 1 || wr > Db || wc >= H)
    return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(lf0, mgc, bap, R, Dm, Db, H, kt, st, dinv, w,
                              wr, wc, f0, sp, ap, s)
             : launch<float>(lf0, mgc, bap, R, Dm, Db, H, kt, st, dinv, w,
                             wr, wc, f0, sp, ap, s);
}
