// K10: each pulse's log spectra and noise segment, one block per pulse.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:154-175 (the frame lerp of
// |sp| and the clamped ap, as an interpolation-weight matmul on the TPU in
// fast mode, per pulse at :180-193 in the exact path), :177-194 (the
// periodic log spectrum and the unvoiced test) and :215-227 (the noise
// segment, its mean removed, and the aperiodic log spectrum), and the same
// per pulse of the streaming synthesizer (synthesis_rt.py:104-138).  On
// the TPU these were XLA passes writing each intermediate (sp_env, ap,
// apr, the masked noise, its mean) to HBM.  Here a block reads the two
// frame rows its pulse falls between and the stream segment once and
// writes only what the first transforms read: log_p and log_a (N/2+1
// each), the noise segment (N) and the unvoiced flag.
//
// A template on the scalar type: float for the fast path, double for the
// parity path, whose stream is the reference's reseeded PRNG prefix, one
// tensor read by every utterance of a batch (row stride 0).  The frame
// index is clamped to [0, T - 1] (the streaming synthesizer's clip; the
// batch's pulse times are never negative).  In double the positivity
// floor `tiny` is far below anything the logs see (a no-op, as the JAX
// package's tiny_floor is in f64).
//
// Bound: bytes, about 16 KB (f32) or 33 KB (f64) written per pulse at
// N = 2048.  The lerp and the logs are the twin's operations
// (--fmad=false); the logs are CUDA's and the segment mean sums in
// another order than the twin, so the check holds them within a few ulps.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T clamp_lo_hi(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);     // NaN passes, as torch.clamp
}

__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float floor_(float v) { return floorf(v); }
__device__ __forceinline__ double floor_(double v) { return floor(v); }
__device__ __forceinline__ float ceil_(float v) { return ceilf(v); }
__device__ __forceinline__ double ceil_(double v) { return ceil(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }

// The frame lerp (1 - f) a + f b and the guarded product e (1 - apr) +
// 1e-12: as the twin's separate operations, or (`fused`, the parity
// path) as the JAX exact path's compiled form rounds them, fma(f, b,
// (1 - f) a) and fma(e, 1 - apr, 1e-12): where ap is clipped near 1,
// 1 - apr^2 magnifies one ulp of the lerp ~1e12-fold.
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T f, bool fused) {
  return fused ? fma_(f, b, a * ((T)1 - f)) : a * ((T)1 - f) + b * f;
}
template <typename T>
__device__ __forceinline__ T guarded(T e, T w, T g, bool fused) {
  return fused ? fma_(e, w, g) : e * w + g;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
synth_pulse_spectra_kernel(const T* __restrict__ sp,
                           const T* __restrict__ ap, int nT, int H,
                           const T* __restrict__ stream, int S,
                           long long row_stride,
                           const T* __restrict__ ptime,
                           const T* __restrict__ vuv,
                           const long long* __restrict__ nsize,
                           const long long* __restrict__ noff, int P, int N,
                           T fp, T tiny, int fused, T* __restrict__ log_p,
                           T* __restrict__ log_a, T* __restrict__ noise,
                           bool* __restrict__ unvoiced) {
  __shared__ T red[32];
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P), tid = threadIdx.x;
  const T lo = (T)0.001, hi = (T)0.999999999999;
  const T guard = (T)1e-12;                   // kMySafeGuardMinimum

  // frame interpolation position (synthesis.cpp:140-178)
  const T pos = ptime[bp] / fp;
  const T last = (T)(nT - 1);
  T ffl = floor_(pos), fce = ceil_(pos);
  ffl = ffl > last ? last : (ffl < (T)0 ? (T)0 : ffl);
  fce = fce > last ? last : (fce < (T)0 ? (T)0 : fce);
  const long long fl = (long long)ffl, ce = (long long)fce;
  const T frac = pos - floor_(pos);
  const bool same = fl == ce;
  const T v = vuv[bp];
  const T* sa = sp + ((size_t)b * nT + fl) * H;
  const T* sb = sp + ((size_t)b * nT + ce) * H;
  const T* aa = ap + ((size_t)b * nT + fl) * H;
  const T* ab = ap + ((size_t)b * nT + ce) * H;
  T* lp = log_p + (size_t)bp * H;
  T* la = log_a + (size_t)bp * H;
  for (int h = tid; h < H; h += THREADS) {
    const T s0 = abs_(sa[h]), s1 = abs_(sb[h]);
    const T env = same ? s0 : lerp(s0, s1, frac, fused);
    const T a0 = clamp_lo_hi(aa[h], lo, hi);
    const T a1 = clamp_lo_hi(ab[h], lo, hi);
    T apr = same ? a0 : lerp(a0, a1, frac, fused);
    apr = apr * apr;
    if (h == 0) unvoiced[bp] = (v <= (T)0.5) || (apr > (T)0.999);
    lp[h] = log_(guarded(env, (T)1 - apr, guard, fused)) / (T)2;
    T e = v != (T)0 ? env * apr : env;
    e = e < tiny ? tiny : e;
    la[h] = log_(e) / (T)2;
  }

  // the noise segment (synthesis.cpp:38-68): the first ns draws from the
  // pulse's offset (zeros past the stream), mean removed, zero beyond ns
  const long long ns = nsize[bp], off = noff[bp];
  const T* st = stream + (size_t)b * row_stride;
  T* nz = noise + (size_t)bp * N;
  T part = (T)0;
  for (int k = tid; k < N; k += THREADS) {
    if (k < ns) {
      const long long i = off + k;
      part += (i >= 0 && i < S) ? st[i] : (T)0;
    }
  }
  const T avg = block_sum(part, red) / (T)(ns < 1 ? 1 : ns);
  for (int k = tid; k < N; k += THREADS) {
    T o = (T)0;
    if (k < ns) {
      const long long i = off + k;
      o = ((i >= 0 && i < S) ? st[i] : (T)0) - avg;
    }
    nz[k] = o;
  }
}

template <typename T>
int launch(const void* sp, const void* ap, int B, int nT, int H,
           const void* stream, int S, long long row_stride,
           const void* ptime, const void* vuv, const long long* nsize,
           const long long* noff, int P, int N, double fp, double tiny,
           int fused, void* log_p, void* log_a, void* noise, bool* unvoiced,
           cudaStream_t s) {
  synth_pulse_spectra_kernel<T><<<(unsigned)((long long)B * P), THREADS, 0,
                                  s>>>(
      static_cast<const T*>(sp), static_cast<const T*>(ap), nT, H,
      static_cast<const T*>(stream), S, row_stride,
      static_cast<const T*>(ptime), static_cast<const T*>(vuv), nsize, noff,
      P, N, (T)fp, (T)tiny, fused, static_cast<T*>(log_p),
      static_cast<T*>(log_a),
      static_cast<T*>(noise), unvoiced);
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float arrays, 1 for double; fp and tiny arrive as double and
// are rounded to the working type; stream row b starts at b * row_stride;
// fused: 1 for the exact path's fma lerps (see above).
extern "C" int synth_pulse_spectra_launch(
    const void* sp, const void* ap, int B, int T, int H, const void* stream,
    int S, long long row_stride, const void* ptime, const void* vuv,
    const long long* nsize, const long long* noff, int P, int N, double fp,
    double tiny, int f64, int fused, void* log_p, void* log_a, void* noise,
    bool* unvoiced, cudaStream_t s) {
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  if (T < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(sp, ap, B, T, H, stream, S, row_stride, ptime,
                              vuv, nsize, noff, P, N, fp, tiny, fused, log_p,
                              log_a, noise, unvoiced, s)
             : launch<float>(sp, ap, B, T, H, stream, S, row_stride, ptime,
                             vuv, nsize, noff, P, N, fp, tiny, fused, log_p,
                             log_a, noise, unvoiced, s);
}
