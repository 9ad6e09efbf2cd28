// K35: SPTK's EXCITE -n -p shift, the pulse train of the SPTK engine.
//
// Replaces hts_train_world_tpu/ops/excitation.py:38-82 (_per_sample_pitch,
// excite), which on the TPU ran as whole-array passes: the per-sample
// period lerp between frames (no lerp through 0), freq = 1/period where
// voiced, raw = jnp.cumsum(freq), the onset base raw - freq forward-filled
// by a running max (associative_scan), phase = raw - base, and a pulse of
// sqrt(period) where floor(phase) steps; the noise where unvoiced.
//
// The pulse positions hang on rounding: at a period that divides exactly
// every wrap of the phase lands within rounding of an integer, so the
// cumulative sum must be the JAX package's bit for bit.  jnp.cumsum on the
// CPU is XLA's blocked scan (ops/prims.py xla_cumsum): blocks of 16 summed
// in sequence, the block totals scanned the same way recursively, each
// block's local sums plus the previous blocks' total.  This kernel runs
// that recursion level by level (a thread a block of 16 at each level,
// the levels' sums kept in `scratch`), then the running max of the onset
// bases (exact in any order: per-thread chunks and a scan of the chunk
// maxima), then the pulses.  raw - freq and raw - base are formed as
// written.  --fmad=false keeps the lerp's product and sum apart, as in
// the twin; the divisions and the sqrt are IEEE.  A block's running sum is
// kept in double and each output rounded to the type, as torch.cumsum
// does on the CPU (so the float instantiation matches its twin there too).
//
// Given the sampling rate (sr > 0), the frames hold lf0 (MAGIC unvoiced)
// and the kernel first turns them into periods as lf0_to_pitch does
// (SOPR -EXP -INV -m sr): sr / exp(lf0), with the exp in XLA's CPU form
// (ops/prims.py xla_exp, a Pade form on the reduced argument with its
// fused multiply-adds, here the device's fma, which rounds once) so the
// periods are the JAX package's bit for bit.  The engine's excitation is
// then this launch and K36's.
//
// One block of threads an utterance (the engine synthesises one at a
// time), a grid-stride loop over the n = (T-1) shift samples.
//
// Bound: bytes, but far from it.  The recursion's levels and the running
// max make ~6 passes over n samples inside one block; a block uses one SM
// of 132.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int BLK = 16;        // XLA_SCAN_BLOCK (ops/prims.py)
constexpr int MAX_LEVELS = 16;

__device__ __forceinline__ double bits(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

// exp as ops/prims.py xla_exp computes it (XLA's CPU exp for float64)
__device__ double xla_exp(double x) {
  const double lo = bits(0xC086232BDD7ABCD2ull);
  const double hi = bits(0x40862E42FEFA39EFull);
  const double xc = x < lo ? lo : (x > hi ? hi : x);
  const double n = floor(fma(xc, bits(0x3FF71547652B82FEull), 0.5));
  const double g = fma(-n, bits(0x3EB7F7D1CF79ABCAull),
                       fma(-n, bits(0x3FE62E4000000000ull), xc));
  const double gg = g * g;
  const double p = fma(fma(gg, bits(0x3F2089CDD5E44BE8ull),
                           bits(0x3F9F06D10CCA2C7Eull)), gg, 1.0) * g;
  const double q = fma(fma(fma(gg, bits(0x3EC92EB6BC365FA0ull),
                               bits(0x3F64AE39B508B6C0ull)), gg,
                           bits(0x3FCD17099887E074ull)), gg, 2.0);
  const double e = (p / (q - p)) * 2.0 + 1.0;
  const double ni = n < -2099.0 ? -2099.0 : (n > 2099.0 ? 2099.0 : n);
  const double b = floor(ni / 4.0);
  const double s = ldexp(1.0, (int)b);
  const double y = e * s * s * s * ldexp(1.0, (int)(ni - 3.0 * b));
  return x < lo ? 0.0 : (x > hi ? INFINITY : y);
}

template <typename T>
__device__ __forceinline__ T sample_period(const T* pitch,
                                           int Tn, int shift, long long i) {
  const T pos = (T)i / (T)shift;
  long long i0 = (long long)floor(pos);
  i0 = i0 < 0 ? 0 : (i0 > Tn - 2 ? Tn - 2 : i0);
  const T frac = pos - (T)i0;
  const T p0 = pitch[i0], p1 = pitch[i0 + 1];
  return (p0 > (T)0 && p1 > (T)0) ? p0 + (p1 - p0) * frac : p0;
}

template <typename T>
__device__ __forceinline__ T clamp_floor(T p) {
  const T lo = (T)1e-6;
  return p < lo ? lo : p;
}

template <typename T>
__device__ __forceinline__ T sample_freq(const T* pitch,
                                         int Tn, int shift, long long i) {
  const T p = sample_period(pitch, Tn, shift, i);
  return p > (T)0 ? (T)1 / clamp_floor(p) : (T)0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
excite_kernel(const T* __restrict__ frames, int Tn, int shift, double sr,
              const T* __restrict__ noise, T* __restrict__ scratch,
              T* __restrict__ out, bool* __restrict__ voiced_out) {
  __shared__ T cmax[THREADS];
  const long long n = (long long)(Tn - 1) * shift;
  // the levels' lengths and offsets in scratch, as _scan_levels gives them
  long long len[MAX_LEVELS], off[MAX_LEVELS];
  int nl = 1;
  len[0] = n;
  off[0] = 0;
  while (len[nl - 1] > BLK && nl < MAX_LEVELS) {
    len[nl] = (len[nl - 1] + BLK - 1) / BLK;
    off[nl] = off[nl - 1] + len[nl - 1];
    ++nl;
  }
  T* base = scratch + off[nl - 1] + len[nl - 1];
  // the periods: the frames themselves, or sr / exp(lf0) after `base`
  const T* pitch = frames;
  if (sr > 0.0) {
    T* per = base + n;
    for (int i = threadIdx.x; i < Tn; i += THREADS) {
      const double lf0 = (double)frames[i];
      per[i] = lf0 == -1.0e10 ? (T)0 : (T)(sr / xla_exp(lf0));
    }
    __syncthreads();
    pitch = per;
  }

  // up: each level's blocks of 16 summed in sequence, the totals one
  // level up; level 0 reads freq
  for (int l = 0; l < nl - 1; ++l) {
    T* cur = scratch + off[l];
    T* up = scratch + off[l + 1];
    for (long long b = threadIdx.x; b < len[l + 1]; b += THREADS) {
      const long long i0 = b * BLK;
      const long long i1 = i0 + BLK < len[l] ? i0 + BLK : len[l];
      double acc = l == 0 ? sample_freq(pitch, Tn, shift, i0) : cur[i0];
      cur[i0] = (T)acc;
      for (long long i = i0 + 1; i < i1; ++i) {
        acc = acc + (l == 0 ? sample_freq(pitch, Tn, shift, i) : cur[i]);
        cur[i] = (T)acc;
      }
      up[b] = (T)acc;
    }
    __syncthreads();
  }
  // the top level (at most 16) in sequence
  if (threadIdx.x == 0) {
    T* top = scratch + off[nl - 1];
    double acc = nl == 1 ? sample_freq(pitch, Tn, shift, 0) : top[0];
    top[0] = (T)acc;
    for (long long i = 1; i < len[nl - 1]; ++i) {
      acc = acc + (nl == 1 ? sample_freq(pitch, Tn, shift, i) : top[i]);
      top[i] = (T)acc;
    }
  }
  __syncthreads();
  // down: each block's local sums plus the total of the blocks before it
  for (int l = nl - 2; l >= 0; --l) {
    T* cur = scratch + off[l];
    const T* up = scratch + off[l + 1];
    for (long long i = BLK + threadIdx.x; i < len[l]; i += THREADS)
      cur[i] = cur[i] + up[i / BLK - 1];
    __syncthreads();
  }
  const T* raw = scratch;

  // the onset bases, forward-filled by a running max: per-thread chunks
  const long long chunk = (n + THREADS - 1) / THREADS;
  const long long c0 = threadIdx.x * chunk;
  const long long c1 = c0 + chunk < n ? c0 + chunk : n;
  T run = -INFINITY;
  bool prev_v = c0 > 0 && c0 < n &&
                sample_period(pitch, Tn, shift, c0 - 1) > (T)0;
  for (long long i = c0; i < c1; ++i) {
    const T p = sample_period(pitch, Tn, shift, i);
    const bool v = p > (T)0;
    const T f = v ? (T)1 / clamp_floor(p) : (T)0;
    const T b = (v && !prev_v) ? raw[i] - f : (T)0;
    run = b > run ? b : run;
    base[i] = run;
    prev_v = v;
  }
  cmax[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = -INFINITY;
    for (int j = 0; j < THREADS; ++j) {
      const T m = cmax[j];
      cmax[j] = acc;           // the maximum of the chunks before j
      acc = m > acc ? m : acc;
    }
  }
  __syncthreads();
  const T before = cmax[threadIdx.x];
  for (long long i = c0; i < c1; ++i)
    base[i] = before > base[i] ? before : base[i];
  __syncthreads();

  // pulses where floor(phase) steps, noise where unvoiced
  for (long long i = threadIdx.x; i < n; i += THREADS) {
    const T p = sample_period(pitch, Tn, shift, i);
    const bool v = p > (T)0;
    const T ph = raw[i] - base[i];
    const T ph_prev = i > 0 ? raw[i - 1] - base[i - 1] : (T)0;
    const bool fired = floor(ph) > floor(ph_prev);
    out[i] = v ? (fired ? sqrt(clamp_floor(p)) : (T)0) : noise[i];
    voiced_out[i] = v;
  }
}

template <typename T>
int launch(const void* frames, int Tn, int shift, double sr,
           const void* noise, void* scratch, void* out, bool* voiced,
           cudaStream_t s) {
  excite_kernel<T><<<1, THREADS, 0, s>>>(
      (const T*)frames, Tn, shift, sr, (const T*)noise, (T*)scratch,
      (T*)out, voiced);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (T,): the period per frame, or lf0 (MAGIC unvoiced) where sr > 0
// (float64 only); noise (n,), scratch (sum of the scan levels' lengths + n,
// + T where sr > 0), out (n,), voiced (n,) bool; n = (T-1) shift; f64
// picks double.
extern "C" int excite_launch(const void* frames, int T, int shift, double sr,
                             const void* noise, int f64, void* scratch,
                             void* out, bool* voiced, cudaStream_t s) {
  if (T < 2 || shift < 1 || (sr > 0.0 && !f64))
    return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(frames, T, shift, sr, noise, scratch, out,
                              voiced, s)
             : launch<float>(frames, T, shift, sr, noise, scratch, out,
                             voiced, s);
}
