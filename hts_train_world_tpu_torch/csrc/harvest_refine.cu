// K15: Harvest's refinement of every (1 ms frame, candidate) pair, one
// block per (utterance, frame), one warp per non-zero candidate.
//
// Replaces hts_train_world_tpu/ops/harvest.py:320-425 (_refine_all_slab)
// and :428-535 (refine_all); GetRefinedF0, harvest.cpp:589-617 in WORLD.
// The TPU formulation formed the whole 1024-point DFT of every pair's
// windowed slab row (four 384 x 513 matmuls per frame) and then read 6
// bins at stride r = B/B_c.  Here a warp evaluates only the <= 6 bins the
// readout uses, for the Blackman-windowed segment and its derivative
// window: sum_j x[j] w[j] e^{-2 pi i (idx*j mod B)/B}, with the phase index
// reduced exactly in integers and looked up in a float64-built table of B
// entries, rounded to the kernel's type.  Every integer of the pair (h,
// e_c, B_c, base0, nh, the bins) is formed in the twin's order (true
// divisions, accurate cosf, --fmad=false): a window moved by one sample
// is another spectrum.
// The window's time axis is formed in float64 and rounded once, as the C
// forms it in double.  The window is indexed from its first sample; |X|^2
// and Im(conj(X) D) do not depend on where it sits.  Zero candidates are
// skipped, so the work is that of the non-zero pairs.
//
// Bound: operations (per pair 2h+1 samples x (2 cosf + 6 bins x 4 FMAs));
// the decimated rows and the candidate fields are read once.
//
// The kernel is a template on the scalar type.  float64 is the parity
// analysis' Harvest: the twin's float64 form (the JAX package's f64
// path takes a full rfft at B of each clipped window; the six bins it
// reads are these sums), with every integer rounded as the twin rounds it
// (IEEE divisions, the table of B entries in float64).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// a constant in each type: the float instantiation keeps its literals
template <typename T> struct K;
template <> struct K<float> {
  static constexpr float LOG2 = 0.69314718055994529f;
  static constexpr float GUARD = 1e-12f;
  static constexpr float TWO_PI = 6.283185307179586f;
  static constexpr float FOUR_PI = 12.566370614359172f;
  static constexpr float MS = 0.001f;
  static constexpr float B0 = 0.42f, B1 = 0.5f, B2 = 0.08f;
  static constexpr float SCORE_MIN = 2.5f;
};
template <> struct K<double> {
  static constexpr double LOG2 = 0.69314718055994529;
  static constexpr double GUARD = 1e-12;
  static constexpr double TWO_PI = 6.283185307179586;
  static constexpr double FOUR_PI = 12.566370614359172;
  static constexpr double MS = 0.001;
  static constexpr double B0 = 0.42, B1 = 0.5, B2 = 0.08;
  static constexpr double SCORE_MIN = 2.5;
};

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }
__device__ __forceinline__ float trunc_t(float a) { return truncf(a); }
__device__ __forceinline__ double trunc_t(double a) { return trunc(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ int matlab_round(T x) {
  return (int)trunc_t(x > T(0) ? x + T(0.5) : x - T(0.5));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_refine_kernel(const T* __restrict__ y, const T* __restrict__ cands,
                      int L, int nT, int NC, int h_cap, int B,
                      const T* __restrict__ tab, T fs8, T f0_floor,
                      T f0_ceil, T* __restrict__ refined,
                      T* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smw = reinterpret_cast<T*>(smem_raw);  // per warp: the window, 2h+1
  const int ut = blockIdx.x, u = ut / nT, t = ut % nT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 2 * h_cap + 1;
  T* mw = smw + warp * (W + 2);
  const T* yr = y + (size_t)u * L;
  const T* crow = cands + (size_t)ut * NC;
  const T* cos_tab = tab;
  const T* sin_tab = tab + B;
  const T pos = (T)t * K<T>::MS;
  const double tpos = (double)t * 0.001;
  for (int c = warp; c < NC; c += WARPS) {
    const T f0 = crow[c];
    T rf = T(0), sc = T(0);
    // the pair's integers, in the twin's order; a window longer than the
    // plan's longest (f0 below the floor) is refused
    const int h = f0 > T(0) ? (int)(div_rn(T(1.5) * fs8, f0) + T(1)) : 0;
    if (f0 > T(0) && h <= h_cap) {
      const int e_c =
          (int)floor_t(div_rn(log_t((T)h * T(2) + T(1)), K<T>::LOG2));
      const int Bc = 4 << e_c;
      const int base0 = matlab_round(
          (pos + div_rn((T)(-h), fs8)) * fs8 + K<T>::MS);
      const int first = base0 - 1;
      const int nh = min((int)div_rn(fs8 / T(2), f0), 6);
      const T wt = div_rn(T(2) * (T)h + T(1), fs8);
      int idx_c[6];
      const T fb = div_rn(f0 * (T)Bc, fs8);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        idx_c[k] = min(max(matlab_round(fb * (T)(k + 1)), 0), Bc / 2);
      const int r = B / Bc;
      // the Blackman window over the 2h+1 samples
      for (int j = lane; j <= 2 * h; j += 32) {
        // the time axis in float64, rounded once (see the twin)
        const T tmp =
            (T)(__ddiv_rn((double)(first + j), (double)fs8) - tpos);
        mw[j + 1] = K<T>::B0 +
                    K<T>::B1 * cos_t(div_rn(K<T>::TWO_PI * tmp, wt)) +
                    K<T>::B2 * cos_t(div_rn(K<T>::FOUR_PI * tmp, wt));
      }
      if (lane == 0) {
        mw[0] = T(0);
        mw[2 * h + 2] = T(0);
      }
      __syncwarp();
      T acc[24];
#pragma unroll
      for (int k = 0; k < 24; ++k) acc[k] = T(0);
      for (int j = lane; j <= 2 * h; j += 32) {
        const T x = yr[min(max(first + j, 0), L - 1)];
        const T xm = x * mw[j + 1];
        const T xd = x * (-(mw[j + 2] - mw[j]) / T(2));
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int ph = (int)(((long long)idx_c[k] * r * j) % B);
          const T cs = __ldg(cos_tab + ph), sn = __ldg(sin_tab + ph);
          acc[4 * k] += xm * cs;
          acc[4 * k + 1] -= xm * sn;
          acc[4 * k + 2] += xd * cs;
          acc[4 * k + 3] -= xd * sn;
        }
      }
#pragma unroll
      for (int k = 0; k < 24; ++k)
        for (int o = 16; o > 0; o >>= 1)
          acc[k] += __shfl_xor_sync(FULL, acc[k], o);
      // the IF readout of the six bins (harvest.cpp:600-617)
      T num = T(0), den = T(0), ssum = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const T smr = acc[4 * k], smi = acc[4 * k + 1];
        const T sdr = acc[4 * k + 2], sdi = acc[4 * k + 3];
        const T p = smr * smr + smi * smi;
        const T nm = smr * sdi - smi * sdr;
        const T kf = (T)(k + 1);
        const T inst =
            p == T(0) ? T(0)
                      : div_rn((T)idx_c[k] * fs8, (T)Bc) +
                            div_rn(div_rn(nm, p) * fs8, K<T>::TWO_PI);
        const T amp = sqrt_t(p);
        const T m = k < nh ? T(1) : T(0);
        num += amp * inst * m;
        den += amp * kf * m;
        ssum += abs_t(div_rn(div_rn(inst, kf) - f0, f0)) * m;
      }
      rf = div_rn(num, den + K<T>::GUARD);
      sc = div_rn(T(1), div_rn(ssum, (T)nh) + K<T>::GUARD);
      if (rf < f0_floor || rf > f0_ceil || sc < K<T>::SCORE_MIN)
        rf = sc = T(0);
      __syncwarp();  // mw is rewritten by the warp's next candidate
    }
    if (lane == 0) {
      refined[(size_t)ut * NC + c] = rf;
      scores[(size_t)ut * NC + c] = sc;
    }
  }
}

template <typename T>
int launch(const void* y, const void* cands, int Bt, int L, int nT, int NC,
           int h_cap, int B, const void* tab, double fs8, double f0_floor,
           double f0_ceil, void* refined, void* scores, cudaStream_t s) {
  const size_t smem = (size_t)WARPS * (2 * h_cap + 3) * sizeof(T);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_refine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_refine_kernel<T><<<Bt * nT, THREADS, smem, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(cands), L, nT, NC,
      h_cap, B, static_cast<const T*>(tab), (T)fs8, (T)f0_floor, (T)f0_ceil,
      static_cast<T*>(refined), static_cast<T*>(scores));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors (y, cands, tab, refined, scores), 1 for
// double.
extern "C" int harvest_refine_launch(const void* y, const void* cands,
                                     int Bt, int L, int T, int NC, int h_cap,
                                     int B, const void* tab, double fs8,
                                     double f0_floor, double f0_ceil, int f64,
                                     void* refined, void* scores,
                                     cudaStream_t s) {
  if (Bt <= 0 || T <= 0 || NC <= 0) return (int)cudaGetLastError();
  return f64 ? launch<double>(y, cands, Bt, L, T, NC, h_cap, B, tab, fs8,
                              f0_floor, f0_ceil, refined, scores, s)
             : launch<float>(y, cands, Bt, L, T, NC, h_cap, B, tab, fs8,
                             f0_floor, f0_ceil, refined, scores, s);
}
