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
// reduced exactly in integers and looked up in a float64-built, f32-rounded
// table of B entries.  Every integer of the pair (h, e_c, B_c, base0, nh,
// the bins) is formed in the twin's f32 order (true divisions, accurate
// cosf, --fmad=false): a window moved by one sample is another spectrum.
// The window's time axis is formed in float64 and rounded once, as the C
// forms it in double.  The window is indexed from its first sample; |X|^2
// and Im(conj(X) D) do not depend on where it sits.  Zero candidates are
// skipped, so the work is that of the non-zero pairs.
//
// Bound: operations (per pair 2h+1 samples x (2 cosf + 6 bins x 4 FMAs));
// the decimated rows and the candidate fields are read once.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float K_LOG2 = 0.69314718055994529f;
constexpr float K_GUARD = 1e-12f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float FOUR_PI = 12.566370614359172f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int matlab_round(float x) {
  return (int)truncf(x > 0.f ? x + 0.5f : x - 0.5f);
}

__global__ void __launch_bounds__(THREADS)
harvest_refine_kernel(const float* __restrict__ y,
                      const float* __restrict__ cands, int L, int T, int NC,
                      int h_cap, int B,
                      const float* __restrict__ tab, float fs8, float f0_floor,
                      float f0_ceil, float* __restrict__ refined,
                      float* __restrict__ scores) {
  extern __shared__ float smw[];  // per warp: the Blackman window, 2h+1
  const int ut = blockIdx.x, u = ut / T, t = ut % T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 2 * h_cap + 1;
  float* mw = smw + warp * (W + 2);
  const float* yr = y + (size_t)u * L;
  const float* crow = cands + (size_t)ut * NC;
  const float* cos_t = tab;
  const float* sin_t = tab + B;
  const float pos = (float)t * 0.001f;
  const double tpos = (double)t * 0.001;
  for (int c = warp; c < NC; c += WARPS) {
    const float f0 = crow[c];
    float rf = 0.f, sc = 0.f;
    // the pair's integers, in the twin's f32 order; a window longer than
    // the plan's longest (f0 below the floor) is refused
    const int h = f0 > 0.f ? (int)(__fdiv_rn(1.5f * fs8, f0) + 1.0f) : 0;
    if (f0 > 0.f && h <= h_cap) {
      const int e_c =
          (int)floorf(__fdiv_rn(logf((float)h * 2.0f + 1.0f), K_LOG2));
      const int Bc = 4 << e_c;
      const int base0 = matlab_round(
          (pos + __fdiv_rn((float)(-h), fs8)) * fs8 + 0.001f);
      const int first = base0 - 1;
      const int nh = min((int)__fdiv_rn(fs8 / 2.0f, f0), 6);
      const float wt = __fdiv_rn(2.0f * (float)h + 1.0f, fs8);
      int idx_c[6];
      const float fb = __fdiv_rn(f0 * (float)Bc, fs8);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        idx_c[k] = min(max(matlab_round(fb * (float)(k + 1)), 0), Bc / 2);
      const int r = B / Bc;
      // the Blackman window over the 2h+1 samples
      for (int j = lane; j <= 2 * h; j += 32) {
        // the time axis in float64, rounded once (see the twin)
        const float tmp =
            (float)(__ddiv_rn((double)(first + j), (double)fs8) - tpos);
        mw[j + 1] = 0.42f + 0.5f * cosf(__fdiv_rn(TWO_PI * tmp, wt)) +
                    0.08f * cosf(__fdiv_rn(FOUR_PI * tmp, wt));
      }
      if (lane == 0) {
        mw[0] = 0.f;
        mw[2 * h + 2] = 0.f;
      }
      __syncwarp();
      float acc[24];
#pragma unroll
      for (int k = 0; k < 24; ++k) acc[k] = 0.f;
      for (int j = lane; j <= 2 * h; j += 32) {
        const float x = yr[min(max(first + j, 0), L - 1)];
        const float xm = x * mw[j + 1];
        const float xd = x * (-(mw[j + 2] - mw[j]) / 2.0f);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int ph = (int)(((long long)idx_c[k] * r * j) % B);
          const float cs = __ldg(cos_t + ph), sn = __ldg(sin_t + ph);
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
      float num = 0.f, den = 0.f, ssum = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float smr = acc[4 * k], smi = acc[4 * k + 1];
        const float sdr = acc[4 * k + 2], sdi = acc[4 * k + 3];
        const float p = smr * smr + smi * smi;
        const float nm = smr * sdi - smi * sdr;
        const float kf = (float)(k + 1);
        const float inst =
            p == 0.f ? 0.f
                     : __fdiv_rn((float)idx_c[k] * fs8, (float)Bc) +
                           __fdiv_rn(__fdiv_rn(nm, p) * fs8, TWO_PI);
        const float amp = sqrtf(p);
        const float m = k < nh ? 1.f : 0.f;
        num += amp * inst * m;
        den += amp * kf * m;
        ssum += fabsf(__fdiv_rn(__fdiv_rn(inst, kf) - f0, f0)) * m;
      }
      rf = __fdiv_rn(num, den + K_GUARD);
      sc = __fdiv_rn(1.0f, __fdiv_rn(ssum, (float)nh) + K_GUARD);
      if (rf < f0_floor || rf > f0_ceil || sc < 2.5f) rf = sc = 0.f;
      __syncwarp();  // mw is rewritten by the warp's next candidate
    }
    if (lane == 0) {
      refined[(size_t)ut * NC + c] = rf;
      scores[(size_t)ut * NC + c] = sc;
    }
  }
}

}  // namespace

extern "C" int harvest_refine_launch(const float* y, const float* cands,
                                     int Bt, int L, int T, int NC, int h_cap,
                                     int B, const float* tab, float fs8,
                                     float f0_floor, float f0_ceil,
                                     float* refined, float* scores,
                                     cudaStream_t s) {
  if (Bt <= 0 || T <= 0 || NC <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)WARPS * (2 * h_cap + 3) * sizeof(float);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      harvest_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harvest_refine_kernel<<<Bt * T, THREADS, smem, s>>>(
      y, cands, L, T, NC, h_cap, B, tab, fs8, f0_floor, f0_ceil, refined,
      scores);
  return (int)cudaGetLastError();
}
