// K4: DIO's F0 contour fixing (FixStep1-4), one block per utterance.
//
// Replaces hts_train_world_tpu/ops/dio.py:137-195 (fix_f0_contour;
// dio.cpp:132-289 in WORLD).  On the TPU steps 3-4 were two lax.scans over
// frames with a walking-state carry; a PyTorch loop over frames would cost
// some 2*T tiny launches per batch.  Here steps 1-2 (elementwise: edge
// zeroing, jump kill, zero-neighbourhood kill) run across the block's
// threads, and thread 0 walks the forward and backward extensions (steps
// 3-4) in one launch, choosing among the band candidates at each frame
// exactly as SelectBestF0 (first minimum, strict <).
//
// Bound: latency of the sequential scans (2*T dependent steps per
// utterance); bytes and operations are tiny.  Built with --fmad=false:
// (current*3 - past)/2 must round like the plain twin's separate
// operations, since one ulp can flip the allowed-range test.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float select_best(float current, float past,
                                             const float* c, int bands,
                                             int T, float allowed) {
  const float ref = (current * 3.0f - past) / 2.0f;
  int bi = 0;
  float be = fabsf(ref - c[0]);
  for (int b = 1; b < bands; ++b) {
    const float e = fabsf(ref - c[(size_t)b * T]);
    if (e < be) {
      be = e;
      bi = b;
    }
  }
  const float best = c[(size_t)bi * T];
  const float rel = fabsf(1.0f - best / ref);
  return (rel <= allowed && ref != 0.0f) ? best : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
fix_f0_kernel(const float* __restrict__ best, const float* __restrict__ cands,
              int bands, int T, int vrm, float allowed,
              float* __restrict__ scratch, float* __restrict__ out) {
  const int u = blockIdx.x, tid = threadIdx.x;
  const float* bu = best + (size_t)u * T;
  const float* cu = cands + (size_t)u * bands * T;
  float* s1 = scratch + (size_t)u * 2 * T;
  float* s2 = s1 + T;
  float* o = out + (size_t)u * T;
  if (T <= vrm) {
    for (int i = tid; i < T; i += THREADS) o[i] = 0.f;
    return;
  }
  // Step 1 (dio.cpp:132-150): zero the edges, kill jumps
  for (int i = tid; i < T; i += THREADS) {
    const float base = (i < vrm || i >= T - vrm) ? 0.f : bu[i];
    const int k = i - 1;
    const float prev = (k < vrm || k >= T - vrm) ? 0.f : bu[k];
    const float jump = fabsf((base - prev) / (1e-12f + base));
    s1[i] = (i >= vrm && jump < allowed) ? base : 0.f;
  }
  __syncthreads();
  // Step 2 (dio.cpp:156-169): zero any frame with a zero within +-center
  const int center = (vrm - 1) / 2;
  for (int i = tid; i < T; i += THREADS) {
    bool kill = false;
    if (i >= center && i < T - center)
      for (int k = -center; k <= center; ++k) kill |= s1[i + k] == 0.f;
    s2[i] = kill ? 0.f : s1[i];
  }
  __syncthreads();
  if (tid != 0) return;
  // Step 3 (dio.cpp:215-231): forward extension from negative boundaries
  bool active = false;
  float p1 = s2[0], p2 = 0.f;
  o[0] = s2[0];
  for (int j = 0; j + 1 < T; ++j) {
    active = active || (s2[j] != 0.f && s2[j + 1] == 0.f);
    const float v = active ? select_best(p1, p2, cu + j + 1, bands, T, allowed)
                           : s2[j + 1];
    o[j + 1] = v;
    active = active && v != 0.f;
    p2 = p1;
    p1 = v;
  }
  // Step 4 (dio.cpp:237-253): backward extension from positive boundaries
  active = false;
  p1 = o[T - 1];
  p2 = 0.f;
  for (int j = T - 2; j >= 0; --j) {
    active = active || (s2[j + 1] != 0.f && s2[j] == 0.f);
    const float v = active ? select_best(p1, p2, cu + j, bands, T, allowed)
                           : o[j];
    o[j] = v;
    active = active && v != 0.f;
    p2 = p1;
    p1 = v;
  }
}

}  // namespace

extern "C" int fix_f0_launch(const float* best, const float* cands, int B,
                             int bands, int T, int vrm, float allowed,
                             float* scratch, float* out, cudaStream_t s) {
  if (B > 0)
    fix_f0_kernel<<<B, THREADS, 0, s>>>(best, cands, bands, T, vrm, allowed,
                                        scratch, out);
  return (int)cudaGetLastError();
}
