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
//
// A template on the scalar type: float for the fast path, double for the
// parity analysis (the JAX package's f64 DIO), the same steps in each.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ T select_best(T current, T past, const T* c,
                                         int bands, int nT, T allowed) {
  const T ref = (current * T(3) - past) / T(2);
  int bi = 0;
  T be = abs_t(ref - c[0]);
  for (int b = 1; b < bands; ++b) {
    const T e = abs_t(ref - c[(size_t)b * nT]);
    if (e < be) {
      be = e;
      bi = b;
    }
  }
  const T best = c[(size_t)bi * nT];
  const T rel = abs_t(T(1) - best / ref);
  return (rel <= allowed && ref != T(0)) ? best : T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fix_f0_kernel(const T* __restrict__ best, const T* __restrict__ cands,
              int bands, int nT, int vrm, T allowed, T* __restrict__ scratch,
              T* __restrict__ out) {
  const int u = blockIdx.x, tid = threadIdx.x;
  const T* bu = best + (size_t)u * nT;
  const T* cu = cands + (size_t)u * bands * nT;
  T* s1 = scratch + (size_t)u * 2 * nT;
  T* s2 = s1 + nT;
  T* o = out + (size_t)u * nT;
  if (nT <= vrm) {
    for (int i = tid; i < nT; i += THREADS) o[i] = T(0);
    return;
  }
  // Step 1 (dio.cpp:132-150): zero the edges, kill jumps
  for (int i = tid; i < nT; i += THREADS) {
    const T base = (i < vrm || i >= nT - vrm) ? T(0) : bu[i];
    const int k = i - 1;
    const T prev = (k < vrm || k >= nT - vrm) ? T(0) : bu[k];
    const T jump = abs_t((base - prev) / (T(1e-12) + base));
    s1[i] = (i >= vrm && jump < allowed) ? base : T(0);
  }
  __syncthreads();
  // Step 2 (dio.cpp:156-169): zero any frame with a zero within +-center
  const int center = (vrm - 1) / 2;
  for (int i = tid; i < nT; i += THREADS) {
    bool kill = false;
    if (i >= center && i < nT - center)
      for (int k = -center; k <= center; ++k) kill |= s1[i + k] == T(0);
    s2[i] = kill ? T(0) : s1[i];
  }
  __syncthreads();
  if (tid != 0) return;
  // Step 3 (dio.cpp:215-231): forward extension from negative boundaries
  bool active = false;
  T p1 = s2[0], p2 = T(0);
  o[0] = s2[0];
  for (int j = 0; j + 1 < nT; ++j) {
    active = active || (s2[j] != T(0) && s2[j + 1] == T(0));
    const T v = active ? select_best(p1, p2, cu + j + 1, bands, nT, allowed)
                       : s2[j + 1];
    o[j + 1] = v;
    active = active && v != T(0);
    p2 = p1;
    p1 = v;
  }
  // Step 4 (dio.cpp:237-253): backward extension from positive boundaries
  active = false;
  p1 = o[nT - 1];
  p2 = T(0);
  for (int j = nT - 2; j >= 0; --j) {
    active = active || (s2[j + 1] != T(0) && s2[j] == T(0));
    const T v = active ? select_best(p1, p2, cu + j, bands, nT, allowed)
                       : o[j];
    o[j] = v;
    active = active && v != T(0);
    p2 = p1;
    p1 = v;
  }
}

}  // namespace

// f64: 0 for float tensors (best, cands, scratch, out), 1 for double.
extern "C" int fix_f0_launch(const void* best, const void* cands, int B,
                             int bands, int T, int vrm, double allowed,
                             int f64, void* scratch, void* out,
                             cudaStream_t s) {
  if (B > 0) {
    if (f64)
      fix_f0_kernel<double><<<B, THREADS, 0, s>>>(
          static_cast<const double*>(best), static_cast<const double*>(cands),
          bands, T, vrm, allowed, static_cast<double*>(scratch),
          static_cast<double*>(out));
    else
      fix_f0_kernel<float><<<B, THREADS, 0, s>>>(
          static_cast<const float*>(best), static_cast<const float*>(cands),
          bands, T, vrm, (float)allowed, static_cast<float*>(scratch),
          static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
