// K3: the exact sum of the k largest entries of float32 rows, and the k-th
// largest value (the threshold), a warp (or a few) a row.
//
// Replaces hts_train_world_tpu/ops/prims.py:383-410 (sum_top_k), which on
// the TPU ran 32 masked reductions over the whole (rows, n) array.  The
// threshold is bit for bit that of the twin's 32-step bisection on the
// int32 patterns (prims.top_k_threshold_sum_plain), which ends on the k-th
// largest of the patterns each clamped into [-1, 0x7f7fffff] (clamping
// keeps the order): a row's +inf and NaN patterns count as the largest
// finite one, and negative patterns as -1, the bisection's floor (a NaN
// threshold where fewer than k patterns are >= +0).  The kernel selects
// on keys = clamped pattern + 1, unsigned in [0, 0x7f800000].  The sum is
// the masked sum of the values whose pattern lies above the threshold
// plus (k - count) copies of the threshold.
//
// Design.  A row's W warps (W = 1 up to n = 2051) read it once into
// registers: 16-byte loads of CH float4 a thread, a contiguous span of the
// row a thread (so one step of the histogram below sees values from all
// over the row, which spreads its atomics over more bins), the at most 3 +
// 3 floats before the first 16-byte boundary and after the last one as
// single loads, and the slots past the row set to -0 (pattern 0x80000000:
// key 0, never above a threshold; keys of the least value added to a row
// do not move its k-th largest).  The threshold is a radix select on the clamped keys,
// most significant digit first, over bits 30-23 (the exponent), 22-15,
// 14-7 and 6-0: a pass counts the keys that match the digits chosen so far
// into the row's 256-bin histogram in shared memory (shared atomics), and
// one warp scans it from the top (the suffix sums of its lanes' 8 bins by
// shuffles) for the digit holding the k-th key.  A pass's only barriers
// are the row's own: __syncwarp, or a named barrier of the row's W warps.
// Cost a row: n loads, 4 x n/(32 W) key tests a thread (the first pass's
// n shared atomics, the later ones' few), four 256-bin scans, a warp sum;
// no block-wide barrier.  A block holds two one-warp rows, or one row of
// W warps, and 512 threads fill an SM (at 2049: 16 rows in flight an SM).
//
// Bound: bytes (each row read once, two words written a row).
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TOP = 0x7f7fffff;    // the largest finite pattern
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned key_of(int b) {
  return (unsigned)(min(max(b, -1), TOP) + 1);
}

// the row's barrier: its warp, or its W warps (named barrier 1 + q)
template <int W>
__device__ __forceinline__ void row_sync(int q) {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + q), "r"(32 * W) : "memory");
  }
}

// a block: two rows of one warp, or one row of W warps; 512 threads an SM
// (128 registers a thread at most)
template <int W>
struct Shape {
  static constexpr int RPB = W == 1 ? 2 : 1, THREADS = 32 * W * RPB;
  static constexpr int MIN_BLOCKS = 512 / THREADS;
};

template <int CH, int W>
__global__ void __launch_bounds__(Shape<W>::THREADS, Shape<W>::MIN_BLOCKS)
topk_sum_kernel(const float* __restrict__ p, int R, int n, int k,
                float* __restrict__ sum_out, float* __restrict__ thr_out) {
  constexpr int RPB = Shape<W>::RPB, NK = 4 * CH + 1;
  __shared__ unsigned hist[RPB][256];
  __shared__ int sel[RPB][2];                // the digit, the rank left
  __shared__ float red_s[RPB][W];
  __shared__ int red_n[RPB][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp / W, wi = warp % W, t = wi * 32 + lane;  // row, thread
  const long long r = (long long)blockIdx.x * RPB + q;
  const bool live = r < R;
  const float* row = p + (live ? r : 0) * (long long)n;

  // the row's raw patterns in registers
  int head = (int)(((16 - ((uintptr_t)row & 15)) & 15) >> 2);
  head = head < n ? head : n;
  const int nv = (n - head) >> 2, tail0 = head + 4 * nv;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  int v[NK];
#pragma unroll
  for (int i = 0; i < CH; i++) {
    const int c = t * CH + i;
    const float4 f = c < nv ? body[c] : make_float4(-0.f, -0.f, -0.f, -0.f);
    v[4 * i] = __float_as_int(f.x);
    v[4 * i + 1] = __float_as_int(f.y);
    v[4 * i + 2] = __float_as_int(f.z);
    v[4 * i + 3] = __float_as_int(f.w);
  }
  v[NK - 1] = t < head ? __float_as_int(row[t])
              : (t >= 4 && t - 4 < n - tail0) ? __float_as_int(row[tail0 + t - 4])
                                              : INT_MIN;

  // the radix select: the kk-th largest key among those matching `prefix`
  // under `mask`; the passes stay rolled, so each recomputes the keys
  // from the patterns rather than keeping both live (96 registers)
  unsigned prefix = 0, mask = 0;
  int kk = k;
#pragma unroll 1
  for (int pass = 0; pass < 4; pass++) {
    const int shift = pass == 0 ? 23 : pass == 1 ? 15 : pass == 2 ? 7 : 0;
    const unsigned dm = pass == 3 ? 0x7fu : 0xffu;
    for (int b = t; b < 256; b += 32 * W) hist[q][b] = 0u;
    row_sync<W>(q);
#pragma unroll
    for (int j = 0; j < NK; j++) {
      const unsigned u = key_of(v[j]);
      if ((u & mask) == prefix) atomicAdd(&hist[q][(u >> shift) & dm], 1u);
    }
    row_sync<W>(q);
    if (wi == 0) {
      // lane l holds digits [8l, 8l+8); the keys above them by shuffles
      unsigned h8[8], tl = 0;
#pragma unroll
      for (int b = 0; b < 8; b++) {
        h8[b] = hist[q][8 * lane + b];
        tl += h8[b];
      }
      unsigned incl = tl;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_down_sync(FULL, incl, o);
        if (lane + o < 32) incl += u;
      }
      unsigned above = incl - tl;
      int found = -1, left = 0;
      if (above < (unsigned)kk && (unsigned)kk <= incl) {
#pragma unroll
        for (int b = 7; b >= 0; b--) {
          if (found < 0 && above + h8[b] >= (unsigned)kk) {
            found = 8 * lane + b;
            left = kk - (int)above;
          }
          above += h8[b];
        }
      }
      const unsigned m = __ballot_sync(FULL, found >= 0);
      if (lane == __ffs(m) - 1) {
        sel[q][0] = found;
        sel[q][1] = left;
      }
    }
    row_sync<W>(q);
    prefix |= (unsigned)sel[q][0] << shift;
    mask |= dm << shift;
    kk = sel[q][1];
  }

  // the sum above the threshold, and the ties
  const int th = (int)prefix - 1;
  float s = 0.f;
  int ng = 0;
#pragma unroll
  for (int j = 0; j < NK; j++) {
    if (v[j] > th) {
      s += __int_as_float(v[j]);
      ++ng;
    }
  }
  s = warp_sum(s);
  ng = __reduce_add_sync(FULL, ng);
  if constexpr (W > 1) {
    if (lane == 0) {
      red_s[q][wi] = s;
      red_n[q][wi] = ng;
    }
    row_sync<W>(q);
    s = 0.f;
    ng = 0;
#pragma unroll
    for (int w = 0; w < W; w++) {
      s += red_s[q][w];
      ng += red_n[q][w];
    }
  }
  if (live && t == 0) {
    const float tie = __int_as_float(th);
    sum_out[r] = s + (float)(k - ng) * tie;
    thr_out[r] = tie;
  }
}

template <int CH, int W>
int launch(const float* p, int rows, int n, int k, float* sum_out,
           float* thr_out, cudaStream_t s) {
  using S = Shape<W>;
  topk_sum_kernel<CH, W><<<(rows + S::RPB - 1) / S::RPB, S::THREADS, 0, s>>>(
      p, rows, n, k, sum_out, thr_out);
  return (int)cudaGetLastError();
}

}  // namespace

// p (rows, n) float32, contiguous, 4-byte aligned; 1 <= k <= n <= 16384.
// The plan (mirrored by prims.topk_plan): CH float4 slots a thread on W
// warps a row, the least that hold n (a row has at most n/4 whole float4
// past its first 16-byte boundary): CH = 2, 4, 8 or 16 on one warp while
// n <= 128 CH + 3, else CH = 16 on W = 2, 4 or 8 warps.
extern "C" int topk_sum_launch(const float* p, int rows, int n, int k,
                               float* sum_out, float* thr_out,
                               cudaStream_t s) {
  if (n < 1 || n > 16384 || k < 1 || k > n || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  if (n <= 259) return launch<2, 1>(p, rows, n, k, sum_out, thr_out, s);
  if (n <= 515) return launch<4, 1>(p, rows, n, k, sum_out, thr_out, s);
  if (n <= 1027) return launch<8, 1>(p, rows, n, k, sum_out, thr_out, s);
  if (n <= 2051) return launch<16, 1>(p, rows, n, k, sum_out, thr_out, s);
  if (n <= 4099) return launch<16, 2>(p, rows, n, k, sum_out, thr_out, s);
  if (n <= 8195) return launch<16, 4>(p, rows, n, k, sum_out, thr_out, s);
  return launch<16, 8>(p, rows, n, k, sum_out, thr_out, s);
}
