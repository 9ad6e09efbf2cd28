// K3: exact sum of the k largest entries of non-negative f32 rows, one
// block per row.
//
// Replaces hts_train_world_tpu/ops/prims.py:383-410 (sum_top_k), which on
// the TPU ran 32 masked reductions over the whole (rows, n) array.  Here a
// block stages its row's bit patterns in shared memory and runs the same
// 32-step bisection on the int32 pattern (monotone for non-negative floats):
// the invariant count(b > lo) >= k > count(b > hi) makes `hi` the k-th
// largest value, bit for bit the JAX threshold.  The sum is the masked sum
// above the threshold plus (k - count) copies of the tie value.  No sort, no
// approximate top-k.
//
// Bound: bytes (one row read, two words written).  The 32 counting passes
// run over shared memory, so device memory is touched once per row.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
topk_sum_kernel(const float* __restrict__ p, int n, int k,
                float* __restrict__ sum_out, float* __restrict__ thr_out) {
  extern __shared__ int b[];  // n bit patterns
  __shared__ int red_i[32];
  __shared__ float red_f[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* row = p + (size_t)r * n;
  for (int j = tid; j < n; j += THREADS) b[j] = __float_as_int(row[j]);
  __syncthreads();

  int lo = -1, hi = 0x7f7fffff;
  for (int it = 0; it < 32; ++it) {
    const int mid = lo + (hi - lo) / 2;
    int cnt = 0;
    for (int j = tid; j < n; j += THREADS) cnt += b[j] > mid;
    if (block_sum_int(cnt, red_i) >= k) lo = mid; else hi = mid;
  }

  float s = 0.f;
  int ng = 0;
  for (int j = tid; j < n; j += THREADS)
    if (b[j] > hi) {
      s += __int_as_float(b[j]);
      ++ng;
    }
  s = block_sum(s, red_f);
  ng = block_sum_int(ng, red_i);
  if (tid == 0) {
    const float tie = __int_as_float(hi);
    sum_out[r] = s + (float)(k - ng) * tie;
    thr_out[r] = tie;
  }
}

}  // namespace

extern "C" int topk_sum_launch(const float* p, int rows, int n, int k,
                               float* sum_out, float* thr_out,
                               cudaStream_t s) {
  if (rows > 0) {
    if ((size_t)n * sizeof(int) > 46 * 1024) return (int)cudaErrorInvalidValue;
    topk_sum_kernel<<<rows, THREADS, n * sizeof(int), s>>>(p, n, k, sum_out,
                                                           thr_out);
  }
  return (int)cudaGetLastError();
}
