// K19: deterministic segment sums of per-(utterance, state) statistics into
// the global row tables, float64.
//
// Replaces the jax.ops.segment_sum calls of
// hts_train_world_tpu/models/hsmm_batch.py:227-244 (occupancies, first and
// second moments, MSD voiced/total mass, duration statistics).  On the card
// `index_add_` would add with float64 atomics, in another order on every
// run, and EM feeds those sums into the next iteration.  Here one block
// owns one output row r: it walks the ids in chunks of blockDim, compacts
// the members of r in ascending i (a warp ballot and a scan over the
// warps), and each thread adds its columns of those members in that order,
// from 0.0.  That is the order of the CPU's `index_add_`, so the sums equal
// the CPU's bit for bit, on every launch.
//
// Bound: bytes (each statistic read once, each table row written once).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
hsmm_accumulate_kernel(const double* __restrict__ vals,
                       const long long* __restrict__ ids, int N, int C,
                       double* __restrict__ out) {
  __shared__ int members[THREADS];
  __shared__ int warp_base[THREADS / 32 + 1];
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int c0 = 0; c0 < C; c0 += THREADS) {
    const int c = c0 + tid;
    double acc = 0.0;
    for (int base = 0; base < N; base += THREADS) {
      const int i = base + tid;
      const bool hit = i < N && ids[i] == r;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      __syncthreads();   // members / warp_base of the previous chunk read
      if (lane == 0) warp_base[wid + 1] = __popc(bal);
      __syncthreads();
      if (tid == 0) {
        warp_base[0] = 0;
        for (int w = 1; w <= THREADS / 32; ++w)
          warp_base[w] += warp_base[w - 1];
      }
      __syncthreads();
      if (hit)
        members[warp_base[wid] + __popc(bal & ((1u << lane) - 1u))] = i;
      __syncthreads();
      const int n = warp_base[THREADS / 32];
      if (c < C)
        for (int j = 0; j < n; ++j) acc += vals[(size_t)members[j] * C + c];
    }
    if (c < C) out[r * C + c] = acc;
  }
}

}  // namespace

extern "C" int hsmm_accumulate_launch(const double* vals, const long long* ids,
                                      int N, int C, int n_rows, double* out,
                                      cudaStream_t st) {
  if (n_rows > 0 && C > 0)
    hsmm_accumulate_kernel<<<n_rows, THREADS, 0, st>>>(vals, ids, N, C, out);
  return (int)cudaGetLastError();
}
