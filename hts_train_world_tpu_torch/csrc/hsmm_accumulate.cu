// K19: deterministic segment sums of per-(utterance, state) statistics into
// the E-step's running row tables, float64, every table of a batch in one
// launch.
//
// Replaces the jax.ops.segment_sum calls of
// hts_train_world_tpu/models/hsmm_batch.py:227-244 (occupancies, first and
// second moments, MSD voiced/total mass, duration statistics) and the
// merge of a batch's sums into the E-step's (the JAX package's `a + s`).
// On the card `index_add_` would add with float64 atomics, in another
// order on every run, and EM feeds those sums into the next iteration.
//
// Design: the host sorts each table's positions by row id, stably, when it
// pads the batch (hsmm_batch.member_lists: `order`, and CSR `offsets`), so
// the kernel scans nothing.  A warp owns 32 columns of one row of one
// table (the grid runs over (table, row, column group)).  It reads the
// row's members 32 at a time (one coalesced load of `order`, the next
// chunk's in flight, then each index by a shuffle), issues the 32
// members' loads of its columns, then adds them, each column in ascending
// position from 0.0: the CPU `index_add_`'s order, so the card's sums
// equal the CPU's bit for bit on every launch.  A row that holds many
// members (row 0 takes every padded position of a batch) is spread over
// its column groups, 32 loads in flight a lane.  Then out = acc + sum,
// the same float64 add as the host merge (a sum from +0.0 is never -0.0,
// so a table that starts at +0.0 takes the first batch's sums unchanged);
// out may be acc.  No ballot, no barrier; up to MAX_TABLES tables a
// launch (the E-step's four streams and the durations).
//
// Bound: bytes (each statistic read once, each running table read and
// written once).
#include "common.cuh"

namespace {

constexpr int MAX_TABLES = 8, WARPS = 8;

struct Table {
  const double* vals;      // (N, C)
  const int* order;        // (N,) positions, stable by row id
  const int* offsets;      // (n_rows + 1,)
  const double* acc;       // (n_rows, C)
  double* out;             // (n_rows, C), may be acc
  int C, n_rows;
};

struct Tables {
  Table t[MAX_TABLES];
  int first[MAX_TABLES];       // the grid's first item of each table
  int n, items;                // tables; items (row x column group) of all
};

__global__ void __launch_bounds__(WARPS * 32)
hsmm_accumulate_kernel(const Tables tb) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= tb.items) return;
  // this warp's table, read from the parameters at constant indices
  Table T = tb.t[0];
  int item = w;
#pragma unroll
  for (int i = 1; i < MAX_TABLES; i++)
    if (i < tb.n && w >= tb.first[i]) {
      T = tb.t[i];
      item = w - tb.first[i];
    }
  const int groups = (T.C + 31) >> 5;
  const int r = item / groups, c = ((item % groups) << 5) + lane;
  const bool col = c < T.C;
  const int cc = col ? c : T.C - 1;       // a lane past C reads a valid word
  const int b = T.offsets[r], e = T.offsets[r + 1];
  const double* __restrict__ vals = T.vals;
  double a = 0.0;
  int next = b + lane < e ? T.order[b + lane] : 0;
  for (int j0 = b; j0 < e; j0 += 32) {
    const int n = min(32, e - j0);
    // this chunk's 32 member positions, one a lane; the next chunk's in
    // flight while this one's values load
    const int mine = next;
    next = j0 + 32 + lane < e ? T.order[j0 + 32 + lane] : 0;
    // every load unconditional (a lane past the chunk's n reads position
    // 0), so all 32 are in flight before the first add
    double v[32];
#pragma unroll
    for (int u = 0; u < 32; u++) {
      const int p = __shfl_sync(0xffffffffu, mine, u);
      v[u] = vals[(size_t)p * T.C + cc];
    }
#pragma unroll
    for (int u = 0; u < 32; u++)
      if (u < n) a += v[u];
  }
  if (col) {
    const size_t o = (size_t)r * T.C + c;
    T.out[o] = T.acc[o] + a;
  }
}

}  // namespace

// n tables (1 <= n <= 8); ptrs: for each table vals, order, offsets, acc,
// out (5 n device pointers, host array); dims: for each C, n_rows (2 n
// ints, host array).
extern "C" int hsmm_accumulate_launch(int n, const unsigned long long* ptrs,
                                      const int* dims, cudaStream_t st) {
  if (n < 1 || n > MAX_TABLES) return (int)cudaErrorInvalidValue;
  Tables tb{};
  tb.n = n;
  for (int i = 0; i < n; i++) {
    tb.first[i] = tb.items;
    const unsigned long long* p = ptrs + 5 * i;
    tb.t[i] = Table{reinterpret_cast<const double*>(p[0]),
                    reinterpret_cast<const int*>(p[1]),
                    reinterpret_cast<const int*>(p[2]),
                    reinterpret_cast<const double*>(p[3]),
                    reinterpret_cast<double*>(p[4]), dims[2 * i],
                    dims[2 * i + 1]};
    if (dims[2 * i] < 1 || dims[2 * i + 1] < 0)
      return (int)cudaErrorInvalidValue;
    tb.items += dims[2 * i + 1] * ((dims[2 * i] + 31) / 32);
  }
  if (tb.items > 0)
    hsmm_accumulate_kernel<<<(tb.items + WARPS - 1) / WARPS, WARPS * 32, 0,
                             st>>>(tb);
  return (int)cudaGetLastError();
}
