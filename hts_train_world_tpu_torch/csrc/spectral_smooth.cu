// K2: DC correction and/or linear smoothing of spectral rows, one block per
// row.
//
// Replaces the f32 fast branches of hts_train_world_tpu/ops/prims.py:413-486
// (dc_correction, linear_smoothing; common.cpp:56-111 in WORLD).  On the TPU
// the smoothing was a mirrored cumsum over the whole batch plus two
// dynamic_slice reads; here one block stages its row in shared memory,
// folds the sub-F0 power back (ul_max > 0), mirrors the row by b_max bins
// each side, runs a block-wide inclusive scan and does the two fractional
// reads (b_max > 0).
//
// The scan, the reads and their difference run in double; the row, the DC
// fold and the read positions stay f32.  In f32 the difference of two
// prefix sums keeps only ~eps * (row total) / width of absolute accuracy,
// which drowns the bins of a power spectrum that lie decades below its
// harmonics; in double every bin comes out to f32 rounding.
//
// Bound: bytes (one row read, one row written; a scan and two lerps per
// bin, in double).  Design: the row and its cumsum never leave shared memory, so D4C's
// ls(dc(sps)) and CheapTrick's ls(dc(ps)) cost one pass over device memory
// instead of the dozen elementwise passes of the plain version.  Built with
// --fmad=false so the lerps round like the plain twin's separate operations.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Inclusive scan of a[0..n) in shared memory: each thread scans a
// contiguous chunk, the chunk totals are scanned across the block, then
// each chunk adds its offset.  `tot` holds THREADS values.
__device__ void block_inclusive_scan(double* a, int n, double* tot,
                                     double* red) {
  const int tid = threadIdx.x;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  double s = 0.0;
  for (int i = lo; i < hi; ++i) {
    s += a[i];
    a[i] = s;
  }
  tot[tid] = s;
  __syncthreads();
  // exclusive scan of the THREADS chunk totals: warp scans + warp offsets
  const int lane = tid & 31, wid = tid >> 5;
  double v = tot[tid];
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    double wv = lane < THREADS / 32 ? red[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, wv, o);
      if (lane >= o) wv += u;
    }
    if (lane < THREADS / 32) red[lane] = wv;
  }
  __syncthreads();
  const double off = v - tot[tid] + (wid > 0 ? red[wid - 1] : 0.0);
  for (int i = lo; i < hi; ++i) a[i] += off;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
spectral_smooth_kernel(const float* __restrict__ ps, int N,
                       const float* __restrict__ f0v,
                       const float* __restrict__ widthv, float fs,
                       float scale, int ul_max, int b_max,
                       float* __restrict__ out) {
  extern __shared__ double sm[];
  __shared__ double tot[THREADS];
  __shared__ double red[32];
  // the mirrored row's length (0 without smoothing), as in the launcher
  const int half = N / 2, n = half + 1;
  const int P = b_max > 0 ? half + 2 * b_max + 1 : 0;
  const int r = blockIdx.x, tid = threadIdx.x;
  double* seg = sm;                                // max(P, ul_max)
  float* row = (float*)(sm + max(P, ul_max));      // n
  const float* p = ps + (size_t)r * n;
  float* o = out + (size_t)r * n;

  for (int j = tid; j < n; j += THREADS) row[j] = p[j];
  __syncthreads();

  if (ul_max > 0) {
    // c = f0*N/fs; replica_i = row[ic-i] + (row[ic+1-i]-row[ic-i])*frac
    const float c = __fdiv_rn(__fmul_rn(f0v[r], (float)N), fs);
    const float tc = truncf(c);
    const int ic = (int)tc;
    const float frac = c - tc;
    for (int i = tid; i < ul_max; i += THREADS) {
      float add = 0.f;
      if (i <= ic) {
        const float y0 = row[min(ic - i, half)];
        const float y1 = row[min(ic + 1 - i, half)];
        add = y0 + (y1 - y0) * frac;
      }
      seg[i] = add;
    }
    __syncthreads();
    for (int i = tid; i < ul_max && i < n; i += THREADS)
      row[i] += (float)seg[i];
    __syncthreads();
  }

  if (b_max == 0) {
    for (int j = tid; j < n; j += THREADS) o[j] = row[j];
    return;
  }

  // mirror: row[b_max-m] | row | row[half-1-k], scaled by fs/N
  for (int m = tid; m < P; m += THREADS) {
    const int src = m < b_max ? b_max - m
                  : (m <= b_max + half ? m - b_max : 2 * half + b_max - m);
    seg[m] = (double)(row[src] * scale);
  }
  __syncthreads();
  block_inclusive_scan(seg, P, tot, red);

  const float width = widthv[r];
  const float wb = __fdiv_rn(__fdiv_rn(__fmul_rn(width, (float)N), fs), 2.0f);
  const float bm = (float)b_max - 0.5f;
  const float s_hi = bm + wb, s_lo = bm - wb;
  const float t_hi = truncf(s_hi), t_lo = truncf(s_lo);
  const float f_hi = s_hi - t_hi, f_lo = s_lo - t_lo;
  const int st_hi = min(max((int)t_hi, 0), P - half - 2);
  const int st_lo = min(max((int)t_lo, 0), P - half - 2);
  for (int k = tid; k < n; k += THREADS) {
    const double a0 = seg[st_hi + k], a1 = seg[st_hi + k + 1];
    const double b0 = seg[st_lo + k], b1 = seg[st_lo + k + 1];
    const double q_hi = a0 + (double)f_hi * (a1 - a0);
    const double q_lo = b0 + (double)f_lo * (b1 - b0);
    o[k] = (float)((q_hi - q_lo) / (double)width);
  }
}

}  // namespace

extern "C" int spectral_smooth_launch(const float* ps, int rows, int N,
                                      const float* f0, const float* width,
                                      float fs, float scale, int ul_max,
                                      int b_max, float* out, cudaStream_t s) {
  if (rows > 0) {
    const int n = N / 2 + 1, P = b_max > 0 ? N / 2 + 2 * b_max + 1 : 0;
    const size_t smem = (size_t)max(P, ul_max) * sizeof(double)
                        + (size_t)n * sizeof(float);
    if (smem > 46 * 1024) return (int)cudaErrorInvalidValue;
    spectral_smooth_kernel<<<rows, THREADS, smem, s>>>(
        ps, N, f0, width, fs, scale, ul_max, b_max, out);
  }
  return (int)cudaGetLastError();
}
