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
//
// The parity mode (parity = 1, float64 rows) replaces the JAX package's
// generic branches, prims.py:437-446 (dc_correction) and :487-509
// (linear_smoothing's mirror branch), which the float64 analysis takes:
// each frame mirrors its row about its own offset b = int(width*N/fs) + 1
// (o = half - |half - |p - b||), sums the mirrored row, and reads the sum
// at the two window edges by interp1Q with valid_last = half + 2b; the DC
// fold reads each tap at f0*N/fs - i the same way.  The two reads cancel,
// so their last bits are the result's, and the kernel takes the JAX
// package's float64 order as XLA's CPU compiler builds it: the cumulative
// sum is XLA's blocked scan (sequential within blocks of 16, the block
// totals scanned the same way and added back; prims.xla_cumsum), the
// reads' lerps y0 + dy*frac are fused multiply-adds, and the divisions by
// fs and by fs/N are products with their reciprocals.  The reference's
// plain sequential sum leaves CheapTrick 3e-8 from the JAX package at
// 44.1 kHz, past its 1.5e-8 bound.
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

// XLA's blocked cumulative sum of a[0..n) in shared memory (the order of
// the JAX package's jnp.cumsum on the CPU): each block of 16 in sequence,
// the block totals (into `scratch`, < n/15 + 3 values) the same way, level
// by level, then each block adds the inclusive sum of the blocks before it.
__device__ void xla_block_scan(double* a, int n, double* scratch) {
  constexpr int B = 16;
  const int tid = threadIdx.x;
  double* lv[8];
  int ln[8];
  int L = 0;
  lv[0] = a;
  ln[0] = n;
  double* next = scratch;
  while (ln[L] > B) {
    const int nb = (ln[L] + B - 1) / B;
    lv[L + 1] = next;
    ln[L + 1] = nb;
    next += nb;
    for (int b = tid; b < nb; b += THREADS) {
      double s = 0.0;
      for (int i = b * B; i < min(b * B + B, ln[L]); ++i) {
        s += lv[L][i];
        lv[L][i] = s;
      }
      lv[L + 1][b] = s;
    }
    __syncthreads();
    ++L;
  }
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < ln[L]; ++i) {
      s += lv[L][i];
      lv[L][i] = s;
    }
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    for (int i = tid; i < ln[l]; i += THREADS)
      if (i >= B) lv[l][i] += lv[l + 1][i / B - 1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
spectral_smooth_parity_kernel(const double* __restrict__ ps, int N,
                              const double* __restrict__ f0v,
                              const double* __restrict__ widthv, double fs,
                              double delta, int ul_max, int b_max,
                              double* __restrict__ out) {
  extern __shared__ double sm[];
  const int half = N / 2, n = half + 1;
  const int P = b_max > 0 ? half + 2 * b_max + 1 : 0;
  const int r = blockIdx.x, tid = threadIdx.x;
  double* seg = sm;                                // max(P, ul_max)
  double* row = sm + max(P, ul_max);               // n
  double* scan = row + n;                          // P / 15 + 8
  const double* p = ps + (size_t)r * n;
  double* o = out + (size_t)r * n;
  const double inv_fs = 1.0 / fs, inv_delta = 1.0 / delta;

  for (int j = tid; j < n; j += THREADS) row[j] = p[j];
  __syncthreads();

  if (ul_max > 0) {
    // DCCorrection: tap i at f0*N/fs - i, interp1Q over the row
    const double c = (f0v[r] * (double)N) * inv_fs;
    const int upper = 2 + (int)trunc(c);
    for (int i = tid; i < ul_max; i += THREADS) {
      const double pos = c - (double)i;
      const double base = trunc(pos);
      const int bc = min(max((int)base, 0), half);
      const double y0 = row[bc], y1 = row[min(bc + 1, half)];
      const double dy = bc < upper ? y1 - y0 : 0.0;
      seg[i] = i < upper - 1 ? fma(dy, pos - base, y0) : 0.0;
    }
    __syncthreads();
    for (int i = tid; i < ul_max && i < n; i += THREADS) row[i] += seg[i];
    __syncthreads();
  }

  if (b_max == 0) {
    for (int j = tid; j < n; j += THREADS) o[j] = row[j];
    return;
  }

  // LinearSmoothing: the row mirrored about this frame's offset b
  const double width = widthv[r];
  const int b = (int)trunc((width * (double)N) * inv_fs) + 1;
  for (int m = tid; m < P; m += THREADS) {
    const int src = half - abs(half - abs(m - b));
    seg[m] = row[min(max(src, 0), half)] * delta;
  }
  __syncthreads();
  xla_block_scan(seg, P, scan);
  const double origin = (-((double)b - 0.5) * fs) / (double)N;
  const int valid_last = half + 2 * b;
  for (int k = tid; k < n; k += THREADS) {
    const double freq = ((double)k * fs) / (double)N - width / 2.0;
    double q[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const double xi = e == 0 ? freq + width : freq;
      const double pos = (xi - origin) * inv_delta;
      const double base = trunc(pos);
      const long long bl = (long long)base;
      const int bc = (int)(bl < 0 ? 0 : (bl > P - 1 ? P - 1 : bl));
      const double y0 = seg[bc], y1 = seg[min(bc + 1, P - 1)];
      const double dy = bc < valid_last ? y1 - y0 : 0.0;
      q[e] = fma(dy, pos - base, y0);
    }
    o[k] = (q[0] - q[1]) / width;
  }
}

}  // namespace

// parity = 0: the fast forms on float32 rows; parity = 1: the parity forms
// on float64 rows (ps, f0, width and out).  scale is fs/N (float32 in the
// fast mode, as the twin multiplies).
extern "C" int spectral_smooth_launch(const void* ps, int rows, int N,
                                      const void* f0, const void* width,
                                      double fs, double scale, int ul_max,
                                      int b_max, int parity, void* out,
                                      cudaStream_t s) {
  if (rows > 0) {
    const int n = N / 2 + 1, P = b_max > 0 ? N / 2 + 2 * b_max + 1 : 0;
    const size_t smem = (size_t)max(P, ul_max) * sizeof(double)
                        + (size_t)n * (parity ? sizeof(double) : sizeof(float))
                        + (parity ? (size_t)(P / 15 + 8) * sizeof(double) : 0);
    if (smem > 46 * 1024) return (int)cudaErrorInvalidValue;
    if (parity)
      spectral_smooth_parity_kernel<<<rows, THREADS, smem, s>>>(
          static_cast<const double*>(ps), N, static_cast<const double*>(f0),
          static_cast<const double*>(width), fs, scale, ul_max, b_max,
          static_cast<double*>(out));
    else
      spectral_smooth_kernel<<<rows, THREADS, smem, s>>>(
          static_cast<const float*>(ps), N, static_cast<const float*>(f0),
          static_cast<const float*>(width), (float)fs, (float)scale, ul_max,
          b_max, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
