// K2: DC correction and/or linear smoothing of spectral rows.
//
// Replaces the f32 fast branches of hts_train_world_tpu/ops/prims.py:413-486
// (dc_correction, linear_smoothing; common.cpp:56-111 in WORLD).  On the TPU
// the smoothing was a mirrored cumsum over the whole batch plus two
// dynamic_slice reads; here a row's threads stage it in shared memory,
// fold the sub-F0 power back (ul_max > 0), mirror the row by b_max bins
// each side, scan it and do the two fractional reads (b_max > 0).
//
// The scan, the reads and their difference run in double; the row, the DC
// fold and the read positions stay f32.  In f32 the difference of two
// prefix sums keeps only ~eps * (row total) / width of absolute accuracy,
// which drowns the bins of a power spectrum that lie decades below its
// harmonics; in double every bin comes out to f32 rounding.
//
// Bound: bytes (one row read, one row written; a scan and two lerps per
// bin, in double).  The arithmetic is not far under it (a float64 add, a
// conversion and a dozen other instructions a mirrored value, ~20 a bin).
// Design (the fast kernel): TPR threads a row (64 at N = 2048, 128 at
// 4096; several rows a 128-thread block below 128; the launcher's plan is
// `prims.smooth_plan`), as many blocks as fit on the card at once, each
// working its rows in turn.  A row comes into shared memory by
// asynchronous 16-byte copies from its first 16-byte boundary (rows of
// N/2+1 floats start 4 r n bytes in), the floats before it and after the
// last one singly; the next row's copies are issued as soon as the
// current row is read, so they land while its scan is taken and read.
// The DC fold is applied bin by bin as the mirrored row is read.  Thread t
// owns an odd run of R mirrored values (odd: the lanes' runs sit on
// distinct banks), keeps them in registers and sums them in sequence in
// double; a shuffle scan across the lanes and the warps' totals through
// shared memory give each run its offset, and the run's prefix sums go to
// shared memory.  Three barriers a row (the row landed, the warp totals,
// the scan); a warp's reads of the scan for its output bins hit
// consecutive words.  Built with --fmad=false so the lerps round like the
// plain twin's separate operations.  D4C's ls(dc(sps)) and CheapTrick's
// ls(dc(ps)) cost one pass over device memory instead of the dozen
// elementwise passes of the plain version.
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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // the parity kernel's block
constexpr int RUN_MAX = 23;   // the fast kernel's values a thread (odd)

// The fast kernel's block: RPB rows of TPR threads (128 threads a block,
// or one row of 256), 64 registers a thread at most
template <int TPR>
struct Shape {
  static constexpr int RPB = TPR >= 128 ? 1 : 128 / TPR, NT = TPR * RPB;
  static constexpr int MIN_BLOCKS = 1024 / NT;
};

// the floats of a row before its first 16-byte boundary
__device__ __forceinline__ int head_of(const float* p, int n) {
  return min((int)(((16 - ((uintptr_t)p & 15)) & 15) >> 2), n);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}

// Row r of ps into the shared buffer `buf` by asynchronous copies: the
// 16-byte body from the row's first 16-byte boundary (element `head`
// lands 16-byte aligned at buf + 4), the floats before it (threads 0-2)
// and after its last one (threads 4-6) singly.
template <int TPR>
__device__ __forceinline__ void fetch_row(const float* ps, long long r,
                                          int n, float* buf, int t) {
  const float* p = ps + r * n;
  const int head = head_of(p, n), nv = (n - head) >> 2;
  const int tail0 = head + 4 * nv;
  float* row = buf + ((4 - head) & 3);
  for (int c = t; c < nv; c += TPR)
    cp_async<16>(row + head + 4 * c, p + head + 4 * c);
  if (t < head)
    cp_async<4>(row + t, p + t);
  else if (t >= 4 && t - 4 < n - tail0)
    cp_async<4>(row + tail0 + t - 4, p + tail0 + t - 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The fast forms on float32 rows; TPR threads a row, R (odd, <= RUN_MAX)
// mirrored values a thread; a row's `stride` doubles of shared memory hold
// its scan (P values) and then the row buffer (n + 8 floats).  A block
// works its rows in turn (rows q, q + RPB gridDim.x, ...): the next row
// lands in the buffer while the current one's scan is read.
template <int TPR>
__global__ void __launch_bounds__(Shape<TPR>::NT, Shape<TPR>::MIN_BLOCKS)
spectral_smooth_kernel(const float* __restrict__ ps, int rows, int N,
                       const float* __restrict__ f0v,
                       const float* __restrict__ widthv, float fs,
                       float scale, int ul_max, int b_max, int R, int stride,
                       float* __restrict__ out) {
  constexpr int RPB = Shape<TPR>::RPB, NW = TPR / 32;
  extern __shared__ double sm[];
  __shared__ double wtot[RPB][NW];
  const int q = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int lane = t & 31, wid = t >> 5;
  const int half = N / 2, n = half + 1;
  const int P = b_max > 0 ? half + 2 * b_max + 1 : 0;
  double* S = sm + (size_t)q * stride;  // the scan, P values
  float* buf = reinterpret_cast<float*>(S + ((P + 1) & ~1));
  const long long step = (long long)gridDim.x * RPB;
  const long long first = (long long)blockIdx.x * RPB + q;
  if (first < rows) fetch_row<TPR>(ps, first, n, buf, t);

  for (long long r0 = (long long)blockIdx.x * RPB; r0 < rows; r0 += step) {
    const long long r = r0 + q;
    const bool live = r < rows;
    const float* p = ps + (live ? r : 0) * (long long)n;
    float* o = out + (live ? r : 0) * (long long)n;
    const int head = head_of(p, n);
    const float* row = buf + ((4 - head) & 3);  // element head 16-byte aligned
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // the DC fold, bin by bin as it is read: c = f0*N/fs; bin i < ul_max,
    // i <= ic, gains row[ic-i] + (row[ic+1-i]-row[ic-i])*frac (the twin's
    // float32 operations, all on the unfolded row)
    int ic = -1;
    float frac = 0.f;
    if (ul_max > 0 && live) {
      const float c = __fdiv_rn(__fmul_rn(f0v[r], (float)N), fs);
      const float tc = truncf(c);
      ic = (int)tc;
      frac = c - tc;
    }
    auto folded = [&](int i) -> float {
      float v = row[i];
      if (i < ul_max) {
        float add = 0.f;
        if (i <= ic) {
          const float y0 = row[min(ic - i, half)];
          const float y1 = row[min(ic + 1 - i, half)];
          add = y0 + (y1 - y0) * frac;
        }
        v = v + add;
      }
      return v;
    };

    if (b_max == 0) {  // the fold alone: 16-byte stores from o's boundary
      if (live) {
        const int ho = head_of(o, n), nvo = (n - ho) >> 2;
        const int to0 = ho + 4 * nvo;
        float4* ob = reinterpret_cast<float4*>(o + ho);
        for (int c0 = t; c0 < nvo; c0 += 4 * TPR) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + u * TPR, j = ho + 4 * c;
            if (c >= nvo) break;
            float4 v = ho == head
                           ? *reinterpret_cast<const float4*>(row + j)
                           : make_float4(row[j], row[j + 1], row[j + 2],
                                         row[j + 3]);
            if (j < ul_max) {
              v.x = folded(j);
              v.y = folded(j + 1);
              v.z = folded(j + 2);
              v.w = folded(j + 3);
            }
            ob[c] = v;
          }
        }
        if (t < ho)
          o[t] = folded(t);
        else if (t >= 4 && t - 4 < n - to0)
          o[to0 + t - 4] = folded(to0 + t - 4);
      }
      __syncthreads();  // the row is read: the next one may land
      if (r + step < rows) fetch_row<TPR>(ps, r + step, n, buf, t);
      continue;
    }

    // thread t's run of the mirrored row, m in [t R, t R + R):
    // row[b_max-m] | row | row[2 half + b_max - m], each times fs/N in
    // float32 as the twin; R is odd, so the lanes' runs fall on distinct
    // banks.  A run inside the row past the fold reads it straight.
    const int m0 = t * R;
    float vals[RUN_MAX];
    double run = 0.0;
    if (m0 >= b_max + ul_max && m0 + R <= b_max + half + 1) {
#pragma unroll
      for (int i = 0; i < RUN_MAX; ++i) {
        const float a = i < R ? row[m0 - b_max + i] * scale : 0.f;
        vals[i] = a;
        run += (double)a;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RUN_MAX; ++i) {
        const int m = m0 + i;
        float a = 0.f;
        if (i < R && m < P) {
          const int src = m < b_max ? b_max - m
                        : (m <= b_max + half ? m - b_max
                                             : 2 * half + b_max - m);
          a = folded(src) * scale;
        }
        vals[i] = a;
        run += (double)a;
      }
    }
    // the runs' sums scanned across the warp by shuffles, the warps'
    // totals through shared memory: the run's offset, in double
    double incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) wtot[q][wid] = incl;
    __syncthreads();  // the row is read: the next one may land
    if (r + step < rows) fetch_row<TPR>(ps, r + step, n, buf, t);
    double acc = 0.0;
    for (int w = 0; w < wid; ++w) acc += wtot[q][w];
    acc += excl;
#pragma unroll
    for (int i = 0; i < RUN_MAX; ++i) {
      const int m = m0 + i;
      acc += (double)vals[i];
      if (i < R && m < P) S[m] = acc;
    }
    __syncthreads();

    // the two fractional reads at a fixed shift a row and their
    // difference, over the width as a product with its float64 reciprocal
    // (within an ulp of the quotient in float64, so the same float32 or
    // its neighbour)
    if (live) {
      const float width = widthv[r];
      const float wb =
          __fdiv_rn(__fdiv_rn(__fmul_rn(width, (float)N), fs), 2.0f);
      const float bm = (float)b_max - 0.5f;
      const float s_hi = bm + wb, s_lo = bm - wb;
      const float t_hi = truncf(s_hi), t_lo = truncf(s_lo);
      const float f_hi = s_hi - t_hi, f_lo = s_lo - t_lo;
      const int st_hi = min(max((int)t_hi, 0), P - half - 2);
      const int st_lo = min(max((int)t_lo, 0), P - half - 2);
      const double inv_w = 1.0 / (double)width;
      for (int k0 = t; k0 < n; k0 += 4 * TPR) {  // four bins in flight
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * TPR;
          if (k < n) {
            const double a0 = S[st_hi + k], a1 = S[st_hi + k + 1];
            const double b0 = S[st_lo + k], b1 = S[st_lo + k + 1];
            const double q_hi = a0 + (double)f_hi * (a1 - a0);
            const double q_lo = b0 + (double)f_lo * (b1 - b0);
            o[k] = (float)((q_hi - q_lo) * inv_w);
          }
        }
      }
    }
    // the next iteration's first barrier keeps S until every bin is read
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
// The fast kernel's plan for rows of N/2+1 bins: the fewest threads a row
// (TPR, 32-256) whose odd runs of RUN values (<= RUN_MAX) cover the
// mirrored row of N/2 + 2 b_max + 1 values (the row itself without
// smoothing), RPB rows a block.  0 where no plan holds the row.
// `prims.smooth_plan` copies it for the CPU's emulation; the card tests
// hold the two alike.
extern "C" int spectral_smooth_plan(int N, int b_max, int* tpr, int* run,
                                    int* rpb) {
  const int n = N / 2 + 1, P = b_max > 0 ? N / 2 + 2 * b_max + 1 : 0;
  const int need = max(P, n);
  for (int t = 32; t <= 256; t *= 2) {
    const int r = ((need + t - 1) / t) | 1;
    if (r <= RUN_MAX) {
      *tpr = t;
      *run = r;
      *rpb = t >= 128 ? 1 : 128 / t;
      return 1;
    }
  }
  return 0;
}

extern "C" int spectral_smooth_launch(const void* ps, int rows, int N,
                                      const void* f0, const void* width,
                                      double fs, double scale, int ul_max,
                                      int b_max, int parity, void* out,
                                      cudaStream_t s) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int n = N / 2 + 1, P = b_max > 0 ? N / 2 + 2 * b_max + 1 : 0;
  if (parity) {
    const size_t smem = (size_t)max(P, ul_max) * sizeof(double)
                        + (size_t)n * sizeof(double)
                        + (size_t)(P / 15 + 8) * sizeof(double);
    if (smem > 46 * 1024) return (int)cudaErrorInvalidValue;
    spectral_smooth_parity_kernel<<<rows, THREADS, smem, s>>>(
        static_cast<const double*>(ps), N, static_cast<const double*>(f0),
        static_cast<const double*>(width), fs, scale, ul_max, b_max,
        static_cast<double*>(out));
    return (int)cudaGetLastError();
  }
  // a row's shared memory: its scan and its row buffer
  int tpr = 0, run = 0, rpb = 0;
  const bool planned = spectral_smooth_plan(N, b_max, &tpr, &run, &rpb);
  const int stride = ((P + 1) & ~1) + (((n + 9) / 2 + 1) & ~1);
  const size_t smem = (size_t)rpb * stride * sizeof(double);
  if (!planned || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // as many blocks as fit on the card at once, each working its rows in
  // turn
  int dev = 0, sms = 0, fit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
#define SS_LAUNCH(TPR)                                                      \
  do {                                                                      \
    if (smem > 48 * 1024)                                                   \
      cudaFuncSetAttribute(spectral_smooth_kernel<TPR>,                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           (int)smem);                                      \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                          \
        &fit, spectral_smooth_kernel<TPR>, Shape<TPR>::NT, smem);          \
    const int blocks = max(1, min((rows + rpb - 1) / rpb, sms * fit));      \
    spectral_smooth_kernel<TPR><<<blocks, Shape<TPR>::NT, smem, s>>>(       \
        static_cast<const float*>(ps), rows, N,                             \
        static_cast<const float*>(f0), static_cast<const float*>(width),    \
        (float)fs, (float)scale, ul_max, b_max, run, stride,                \
        static_cast<float*>(out));                                          \
  } while (0)
  if (tpr == 32) SS_LAUNCH(32);
  else if (tpr == 64) SS_LAUNCH(64);
  else if (tpr == 128) SS_LAUNCH(128);
  else SS_LAUNCH(256);
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}
