// K31: D4C's sorted band power sums, one block per (frame, band) row.
//
// Replaces hts_train_world_tpu/ops/d4c.py:190-195, the parity branch of
// _coarse_aperiodicity (d4c.cpp:215-220 in WORLD): each band's power
// spectrum (fft_d/2 + 1 doubles) sorted ascending, c = jnp.cumsum of it,
// and the band's aperiodicity from c[half - boundary - 1] / c[half].  On the
// TPU this was jnp.sort and jnp.cumsum over (frames, bands, fft_d/2 + 1).
//
// The sum is in the JAX package's order, jnp.cumsum's on the CPU: XLA's
// blocked scan (prims.xla_cumsum in the port).  c[i] is the sequential
// prefix of i's block of 16 (from +0.0, one add at a time: a block of
// -0.0 sums to +0.0), plus, outside block 0, the scan of the block totals
// up to the block before, itself taken the same blocked way; block 0
// adds +0.0.
// That order is parallel by construction: each block's 16 adds run in one
// thread (129 threads at H = 2049), the totals are scanned in shared
// memory, and two entries are read.  Rows of 16 values or fewer are one
// sequential sum, as XLA takes them.
//
// The sort runs on 64-bit keys (the bits, with the sign bit set for
// positives and every bit flipped for negatives) in the order the JAX
// package's jnp.sort gives: -inf ... -0, +0 ... +inf, then every NaN
// whatever its sign.  So a row with a NaN gives den = NaN, and num = NaN
// only if the row has more than boundary + 1 NaNs, as in JAX.  Equal keys
// are equal bits, so ties and their order change no sum.
//
// H is 2^k + 1 on every path (fft_d is a power of two): the block sorts
// the first 2^k keys with a bitonic network and gives the last key its
// rank by a block count of the sorted keys at or below it (it sorts after
// its equals, the largest index).  The sum then reads the merged sequence
// by index arithmetic: j below the rank is sorted[j], the rank is the last
// key, above it sorted[j - 1].  Any other H sorts all H keys, padded with
// the largest key to a power of two.  A thread holds 16 keys in registers
// (P = 16 x threads, at least 512): strides below 16 are exchanged in
// registers, strides 16-256 within a warp by shuffles, and the strides
// between warps in registers again after a transpose through shared
// memory, so a row of 2048 keys takes two transposes (four barriers), not
// 66 barrier-separated passes.  Shared memory holds the row's keys once
// (16 KB at H = 2049) with each slot's low 4 bits xor'd by the next 4, so
// a lane's 16 consecutive keys and 32 lanes' consecutive keys both spread
// over the banks.
//
// Bound: bytes (each row read once, two doubles written).  The network
// makes 66 compare-exchange passes over 2048 keys: integer compares and
// selects, and shuffles, at 128 threads and 17 KB a block (up to 8 blocks
// an SM).
#include <cstdint>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int KPT = 16;         // keys a thread holds
constexpr int SEG = 32 * KPT;   // keys a warp holds in the blocked layout
constexpr int BLK = 16;         // XLA's scan block

__host__ __device__ constexpr int log2c(int v) {
  return v <= 1 ? 0 : 1 + log2c(v >> 1);
}

__device__ __forceinline__ u64 key_of(double v) {
  if (isnan(v)) return 0xfffffffffffffffeull;  // decodes to a NaN
  const u64 b = (u64)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double value_of(u64 k) {
  const u64 b = (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k;
  return __longlong_as_double((long long)b);
}

// shared-memory slot of logical key i
__device__ __forceinline__ int slot(int i) { return i ^ ((i >> 4) & 15); }

__device__ __forceinline__ void cmpx(u64& a, u64& b, bool up) {
  const bool lt = a < b;
  const u64 lo = lt ? a : b, hi = lt ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// Blocked layout: the thread's keys are logical base + r, r < KPT.
// Stage k, stride J < KPT: pairs inside the thread.
template <int J>
__device__ __forceinline__ void reg_step(u64 (&x)[KPT], int base, int k) {
#pragma unroll
  for (int r = 0; r < KPT; ++r)
    if (!(r & J)) cmpx(x[r], x[r | J], ((base + r) & k) == 0);
}

// Stage k, stride KPT <= j < SEG: the partner is lane ^ (j / KPT), same r;
// the lane with the lower index keeps the minimum where the run ascends.
__device__ __forceinline__ void shfl_step(u64 (&x)[KPT], int base, int lane,
                                          int j, int k) {
  const int m = j / KPT;
  const bool keep_min = ((lane & m) == 0) == ((base & k) == 0);
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x[r], m);
    const bool lt = x[r] < y;
    x[r] = keep_min == lt ? x[r] : y;
  }
}

// The strides k/2 ... KPT and the register strides of stage k.
__device__ __forceinline__ void warp_stage(u64 (&x)[KPT], int base, int lane,
                                           int k) {
  for (int j = k >> 1; j >= KPT; j >>= 1) shfl_step(x, base, lane, j, k);
  if (k >= 16) reg_step<8>(x, base, k);
  if (k >= 8) reg_step<4>(x, base, k);
  if (k >= 4) reg_step<2>(x, base, k);
  reg_step<1>(x, base, k);
}

// Transposed layout (NW warps): register q * NW + w holds logical
// w * SEG + q * NT + t, so the strides SEG ... k/2 pair registers.
template <int NW>
__device__ __forceinline__ void xwarp_steps(u64 (&x)[KPT], int k) {
#pragma unroll
  for (int b = log2c(NW) - 1; b >= 0; --b) {
    if ((SEG << b) < k) {
#pragma unroll
      for (int q = 0; q < KPT / NW; ++q)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (!(w & (1 << b)))
            cmpx(x[q * NW + w], x[q * NW + (w | (1 << b))],
                 ((w * SEG) & k) == 0);
    }
  }
}

// In-place cumulative sum of a[0, len) in XLA's blocked order, by the
// block; `scratch` holds each level's block totals.
__device__ void xla_scan(double* a, int len, double* scratch) {
  const int t = threadIdx.x, nt = blockDim.x;
  double* lv[8];
  int ln[8];
  int d = 0;
  while (len > BLK) {
    const int nb = (len + BLK - 1) / BLK;
    for (int b = t; b < nb; b += nt) {
      double s = 0.0 + a[BLK * b];
      a[BLK * b] = s;
      for (int q = 1; q < BLK; ++q) {
        const int i = BLK * b + q;
        if (i < len) {
          s = s + a[i];
          a[i] = s;
        } else {
          s = s + 0.0;  // the padding's zeros
        }
      }
      scratch[b] = s;
    }
    __syncthreads();
    lv[d] = a;
    ln[d] = len;
    ++d;
    a = scratch;
    scratch += nb;
    len = nb;
  }
  if (t == 0) {
    a[0] = 0.0 + a[0];
    for (int i = 1; i < len; ++i) a[i] = a[i - 1] + a[i];
  }
  __syncthreads();
  while (d > 0) {
    --d;
    double* lo = lv[d];
    for (int i = t; i < ln[d]; i += nt) {
      const int b = i / BLK;
      lo[i] = lo[i] + (b ? a[b - 1] : 0.0);
    }
    __syncthreads();
    a = lo;
  }
}

template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
band_sort_kernel(const double* __restrict__ p, int H, int n_sort, int i_num,
                 double* __restrict__ num, double* __restrict__ den) {
  constexpr int NW = NT / 32, P = NT * KPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* S = reinterpret_cast<u64*>(smem_raw);
  double* tot = reinterpret_cast<double*>(S + P);
  __shared__ int rank_s;
  __shared__ double loc_s[2];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const double* row = p + (size_t)blockIdx.x * H;
  const bool extra = n_sort < H;  // the last key joins by its rank
  if (t == 0) rank_s = 0;
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    const int i = q * NT + t;
    S[slot(i)] = i < n_sort ? key_of(row[i]) : ~0ull;
  }
  const u64 last = extra ? key_of(row[H - 1]) : 0ull;
  __syncthreads();

  u64 x[KPT];
  const int base = w * SEG + lane * KPT;
#pragma unroll
  for (int r = 0; r < KPT; ++r) x[r] = S[slot(base + r)];
  for (int k = 2; k <= SEG; k <<= 1) warp_stage(x, base, lane, k);
  for (int k = 2 * SEG; k <= P; k <<= 1) {
#pragma unroll
    for (int r = 0; r < KPT; ++r) S[slot(base + r)] = x[r];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KPT / NW; ++q)
#pragma unroll
      for (int v = 0; v < NW; ++v)
        x[q * NW + v] = S[slot(v * SEG + q * NT + t)];
    xwarp_steps<NW>(x, k);
#pragma unroll
    for (int q = 0; q < KPT / NW; ++q)
#pragma unroll
      for (int v = 0; v < NW; ++v)
        S[slot(v * SEG + q * NT + t)] = x[q * NW + v];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < KPT; ++r) x[r] = S[slot(base + r)];
    for (int j = SEG >> 1; j >= KPT; j >>= 1) shfl_step(x, base, lane, j, k);
    reg_step<8>(x, base, k);
    reg_step<4>(x, base, k);
    reg_step<2>(x, base, k);
    reg_step<1>(x, base, k);
  }
  // the sorted keys back to shared memory; the last key's rank
  int below = 0;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    S[slot(base + r)] = x[r];
    below += x[r] <= last;
  }
  if (extra) {
    below = (int)__reduce_add_sync(0xffffffffu, (unsigned)below);
    if (lane == 0) atomicAdd(&rank_s, below);
  }
  __syncthreads();
  const int rank = rank_s;
  auto value_at = [&](int j) -> double {
    if (!extra || j < rank) return value_of(S[slot(j)]);
    return value_of(j == rank ? last : S[slot(j - 1)]);
  };

  if (H <= BLK) {  // one sequential sum
    if (t == 0) {
      double s = 0.0 + value_at(0), c = s;
      for (int j = 1; j < H; ++j) {
        s = s + value_at(j);
        if (j == i_num) c = s;
      }
      num[blockIdx.x] = c;
      den[blockIdx.x] = s;
    }
    return;
  }
  const int nb = (H + BLK - 1) / BLK;
  for (int b = t; b < nb; b += NT) {
    const int j0 = BLK * b;
    double s = 0.0 + value_at(j0);
    if (j0 == i_num) loc_s[0] = s;
    if (j0 == H - 1) loc_s[1] = s;
    for (int q = 1; q < BLK; ++q) {
      const int j = j0 + q;
      s = s + (j < H ? value_at(j) : 0.0);
      if (j == i_num) loc_s[0] = s;
      if (j == H - 1) loc_s[1] = s;
    }
    tot[b] = s;
  }
  __syncthreads();
  xla_scan(tot, nb, tot + nb);
  if (t == 0) {
    const int bn = i_num / BLK, bd = (H - 1) / BLK;
    num[blockIdx.x] = loc_s[0] + (bn ? tot[bn - 1] : 0.0);
    den[blockIdx.x] = loc_s[1] + (bd ? tot[bd - 1] : 0.0);
  }
}

template <int NT>
int launch(const double* p, int R, int H, int n_sort, int i_num, double* num,
           double* den, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_sort_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  band_sort_kernel<NT><<<R, NT, smem, s>>>(p, H, n_sort, i_num, num, den);
  return (int)cudaGetLastError();
}

}  // namespace

// p (R, H) float64 rows -> num (R,) = c[i_num], den (R,) = c[H - 1] of the
// cumulative sum (XLA's blocked order) of each row sorted ascending.
extern "C" int d4c_band_sort_launch(const double* p, int R, int H, int i_num,
                                    double* num, double* den,
                                    cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  if (H < 1 || i_num < 0 || i_num >= H) return (int)cudaErrorInvalidValue;
  const int hm = H - 1;
  const int n_sort = (hm >= 1 && (hm & (hm - 1)) == 0) ? hm : H;
  int P = SEG;
  while (P < n_sort) P <<= 1;
  int n_tot = 0;  // the scan's totals, every level
  for (int len = H; len > BLK; len = (len + BLK - 1) / BLK)
    n_tot += (len + BLK - 1) / BLK;
  const size_t smem = (size_t)P * sizeof(u64) + (size_t)n_tot * sizeof(double);
  switch (P) {
    case 512: return launch<32>(p, R, H, n_sort, i_num, num, den, smem, s);
    case 1024: return launch<64>(p, R, H, n_sort, i_num, num, den, smem, s);
    case 2048: return launch<128>(p, R, H, n_sort, i_num, num, den, smem, s);
    case 4096: return launch<256>(p, R, H, n_sort, i_num, num, den, smem, s);
    case 8192: return launch<512>(p, R, H, n_sort, i_num, num, den, smem, s);
    default: return (int)cudaErrorInvalidValue;  // H > 8193
  }
}
