// K9: WORLD synthesis's time base and pulses.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:44-83 (_time_base: coarse
// f0/vuv with the extrapolated last frame, interp1 to the sample rate, the
// phase sum, the wrap and the jump mask; the exact path's left fold is the
// jax.lax.scan at :70-78) and :130-143 (compact_indices to the pulse cap,
// time shift, pulse time, noise sizes and offsets), and the count of
// count_pulses.  On the TPU these were XLA passes over (y_length,) rows
// with a parallel cumsum (fast mode) or a scan (exact mode).
//
// The twin sums the phase increments in sequence in a float64
// accumulator, each output rounded to the working type: in float that is
// what the CPU's torch.cumsum of f32 computes, in double it is the exact
// path's left fold itself.  Every other operation is the twin's in the
// twin's order (--fmad=false, IEEE division, so interp1 is the C's
// separate sub, div, mul and add, as the JAX exact path's barriers make
// it), and pulse indices, counts and per-pulse values equal the twin run
// on the CPU bit for bit.  The wrap is fmod, which equals jnp.mod /
// torch.remainder for the non-negative phase the sum gives (the branch
// for a negative remainder is kept).
//
// float (the fast path) splits each utterance over many blocks.  Its
// increments are float values, multiples of 2^(e - 150) where e is the
// smallest biased exponent of a non-zero one, so every partial sum in
// float64 is exact while sum |inc| < 2^(e - 97): then any order of
// addition gives the sequential sum's results bit for bit.  Three kernels
// over tiles of 2048 samples: (1) each tile's increments (kept in
// scratch), their float64 sum and the exactness statistics (sum |inc|,
// smallest exponent, non-finite); (2) per tile the row's condition, with
// margin 2 (sum |inc| < 2^(e - 98)), the carry as the sum of the earlier
// tiles' sums, a block scan of the tile, the rounded phase, the wrap and
// the jumps: the wraps go back to scratch, the tile's pulse count, first
// and last pulse to the tile tables, the count to the row's total by an
// integer atomic; (3) each tile's pulses compacted at its global offset,
// the noise sizes from the next pulse (in the tile, or the next tile's
// first) and the offsets as differences to the first pulse (the exclusive
// sum of the sizes telescopes), the last tile writing the fill slots.
// A row whose condition fails (a falling contour extrapolated to 0 Hz,
// whose tiny increments make e small) takes the serial route inside
// kernel (2): block 0 of the row runs it, the other blocks leave it.
//
// double (the parity path, vocoder.synthesize(parity=True)) is the left
// fold itself and runs the serial route, a block of 1024 threads an
// utterance.  The serial route specialises its warps: lane 0 of warp 0
// runs only the float64 add chain over a ring of four tiles of 1024
// samples in shared memory, its reads issued ahead of the adds; the
// warps on the other three schedulers (w % 4 != 0) interpolate the tiles
// ahead of it and wrap, flag and compact the tiles behind it, two tiles
// back, with per-tile flags in place of whole-block barriers; noise
// sizes and offsets follow at the end as above.  A float row that fails
// the condition runs the same route in a block of 256 threads.
//
// Chunk mode (synth_time_base_chunk_launch, double only) is the streaming
// synthesizer's _chunk_pulses (hts_train_world_tpu/ops/synthesis_rt.py:
// 38-100): the samples [s0, s0 + n) of an utterance whose frames all
// exist so far, interp1 over those frames with the global time axis (no
// extrapolated frame), the phase carried in and out, wrap_prev of the
// first sample from the carried phase, new pulses at s0 + k - 1 under the
// cap P - 1, the pending pulse of the last chunk prepended, all but the
// new last pulse given their noise sizes and offsets from the carried
// stream base, and the new pending pulse carried out.  The carried state
// lives on the device: state_d = (phase, pending shift), state_i =
// (pending index or -1, stream base), read at the start and written at
// the end of the one block.
//
// Bound: float, operations and bytes (about 60 operations a sample, the
// row read and the pulses written take microseconds); double, latency:
// y_length dependent float64 adds an utterance (96001 at 48 kHz x 2 s).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;          // chunk mode
constexpr int PER = 4;                 // samples per thread in a tile
constexpr int TILE = THREADS * PER;
constexpr int BT = 256;                // the float route's blocks
constexpr int BT_PER = 8;              // samples a thread in a float tile
constexpr int BT_TILE = BT * BT_PER;   // the float route's tile
constexpr int SERIAL = 1024;           // the double route's blocks
constexpr int ST = 1024;               // the serial route's tile
constexpr int NSLOT = 4;               // its ring of tiles
constexpr int LAG = 2;                 // tiles the workers trail the fill by
constexpr int NO_EXP = 0x7fffffff;     // no non-zero increment yet
constexpr double TWO_PI_D = 2.0 * 3.14159265358979323846;
constexpr double PI_D = 3.14159265358979323846;

template <typename T> __device__ __forceinline__ T two_pi() {
  return (T)TWO_PI_D;
}
template <typename T> __device__ __forceinline__ T pi_() { return (T)PI_D; }

// exclusive prefix sum over the block in thread order; `total` gets the
// block's sum.  warp_tot is 32 words of shared memory.
template <typename I>
__device__ I block_exclusive_scan(I v, I* warp_tot, I& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  I x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const I y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    I t = lane < nw ? warp_tot[lane] : (I)0;
    for (int o = 1; o < 32; o <<= 1) {
      const I y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  const I res = (wid == 0 ? (I)0 : warp_tot[wid - 1]) + x - v;
  total = warp_tot[nw - 1];
  __syncthreads();
  return res;
}

struct Add {
  template <typename I> __device__ I operator()(I a, I b) const {
    return a + b;
  }
};
struct Min {
  template <typename I> __device__ I operator()(I a, I b) const {
    return a < b ? a : b;
  }
};
struct Max {
  template <typename I> __device__ I operator()(I a, I b) const {
    return a > b ? a : b;
  }
};

// a reduction over the block in a fixed order, returned to every thread;
// red is 8 words of shared memory (blockDim.x = BT)
template <typename I, typename Op>
__device__ I block_reduce(I v, I* red, Op op) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  I r = red[0];
  for (int i = 1; i < BT / 32; ++i) r = op(r, red[i]);
  return r;
}

// The coarse contours: nc points at t * fp.  Batch mode: the T frames and
// the extrapolated frame T (nc = T + 1); chunk mode: the T frames (nc = T).
template <typename T>
struct Coarse {
  const T* f0;
  int T_, nc;
  T fp, lowest, cf_last, cv_last, inv_fp;
  __device__ T t_of(int t) const { return (T)t * fp; }
  __device__ T cf(int t) const {
    if (t == T_) return cf_last;
    const T v = f0[t];
    return v < lowest ? (T)0 : v;
  }
  __device__ T cv(int t) const {
    if (t == T_) return cv_last;
    return cf(t) == (T)0 ? (T)0 : (T)1;
  }
};

template <typename T>
__device__ Coarse<T> batch_coarse(const T* f, int nT, T fp, T lowest) {
  Coarse<T> c{f, nT, nT + 1, fp, lowest, (T)0, (T)0, (T)1 / fp};
  const T a = c.cf(nT - 1), z = c.cf(nT - 2);
  c.cf_last = a * (T)2 - z;
  c.cv_last = c.cv(nT - 1) * (T)2 - c.cv(nT - 2);
  return c;
}

// interp1 of the coarse f0 and vuv at xi (histc: k = #(time <= xi) clipped
// to [1, nc - 1]); returns the increment and the V/UV flag.  The count
// starts from xi / fp and steps to the exact one on the computed times,
// which rise with t: the binary search's result in a step or two.
template <typename T>
__device__ __forceinline__ T increment(const Coarse<T>& c, T xi, T fs,
                                       unsigned char* vuv) {
  const T est = xi * c.inv_fp + (T)1;
  int lo = est > (T)0 ? (est < (T)c.nc ? (int)est : c.nc) : 0;
  while (lo < c.nc && c.t_of(lo) <= xi) ++lo;
  while (lo > 0 && c.t_of(lo - 1) > xi) --lo;
  const int k = lo < 1 ? 1 : (lo > c.nc - 1 ? c.nc - 1 : lo);
  const T x0 = c.t_of(k - 1), x1 = c.t_of(k);
  const T s = (xi - x0) / (x1 - x0);
  const T f0a = c.cf(k - 1), f0b = c.cf(k);
  const T va = c.cv(k - 1), vb = c.cv(k);
  const T iv = va + s * (vb - va);
  const bool voiced = iv > (T)0.5;
  *vuv = voiced ? 1 : 0;
  const T if0 = voiced ? f0a + s * (f0b - f0a) : (T)500.0;  // kDefaultF0
  return (if0 * two_pi<T>()) / fs;
}

__device__ __forceinline__ float fmod_(float a, float b) {
  return fmodf(a, b);
}
__device__ __forceinline__ double fmod_(double a, double b) {
  return fmod(a, b);
}

template <typename T>
__device__ __forceinline__ T wrap_phase(T v) {
  T m = fmod_(v, two_pi<T>());          // torch.remainder, divisor > 0
  if (m != (T)0 && m < (T)0) m += two_pi<T>();
  return m;
}

template <typename T>
__device__ __forceinline__ T shift_of(T w0, T w1, T fs) {
  const T y1 = w0 - two_pi<T>();
  return (-y1 / (w1 - y1)) / fs;
}

template <typename T>
__device__ __forceinline__ bool jumps(T w0, T w1) {
  const T d = w1 - w0;
  return (d < (T)0 ? -d : d) > pi_<T>();
}

// one thread: the running float64 sum over ph[0, len), each output rounded
// to T; the reads of the next eight go out before this eight's adds, so
// the loop runs at the latency of the dependent adds
template <typename T>
__device__ __forceinline__ void chain_sum(T* ph, int len, double& acc) {
  int j = 0;
  if (len >= 8) {
    T x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = ph[q];
    for (; j + 16 <= len; j += 8) {
      T nx[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) nx[q] = ph[j + 8 + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc += (double)x[q];
        ph[j + q] = (T)acc;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = nx[q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc += (double)x[q];
      ph[j + q] = (T)acc;
    }
    j += 8;
  }
  for (; j < len; ++j) {
    acc += (double)ph[j];
    ph[j] = (T)acc;
  }
}

// ---------------------------------------------------------------------------
// the serial route: warp 0's lane 0 sums; the workers, the warps w with
// w % 4 != 0 (the other three of the SM's four schedulers, where warps are
// dealt out by w % 4), do the rest; warps 4, 8, ... wait at the end, so
// nothing else issues from warp 0's scheduler
// ---------------------------------------------------------------------------

template <typename T, int NTH>
struct SerialSmem {
  T ph[NSLOT][ST];                     // increments -> phase -> wrap
  unsigned char vs[NSLOT][ST];
  int part[NTH / 32];
  int ready, summed;                   // tiles filled, tiles summed
  T carry_w, w_ym2, w_ym1;
  unsigned char carry_v, v_ym2;
  long long count;
};

template <int NTH>
__device__ __forceinline__ void worker_bar() {
  asm volatile("bar.sync 1, %0;" ::"r"(NTH / 4 * 3) : "memory");
}

// exclusive prefix sum over the workers in order (worker warp ww); `total`
// gets the workers' sum
template <int NTH>
__device__ __forceinline__ int worker_scan(int v, int ww, int* part,
                                           int& total) {
  const int lane = threadIdx.x & 31;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[ww] = x;
  worker_bar<NTH>();
  int before = 0, all = 0;
  for (int i = 0; i < NTH / 32 / 4 * 3; ++i) {
    before += i < ww ? part[i] : 0;
    all += part[i];
  }
  worker_bar<NTH>();
  total = all;
  return before + x - v;
}

// One utterance in one block of NTH threads: the left fold, the wraps, the
// jumps, the pulses, the fill slots, the noise sizes and offsets.
template <typename T, int NTH>
__device__ void serial_row(const Coarse<T>& c, int y, int P, T fs,
                           long long* __restrict__ n_out,
                           long long* __restrict__ pidx,
                           long long* __restrict__ nsize,
                           long long* __restrict__ noff,
                           T* __restrict__ tshift, T* __restrict__ ptime,
                           T* __restrict__ pvuv) {
  constexpr int WORKERS = NTH / 4 * 3;
  constexpr int SPW = (ST + WORKERS - 1) / WORKERS;   // samples a worker
  __shared__ SerialSmem<T, NTH> sm;
  volatile int* ready = &sm.ready;
  volatile int* summed = &sm.summed;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ntiles = (y + ST - 1) / ST;
  if (tid == 0) {
    sm.ready = 0;
    sm.summed = 0;
  }
  __syncthreads();
  if (tid < 32) {
    if (tid == 0) {
      double acc = 0.0;
      for (int k = 0; k < ntiles; ++k) {
        while (*ready <= k) __nanosleep(32);
        __threadfence_block();
        chain_sum(sm.ph[k % NSLOT], min(ST, y - k * ST), acc);
        __threadfence_block();
        *summed = k + 1;
      }
    }
    __syncwarp();
  } else if (warp & 3) {
    const int ww = warp - (warp >> 2) - 1;   // worker warps 0, 1, 2, ...
    const int wt = ww * 32 + (tid & 31);
    long long count = 0;
    for (int k = 0; k < ntiles + LAG; ++k) {
      if (k < ntiles) {                 // interpolate tile k
        const int slot = k % NSLOT, base = k * ST, len = min(ST, y - base);
        for (int j = wt; j < len; j += WORKERS)
          sm.ph[slot][j] = increment(c, (T)(base + j) / fs, fs,
                                     &sm.vs[slot][j]);
        worker_bar<NTH>();
        if (wt == 0) {
          __threadfence_block();
          *ready = k + 1;
        }
      }
      if (k < LAG) continue;
      const int kp = k - LAG, slot = kp % NSLOT, base = kp * ST;
      const int len = min(ST, y - base);
      while (*summed <= kp) __nanosleep(64);
      __threadfence_block();
      T* ph = sm.ph[slot];
      const unsigned char* vs = sm.vs[slot];
      const int j0 = wt * SPW;
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        const int j = j0 + q;
        if (j >= len) break;
        const T w = wrap_phase(ph[j]);
        ph[j] = w;
        const int s = base + j;
        if (s == y - 2) {
          sm.w_ym2 = w;
          sm.v_ym2 = vs[j];
        }
        if (s == y - 1) sm.w_ym1 = w;
      }
      worker_bar<NTH>();
      // jumps between samples base + j - 1 and base + j, in order
      unsigned flags = 0;
      int mine = 0;
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        const int j = j0 + q;
        if (j < len && base + j >= 1) {
          const T w1 = ph[j], w0 = j == 0 ? sm.carry_w : ph[j - 1];
          if (jumps(w0, w1)) {
            flags |= 1u << q;
            ++mine;
          }
        }
      }
      int found;
      long long r = count + worker_scan<NTH>(mine, ww, sm.part, found);
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        if (!(flags >> q & 1u)) continue;
        if (r < P) {
          const int j = j0 + q;
          const long long i = base + j - 1;
          const T w1 = ph[j], w0 = j == 0 ? sm.carry_w : ph[j - 1];
          pidx[r] = i;
          tshift[r] = shift_of(w0, w1, fs);
          ptime[r] = (T)i / fs;
          pvuv[r] = (j == 0 ? sm.carry_v : vs[j - 1]) ? (T)1 : (T)0;
        }
        ++r;
      }
      count += found;
      worker_bar<NTH>();                // every read of the carry done
      if (wt == 0) {
        sm.carry_w = ph[len - 1];
        sm.carry_v = vs[len - 1];
      }
    }
    if (wt == 0) sm.count = count;
  }
  __syncthreads();
  const long long count = sm.count;
  if (tid == 0) *n_out = count;
  if (P == 0) return;
  // noise size: the gap to the next pulse (torch.roll wraps the last
  // slot); 0 for the last pulse (the reference quirk) and the fill slots;
  // offsets: the exclusive sum of the sizes, pidx[r] - pidx[0]
  const long long np = count < P ? count : P;
  const long long p0 = count > 0 ? pidx[0] : 0;
  for (long long r = tid; r < P; r += NTH) {
    if (r < np) {
      const long long i = pidx[r];
      nsize[r] = r + 1 < count ? (r + 1 < P ? pidx[r + 1] : p0) - i : 0;
      noff[r] = i - p0;
    } else {
      pidx[r] = y - 2;
      tshift[r] = shift_of(sm.w_ym2, sm.w_ym1, fs);
      ptime[r] = (T)(y - 2) / fs;
      pvuv[r] = sm.v_ym2 ? (T)1 : (T)0;
      nsize[r] = 0;
      noff[r] = count > 0 ? pidx[count - 1] - p0 : 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SERIAL)
tb_serial_kernel(const T* __restrict__ f0, int nT, int y, int P, T fp,
                 T lowest, T fs, long long* __restrict__ n_out,
                 long long* __restrict__ pidx, long long* __restrict__ nsize,
                 long long* __restrict__ noff, T* __restrict__ tshift,
                 T* __restrict__ ptime, T* __restrict__ pvuv) {
  const int b = blockIdx.x;
  const size_t o = (size_t)b * P;
  serial_row<T, SERIAL>(batch_coarse<T>(f0 + (size_t)b * nT, nT, fp,
                                        lowest),
                        y, P, fs, n_out + b, pidx + o, nsize + o, noff + o,
                        tshift + o, ptime + o, pvuv + o);
}

// ---------------------------------------------------------------------------
// the float route: tiles of BT_TILE samples over (tiles, utterances)
// ---------------------------------------------------------------------------

// scratch: per tile (B, nt) the float64 sum and sum |inc|, the smallest
// exponent (-1: a non-finite increment), the pulse count, the first and
// the last pulse; per row the route; per sample (B, y) the increment, then
// the wrap, and the V/UV flag
struct Scratch {
  double* tsum;
  double* tabs;
  int* texp;
  int* tcnt;
  int* tfirst;
  int* tlast;
  int* route;
  float* w;
  unsigned char* v;
};

long long scratch_bytes(int B, int y) {
  const long long nt = (y + BT_TILE - 1) / BT_TILE;
  return 32LL * B * nt + 4LL * B + 5LL * B * y;
}

Scratch carve(void* p, int B, int y) {
  const size_t nt = (y + BT_TILE - 1) / BT_TILE, n = (size_t)B * nt;
  char* c = static_cast<char*>(p);
  Scratch s;
  s.tsum = reinterpret_cast<double*>(c);
  s.tabs = s.tsum + n;
  s.texp = reinterpret_cast<int*>(s.tabs + n);
  s.tcnt = s.texp + n;
  s.tfirst = s.tcnt + n;
  s.tlast = s.tfirst + n;
  s.route = s.tlast + n;
  s.w = reinterpret_cast<float*>(s.route + B);
  s.v = reinterpret_cast<unsigned char*>(s.w + (size_t)B * y);
  return s;
}

__global__ void __launch_bounds__(BT)
tb_stats_kernel(const float* __restrict__ f0, int nT, int y, float fp,
                float lowest, float fs, Scratch sc,
                long long* __restrict__ n_out) {
  __shared__ double redd[BT / 32];
  __shared__ int redi[BT / 32];
  const int k = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int tid = threadIdx.x, base = k * BT_TILE;
  const Coarse<float> c = batch_coarse<float>(f0 + (size_t)b * nT, nT, fp,
                                              lowest);
  float* w = sc.w + (size_t)b * y;
  unsigned char* v = sc.v + (size_t)b * y;
  double sum = 0.0, abs_ = 0.0;
  int emin = NO_EXP, bad = 0;
#pragma unroll
  for (int q = 0; q < BT_PER; ++q) {
    const int s = base + tid + q * BT;
    if (s >= y) break;
    unsigned char vv;
    const float inc = increment(c, (float)s / fs, fs, &vv);
    w[s] = inc;
    v[s] = vv;
    sum += (double)inc;
    abs_ += fabs((double)inc);
    const int e = (int)((__float_as_uint(inc) >> 23) & 0xffu);
    if (e == 0xff) bad = 1;
    else if (inc != 0.0f) emin = min(emin, max(e, 1));
  }
  sum = block_reduce(sum, redd, Add());
  abs_ = block_reduce(abs_, redd, Add());
  emin = block_reduce(emin, redi, Min());
  bad = block_reduce(bad, redi, Max());
  if (tid == 0) {
    const size_t o = (size_t)b * nt + k;
    sc.tsum[o] = sum;
    sc.tabs[o] = abs_;
    sc.texp[o] = bad ? -1 : emin;
    if (k == 0) n_out[b] = 0;
  }
}

__global__ void __launch_bounds__(BT)
tb_scan_kernel(const float* __restrict__ f0, int nT, int y, int P, float fp,
               float lowest, float fs, Scratch sc,
               long long* __restrict__ n_out, long long* __restrict__ pidx,
               long long* __restrict__ nsize, long long* __restrict__ noff,
               float* __restrict__ tshift, float* __restrict__ ptime,
               float* __restrict__ pvuv) {
  __shared__ double redd[BT / 32];
  __shared__ int redi[BT / 32];
  __shared__ double warp_tot[32];
  const int k = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int tid = threadIdx.x;
  const size_t o = (size_t)b * nt;
  // the row's exactness condition and this tile's carry
  double abs_ = 0.0, carry = 0.0;
  int emin = NO_EXP, bad = 0;
  for (int i = tid; i < nt; i += BT) {
    abs_ += sc.tabs[o + i];
    const int e = sc.texp[o + i];
    if (e < 0) bad = 1;
    else emin = min(emin, e);
    if (i < k) carry += sc.tsum[o + i];
  }
  abs_ = block_reduce(abs_, redd, Add());
  carry = block_reduce(carry, redd, Add());
  emin = block_reduce(emin, redi, Min());
  bad = block_reduce(bad, redi, Max());
  const bool exact =
      !bad && (emin == NO_EXP || abs_ < ldexp(1.0, emin - 98));
  if (k == 0 && tid == 0) sc.route[b] = exact ? 1 : 0;
  if (!exact) {
    if (k == 0) {
      const size_t op = (size_t)b * P;
      serial_row<float, BT>(batch_coarse<float>(f0 + (size_t)b * nT, nT,
                                                fp, lowest),
                        y, P, fs, n_out + b, pidx + op, nsize + op,
                        noff + op, tshift + op, ptime + op, pvuv + op);
    }
    return;
  }
  // the tile: thread tid owns samples base + [tid BT_PER, +BT_PER)
  const int s0 = k * BT_TILE + tid * BT_PER;
  float* w = sc.w + (size_t)b * y;
  double pre[BT_PER];
  double run = 0.0;
#pragma unroll
  for (int q = 0; q < BT_PER; ++q) {
    const int s = s0 + q;
    run += s < y ? (double)w[s] : 0.0;
    pre[q] = run;
  }
  double tile_sum;
  const double off = carry + block_exclusive_scan<double>(run, warp_tot,
                                                          tile_sum);
  float w_prev = wrap_phase((float)off);   // the phase at s0 - 1
  int mine = 0, first = NO_EXP, last = -1;
#pragma unroll
  for (int q = 0; q < BT_PER; ++q) {
    const int s = s0 + q;
    if (s >= y) break;
    const float wq = wrap_phase((float)(off + pre[q]));
    if (s >= 1 && jumps(w_prev, wq)) {
      ++mine;
      first = min(first, s - 1);
      last = s - 1;
    }
    w[s] = wq;
    w_prev = wq;
  }
  mine = block_reduce(mine, redi, Add());
  first = block_reduce(first, redi, Min());
  last = block_reduce(last, redi, Max());
  if (tid == 0) {
    sc.tcnt[o + k] = mine;
    sc.tfirst[o + k] = mine ? first : -1;
    sc.tlast[o + k] = last;
    if (mine)
      atomicAdd(reinterpret_cast<unsigned long long*>(n_out + b),
                (unsigned long long)mine);
  }
}

__global__ void __launch_bounds__(BT)
tb_compact_kernel(int y, int P, float fs, Scratch sc,
                  long long* __restrict__ pidx, long long* __restrict__ nsize,
                  long long* __restrict__ noff, float* __restrict__ tshift,
                  float* __restrict__ ptime, float* __restrict__ pvuv) {
  __shared__ long long redl[BT / 32];
  __shared__ int redi[BT / 32];
  __shared__ int warp_tot[32];
  __shared__ int list[BT_TILE];        // the tile's pulses in order
  const int k = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int tid = threadIdx.x;
  if (!sc.route[b]) return;            // the serial route wrote the row
  const size_t o = (size_t)b * nt;
  pidx += (size_t)b * P; nsize += (size_t)b * P; noff += (size_t)b * P;
  tshift += (size_t)b * P; ptime += (size_t)b * P; pvuv += (size_t)b * P;
  // the pulses before this tile, the row's count, its first pulse, the
  // next tile that has one, the last tile that has one
  long long before = 0, count = 0;
  int t_first = NO_EXP, t_next = NO_EXP, t_last = -1;
  for (int i = tid; i < nt; i += BT) {
    const int c = sc.tcnt[o + i];
    count += c;
    if (i < k) before += c;
    if (c) {
      t_first = min(t_first, i);
      if (i > k) t_next = min(t_next, i);
      t_last = max(t_last, i);
    }
  }
  before = block_reduce(before, redl, Add());
  count = block_reduce(count, redl, Add());
  t_first = block_reduce(t_first, redi, Min());
  t_next = block_reduce(t_next, redi, Min());
  t_last = block_reduce(t_last, redi, Max());
  const long long p0 = count ? sc.tfirst[o + t_first] : 0;
  const float* w = sc.w + (size_t)b * y;
  const unsigned char* v = sc.v + (size_t)b * y;
  const int cnt = sc.tcnt[o + k];
  if (cnt > 0 && before < P) {
    const long long after = t_next < nt ? sc.tfirst[o + t_next] : -1;
    const int s0 = k * BT_TILE + tid * BT_PER;
    unsigned flags = 0;
    int mine = 0;
#pragma unroll
    for (int q = 0; q < BT_PER; ++q) {
      const int s = s0 + q;
      if (s < y && s >= 1 && jumps(w[s - 1], w[s])) {
        flags |= 1u << q;
        ++mine;
      }
    }
    int found;
    const int rank = block_exclusive_scan<int>(mine, warp_tot, found);
    int li = rank;
#pragma unroll
    for (int q = 0; q < BT_PER; ++q)
      if (flags >> q & 1u) list[li++] = s0 + q - 1;
    __syncthreads();
    li = rank;
#pragma unroll
    for (int q = 0; q < BT_PER; ++q) {
      if (!(flags >> q & 1u)) continue;
      const long long r = before + li;
      if (r < P) {
        const long long i = s0 + q - 1;
        pidx[r] = i;
        tshift[r] = shift_of(w[i], w[i + 1], fs);
        ptime[r] = (float)i / fs;
        pvuv[r] = v[i] ? 1.0f : 0.0f;
        long long sz = 0;
        if (r + 1 < count)
          sz = (r + 1 < P ? (li + 1 < cnt ? (long long)list[li + 1] : after)
                          : p0) - i;
        nsize[r] = sz;
        noff[r] = i - p0;
      }
      ++li;
    }
  }
  if (k == nt - 1) {
    // slots past the count: the fill index y - 2, as compact_indices pads
    const long long last = count ? sc.tlast[o + t_last] : 0;
    for (long long r = (count < P ? count : P) + tid; r < P; r += BT) {
      pidx[r] = y - 2;
      tshift[r] = shift_of(w[y - 2], w[y - 1], fs);
      ptime[r] = (float)(y - 2) / fs;
      pvuv[r] = v[y - 2] ? 1.0f : 0.0f;
      nsize[r] = 0;
      noff[r] = count ? last - p0 : 0;
    }
  }
}

// chunk mode: one block, double (see the header)
__global__ void __launch_bounds__(THREADS)
synth_time_base_chunk_kernel(const double* __restrict__ f0, int nT,
                             long long s0, int n, int P, double fp,
                             double lowest, double fs,
                             double* __restrict__ state_d,
                             long long* __restrict__ state_i,
                             long long* __restrict__ counts,
                             long long* __restrict__ pidx,
                             long long* __restrict__ nsize,
                             long long* __restrict__ noff,
                             double* __restrict__ tshift,
                             double* __restrict__ ptime,
                             double* __restrict__ pvuv) {
  __shared__ double ph[TILE];
  __shared__ unsigned char vs[TILE];
  __shared__ long long warp_tot[32];
  __shared__ double carry_w, phase_end;
  __shared__ long long first;          // the slot of the first new pulse
  const int tid = threadIdx.x;
  const Coarse<double> c{f0, nT, nT, fp, lowest, 0.0, 0.0, 1.0 / fp};
  const double phase0 = state_d[0], pend_shift = state_d[1];
  const long long pend = state_i[0], sbase = state_i[1];
  if (tid == 0) {
    carry_w = wrap_phase(phase0);
    first = pend >= 0 ? 1 : 0;
  }
  __syncthreads();
  const long long cap = P - 1;         // new pulses kept
  double acc = phase0;                 // thread 0's running phase
  long long count = 0;                 // new pulses so far

  for (int base = 0; base < n; base += TILE) {
    const int len = min(TILE, n - base);
    for (int j = tid; j < len; j += THREADS)
      ph[j] = increment(c, (double)(s0 + base + j) / fs, fs, &vs[j]);
    __syncthreads();
    if (tid == 0) chain_sum(ph, len, acc);
    __syncthreads();
    for (int j = tid; j < len; j += THREADS) ph[j] = wrap_phase(ph[j]);
    __syncthreads();
    unsigned flags = 0;
    int mine = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid * PER + q;
      if (j < len) {
        const double w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        if (jumps(w0, w1)) { flags |= 1u << q; ++mine; }
      }
    }
    long long found;
    long long r = count + block_exclusive_scan<long long>(mine, warp_tot,
                                                          found);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (!(flags >> q & 1u)) continue;
      if (r < cap) {
        const int j = tid * PER + q;
        const double w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        pidx[first + r] = s0 + base + j - 1;
        tshift[first + r] = shift_of(w0, w1, fs);
      }
      ++r;
    }
    count += found;
    __syncthreads();
    if (tid == 0) carry_w = ph[len - 1];
    __syncthreads();
  }
  if (tid == 0) phase_end = acc;
  const long long n_new = count < cap ? count : cap;
  const long long n_p = first + n_new;
  const long long fill = s0 + n - 2;
  if (tid == 0 && first) { pidx[0] = pend; tshift[0] = pend_shift; }
  for (long long r = n_p + tid; r < P; r += THREADS) {
    pidx[r] = fill;
    tshift[r] = 0.0;
  }
  __syncthreads();
  // every slot's time and V/UV flag (interp1 over the frames at p / fs)
  for (int r = tid; r < P; r += THREADS) {
    const double t = (double)pidx[r] / fs;
    unsigned char v;
    increment(c, t, fs, &v);
    ptime[r] = t;
    pvuv[r] = v ? 1.0 : 0.0;
  }
  if (tid == 0) {
    // all but the last pulse are synthesised now; the last one's noise
    // size needs the next chunk's first pulse
    const long long n_s = n_p > 0 ? n_p - 1 : 0;
    long long off = sbase;
    for (int r = 0; r < P; ++r) {
      const long long sz = r < n_s ? pidx[r + 1] - pidx[r] : 0;
      nsize[r] = sz;
      noff[r] = off;
      off += sz;
    }
    counts[0] = n_p;
    counts[1] = n_s;
    state_d[0] = phase_end;
    state_d[1] = n_p > 0 ? tshift[n_p - 1] : 0.0;
    state_i[0] = n_p > 0 ? pidx[n_p - 1] : -1;
    state_i[1] = off;
  }
}

}  // namespace

// f64: 0 for float contours and per-pulse values, 1 for double; the
// scalars arrive as double and are rounded to the working type.  scratch
// (float only): scratch_size >= 32 B nt + 4 B + 5 B y bytes, nt the tiles
// of 2048 samples in y.
extern "C" int synth_time_base_launch(const void* f0, int B, int T, int y,
                                      int P, double fp, double lowest,
                                      double fs, int f64, long long* n,
                                      long long* pidx, long long* nsize,
                                      long long* noff, void* tshift,
                                      void* ptime, void* vuv, void* scratch,
                                      long long scratch_size,
                                      cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (T < 2 || y < 2 || P < 0) return (int)cudaErrorInvalidValue;
  if (f64) {
    tb_serial_kernel<double><<<B, SERIAL, 0, s>>>(
        static_cast<const double*>(f0), T, y, P, fp, lowest, fs, n, pidx,
        nsize, noff, static_cast<double*>(tshift),
        static_cast<double*>(ptime), static_cast<double*>(vuv));
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || scratch_size < scratch_bytes(B, y))
    return (int)cudaErrorInvalidValue;
  const Scratch sc = carve(scratch, B, y);
  const float* f = static_cast<const float*>(f0);
  float* ts = static_cast<float*>(tshift);
  float* pt = static_cast<float*>(ptime);
  float* pv = static_cast<float*>(vuv);
  const dim3 grid((y + BT_TILE - 1) / BT_TILE, B);
  tb_stats_kernel<<<grid, BT, 0, s>>>(f, T, y, (float)fp, (float)lowest,
                                      (float)fs, sc, n);
  tb_scan_kernel<<<grid, BT, 0, s>>>(f, T, y, P, (float)fp, (float)lowest,
                                     (float)fs, sc, n, pidx, nsize, noff, ts,
                                     pt, pv);
  if (P > 0)
    tb_compact_kernel<<<grid, BT, 0, s>>>(y, P, (float)fs, sc, pidx, nsize,
                                          noff, ts, pt, pv);
  return (int)cudaGetLastError();
}

extern "C" int synth_time_base_chunk_launch(
    const double* f0, int T, long long s0, int n, int P, double fp,
    double lowest, double fs, double* state_d, long long* state_i,
    long long* counts, long long* pidx, long long* nsize, long long* noff,
    double* tshift, double* ptime, double* vuv, cudaStream_t s) {
  if (T < 2 || n < 2 || P < 2 || s0 < 0) return (int)cudaErrorInvalidValue;
  synth_time_base_chunk_kernel<<<1, THREADS, 0, s>>>(
      f0, T, s0, n, P, fp, lowest, fs, state_d, state_i, counts, pidx, nsize,
      noff, tshift, ptime, vuv);
  return (int)cudaGetLastError();
}
