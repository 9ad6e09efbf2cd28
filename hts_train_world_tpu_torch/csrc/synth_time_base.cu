// K9: WORLD synthesis's time base and pulses, one block per utterance.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:44-83 (_time_base: coarse
// f0/vuv with the extrapolated last frame, interp1 to the sample rate, the
// phase sum, the wrap and the jump mask; the exact path's left fold is the
// jax.lax.scan at :70-78) and :130-143 (compact_indices to the pulse cap,
// time shift, pulse time, noise sizes and offsets), and the count of
// count_pulses.  On the TPU these were XLA passes over (y_length,) rows
// with a parallel cumsum (fast mode) or a scan (exact mode).
//
// The phase sum is the one serial dependency: it runs in ONE thread in a
// float64 accumulator, each output rounded to the working type.  In float
// that is what the CPU's torch.cumsum of f32 (and the twin's explicit
// float64 cumsum) computes; in double it is the exact path's left fold
// itself.  Every other operation is the twin's in the twin's order
// (--fmad=false, IEEE division, so interp1 is the C's separate sub, div,
// mul and add, as the JAX exact path's barriers make it), and pulse
// indices, counts and per-pulse values equal the twin run on the CPU bit
// for bit.  The block walks the utterance in tiles: all threads
// interpolate a tile's increments into shared memory, thread 0 sums them,
// all threads wrap them, flag the jumps and compact them by a block scan,
// the carry (last wrap and V/UV) passing to the next tile.  The wrap is
// fmod, which equals jnp.mod / torch.remainder for the non-negative
// phase the sum gives (the branch for a negative remainder is kept).
//
// A template on the scalar type: float for the fast path, double for the
// parity path (vocoder.synthesize(parity=True), the synth CLI's default).
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
// Bound: latency.  The bytes (f0 in, a few values per pulse out) and the
// operations (about 60 a sample) take microseconds; the serial float64 sum
// takes y_length dependent adds (96001 at 48 kHz x 2 s).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int PER = 4;                 // samples per thread in a tile
constexpr int TILE = THREADS * PER;
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

// The coarse contours: nc points at t * fp.  Batch mode: the T frames and
// the extrapolated frame T (nc = T + 1); chunk mode: the T frames (nc = T).
template <typename T>
struct Coarse {
  const T* f0;
  int T_, nc;
  T fp, lowest, cf_last, cv_last;
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

// interp1 of the coarse f0 and vuv at xi (histc: k = #(time <= xi) clipped
// to [1, nc - 1]); returns the increment and the V/UV flag
template <typename T>
__device__ __forceinline__ T increment(const Coarse<T>& c, T xi, T fs,
                                       unsigned char* vuv) {
  int lo = 0, hi = c.nc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.t_of(mid) <= xi) lo = mid + 1; else hi = mid;
  }
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

// thread 0: the running float64 sum over ph[0, len), each output rounded
// to T
template <typename T>
__device__ __forceinline__ void serial_sum(T* ph, int len, double& acc) {
  int j = 0;
  if constexpr (sizeof(T) == 4) {
    for (; j + 8 <= len; j += 8) {
      const float4 a = *reinterpret_cast<const float4*>(&ph[j]);
      const float4 d = *reinterpret_cast<const float4*>(&ph[j + 4]);
      float o[8];
      acc += (double)a.x; o[0] = (float)acc;
      acc += (double)a.y; o[1] = (float)acc;
      acc += (double)a.z; o[2] = (float)acc;
      acc += (double)a.w; o[3] = (float)acc;
      acc += (double)d.x; o[4] = (float)acc;
      acc += (double)d.y; o[5] = (float)acc;
      acc += (double)d.z; o[6] = (float)acc;
      acc += (double)d.w; o[7] = (float)acc;
      *reinterpret_cast<float4*>(&ph[j]) = make_float4(o[0], o[1], o[2],
                                                       o[3]);
      *reinterpret_cast<float4*>(&ph[j + 4]) = make_float4(o[4], o[5], o[6],
                                                           o[7]);
    }
  }
  for (; j < len; ++j) {
    acc += (double)ph[j];
    ph[j] = (T)acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
synth_time_base_kernel(const T* __restrict__ f0, int nT, int y, int P,
                       T fp, T lowest, T fs,
                       long long* __restrict__ n_out,
                       long long* __restrict__ pidx,
                       long long* __restrict__ nsize,
                       long long* __restrict__ noff,
                       T* __restrict__ tshift, T* __restrict__ ptime,
                       T* __restrict__ pvuv) {
  __shared__ __align__(16) T ph[TILE];   // increments -> phase -> wrap
  __shared__ unsigned char vs[TILE];
  __shared__ long long warp_tot[32];
  __shared__ T carry_w, w_ym2, w_ym1;
  __shared__ unsigned char carry_v, v_ym2;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* f = f0 + (size_t)b * nT;
  pidx += (size_t)b * P; nsize += (size_t)b * P; noff += (size_t)b * P;
  tshift += (size_t)b * P; ptime += (size_t)b * P; pvuv += (size_t)b * P;

  Coarse<T> c{f, nT, nT + 1, fp, lowest, (T)0, (T)0};
  {
    const T a = c.cf(nT - 1), z = c.cf(nT - 2);
    c.cf_last = a * (T)2 - z;
    c.cv_last = c.cv(nT - 1) * (T)2 - c.cv(nT - 2);
  }
  double acc = 0.0;          // thread 0's running phase
  long long count = 0;       // pulses so far (every thread's copy)

  for (int base = 0; base < y; base += TILE) {
    const int len = min(TILE, y - base);
    for (int j = tid; j < len; j += THREADS) {
      const T xi = (T)(base + j) / fs;
      ph[j] = increment(c, xi, fs, &vs[j]);
    }
    __syncthreads();
    if (tid == 0) serial_sum(ph, len, acc);
    __syncthreads();
    for (int j = tid; j < len; j += THREADS) {
      const T w = wrap_phase(ph[j]);
      ph[j] = w;
      const int s = base + j;
      if (s == y - 2) { w_ym2 = w; v_ym2 = vs[j]; }
      if (s == y - 1) w_ym1 = w;
    }
    __syncthreads();
    // jumps between samples i = base + j - 1 and i + 1, in order: thread
    // tid owns j in [tid * PER, tid * PER + PER)
    unsigned flags = 0;
    int mine = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid * PER + q;
      if (j < len && base + j >= 1) {
        const T w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        if (jumps(w0, w1)) { flags |= 1u << q; ++mine; }
      }
    }
    long long found;
    long long r = count + block_exclusive_scan<long long>(mine, warp_tot,
                                                          found);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (!(flags >> q & 1u)) continue;
      if (r < P) {
        const int j = tid * PER + q;
        const long long i = base + j - 1;
        const T w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        pidx[r] = i;
        tshift[r] = shift_of(w0, w1, fs);
        ptime[r] = (T)i / fs;
        pvuv[r] = (j == 0 ? carry_v : vs[j - 1]) ? (T)1 : (T)0;
      }
      ++r;
    }
    count += found;
    if (tid == 0) { carry_w = ph[len - 1]; carry_v = vs[len - 1]; }
    __syncthreads();
  }
  if (tid == 0) n_out[b] = count;
  if (P == 0) return;

  // slots past the count: the fill index y - 2, as compact_indices pads
  for (long long r = (count < P ? count : P) + tid; r < P; r += THREADS) {
    pidx[r] = y - 2;
    tshift[r] = shift_of(w_ym2, w_ym1, fs);
    ptime[r] = (T)(y - 2) / fs;
    pvuv[r] = v_ym2 ? (T)1 : (T)0;
  }
  __syncthreads();
  // noise size: the gap to the next pulse (torch.roll wraps the last
  // slot); 0 for the last pulse (the reference quirk) and the fill slots;
  // noise offsets: the exclusive sum of the sizes
  const int chunk = (P + THREADS - 1) / THREADS;
  const int r0 = min(P, tid * chunk), r1 = min(P, r0 + chunk);
  long long local = 0;
  for (int r = r0; r < r1; ++r) {
    const long long nxt = r + 1 < count ? pidx[(r + 1) % P] : pidx[r];
    local += nxt - pidx[r];
  }
  long long total;
  long long off = block_exclusive_scan<long long>(local, warp_tot, total);
  for (int r = r0; r < r1; ++r) {
    const long long nxt = r + 1 < count ? pidx[(r + 1) % P] : pidx[r];
    const long long sz = nxt - pidx[r];
    nsize[r] = sz;
    noff[r] = off;
    off += sz;
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
  const Coarse<double> c{f0, nT, nT, fp, lowest, 0.0, 0.0};
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
    if (tid == 0) serial_sum(ph, len, acc);
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

template <typename T>
int launch(const void* f0, int B, int nT, int y, int P, double fp,
           double lowest, double fs, long long* n, long long* pidx,
           long long* nsize, long long* noff, void* tshift, void* ptime,
           void* vuv, cudaStream_t s) {
  synth_time_base_kernel<T><<<B, THREADS, 0, s>>>(
      static_cast<const T*>(f0), nT, y, P, (T)fp, (T)lowest, (T)fs, n, pidx,
      nsize, noff, static_cast<T*>(tshift), static_cast<T*>(ptime),
      static_cast<T*>(vuv));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float contours and per-pulse values, 1 for double; the
// scalars arrive as double and are rounded to the working type.
extern "C" int synth_time_base_launch(const void* f0, int B, int T, int y,
                                      int P, double fp, double lowest,
                                      double fs, int f64, long long* n,
                                      long long* pidx, long long* nsize,
                                      long long* noff, void* tshift,
                                      void* ptime, void* vuv,
                                      cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (T < 2 || y < 2 || P < 0) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(f0, B, T, y, P, fp, lowest, fs, n, pidx, nsize,
                              noff, tshift, ptime, vuv, s)
             : launch<float>(f0, B, T, y, P, fp, lowest, fs, n, pidx, nsize,
                             noff, tshift, ptime, vuv, s);
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
