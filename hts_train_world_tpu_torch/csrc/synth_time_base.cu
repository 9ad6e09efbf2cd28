// K9: WORLD synthesis's time base and pulses, one block per utterance.
//
// Replaces hts_train_world_tpu/ops/synthesis.py:44-83 (_time_base: coarse
// f0/vuv with the extrapolated last frame, interp1 to the sample rate, the
// phase cumsum, the wrap and the jump mask) and :130-143 (compact_indices
// to the pulse cap, time shift, pulse time, noise sizes and offsets), and
// the count of count_pulses.  On the TPU these were XLA passes over
// (y_length,) rows with a parallel cumsum.
//
// The phase sum is the one serial dependency: it runs in ONE thread in a
// float64 accumulator, each output rounded to f32, which is what the CPU's
// torch.cumsum of f32 (and the twin's explicit float64 cumsum) computes.
// Every other operation is the twin's f32 operation in the twin's order
// (--fmad=false, IEEE division), so pulse indices, counts and per-pulse
// values equal the twin run on the CPU bit for bit.  The block walks the
// utterance in tiles: all threads interpolate a tile's increments into
// shared memory, thread 0 sums them, all threads wrap them, flag the jumps
// and compact them by a block scan, the carry (last wrap and V/UV) passing
// to the next tile.
//
// Bound: latency.  The bytes (f0 in, a few values per pulse out) and the
// operations (about 60 a sample) take microseconds; the serial float64 sum
// takes y_length dependent adds (96001 at 48 kHz x 2 s).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int PER = 4;                 // samples per thread in a tile
constexpr int TILE = THREADS * PER;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float DEFAULT_F0 = 500.0f;   // kDefaultF0

// exclusive prefix sum over the block in thread order; `total` gets the
// block's sum.  warp_tot is 32 words of shared memory.
template <typename T>
__device__ T block_exclusive_scan(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T t = lane < nw ? warp_tot[lane] : (T)0;
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  const T res = (wid == 0 ? (T)0 : warp_tot[wid - 1]) + x - v;
  total = warp_tot[nw - 1];
  __syncthreads();
  return res;
}

struct Coarse {
  const float* f0;
  int T;
  float fp, lowest, cf_last, cv_last;
  __device__ float t_of(int t) const { return (float)t * fp; }
  __device__ float cf(int t) const {
    if (t == T) return cf_last;
    const float v = f0[t];
    return v < lowest ? 0.0f : v;
  }
  __device__ float cv(int t) const {
    if (t == T) return cv_last;
    return cf(t) == 0.0f ? 0.0f : 1.0f;
  }
};

// interp1 of the coarse f0 and vuv at xi (histc: k = #(time <= xi) clipped
// to [1, T]); returns the increment and the V/UV flag
__device__ __forceinline__ float increment(const Coarse& c, float xi, float fs,
                                           unsigned char* vuv) {
  int lo = 0, hi = c.T + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.t_of(mid) <= xi) lo = mid + 1; else hi = mid;
  }
  const int k = lo < 1 ? 1 : (lo > c.T ? c.T : lo);
  const float x0 = c.t_of(k - 1), x1 = c.t_of(k);
  const float s = (xi - x0) / (x1 - x0);
  const float f0a = c.cf(k - 1), f0b = c.cf(k);
  const float va = c.cv(k - 1), vb = c.cv(k);
  const float iv = va + s * (vb - va);
  const bool voiced = iv > 0.5f;
  *vuv = voiced ? 1 : 0;
  const float if0 = voiced ? f0a + s * (f0b - f0a) : DEFAULT_F0;
  return (if0 * TWO_PI_F) / fs;
}

__device__ __forceinline__ float wrap_phase(float v) {
  float m = fmodf(v, TWO_PI_F);          // torch.remainder, divisor > 0
  if (m != 0.0f && m < 0.0f) m += TWO_PI_F;
  return m;
}

__device__ __forceinline__ float shift_of(float w0, float w1, float fs) {
  const float y1 = w0 - TWO_PI_F;
  return (-y1 / (w1 - y1)) / fs;
}

__global__ void __launch_bounds__(THREADS)
synth_time_base_kernel(const float* __restrict__ f0, int T, int y, int P,
                       float fp, float lowest, float fs,
                       long long* __restrict__ n_out,
                       long long* __restrict__ pidx,
                       long long* __restrict__ nsize,
                       long long* __restrict__ noff,
                       float* __restrict__ tshift, float* __restrict__ ptime,
                       float* __restrict__ pvuv) {
  __shared__ __align__(16) float ph[TILE];   // increments -> phase -> wrap
  __shared__ unsigned char vs[TILE];
  __shared__ long long warp_tot[32];
  __shared__ float carry_w, w_ym2, w_ym1;
  __shared__ unsigned char carry_v, v_ym2;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* f = f0 + (size_t)b * T;
  pidx += (size_t)b * P; nsize += (size_t)b * P; noff += (size_t)b * P;
  tshift += (size_t)b * P; ptime += (size_t)b * P; pvuv += (size_t)b * P;

  Coarse c{f, T, fp, lowest, 0.f, 0.f};
  {
    const float a = c.cf(T - 1), z = c.cf(T - 2);
    c.cf_last = a * 2.0f - z;
    c.cv_last = c.cv(T - 1) * 2.0f - c.cv(T - 2);
  }
  double acc = 0.0;          // thread 0's running phase
  long long count = 0;       // pulses so far (every thread's copy)

  for (int base = 0; base < y; base += TILE) {
    const int len = min(TILE, y - base);
    for (int j = tid; j < len; j += THREADS) {
      const float xi = (float)(base + j) / fs;
      ph[j] = increment(c, xi, fs, &vs[j]);
    }
    __syncthreads();
    if (tid == 0) {
      int j = 0;
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
      for (; j < len; ++j) {
        acc += (double)ph[j];
        ph[j] = (float)acc;
      }
    }
    __syncthreads();
    for (int j = tid; j < len; j += THREADS) {
      const float w = wrap_phase(ph[j]);
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
        const float w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        if (fabsf(w1 - w0) > PI_F) { flags |= 1u << q; ++mine; }
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
        const float w1 = ph[j], w0 = j == 0 ? carry_w : ph[j - 1];
        pidx[r] = i;
        tshift[r] = shift_of(w0, w1, fs);
        ptime[r] = (float)i / fs;
        pvuv[r] = (j == 0 ? carry_v : vs[j - 1]) ? 1.0f : 0.0f;
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
    ptime[r] = (float)(y - 2) / fs;
    pvuv[r] = v_ym2 ? 1.0f : 0.0f;
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

}  // namespace

extern "C" int synth_time_base_launch(const float* f0, int B, int T, int y,
                                      int P, float fp, float lowest,
                                      float fs, long long* n,
                                      long long* pidx, long long* nsize,
                                      long long* noff, float* tshift,
                                      float* ptime, float* vuv,
                                      cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (T < 2 || y < 2 || P < 0) return (int)cudaErrorInvalidValue;
  synth_time_base_kernel<<<B, THREADS, 0, s>>>(f0, T, y, P, fp, lowest, fs,
                                               n, pidx, nsize, noff, tshift,
                                               ptime, vuv);
  return (int)cudaGetLastError();
}
