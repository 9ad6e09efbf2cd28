// K13: Harvest's decimation to ~8 kHz, one block per row.
//
// Replaces hts_train_world_tpu/ops/prims.py:262-346 (affine_scan,
// _iir_filter_for_decimate, decimate; matlabfunctions.cpp:184-210 in
// WORLD): reflect-pad by 9, the order-3 IIR low-pass forward, reverse,
// forward again, reverse, and the strided pick of the C loop's count.  On
// the TPU the f32 recurrence was a block-Toeplitz matmul plus a carry scan
// (an associative scan of the companion matrix amplified f32 roundoff to
// ~5%).  Here each of the block's 1024 threads runs one contiguous chunk of
// the recurrence in float64, as the C does: first from a zero state, giving
// the chunk's end state z_k as a linear function of its start; the true end
// states E_k = P E_{k-1} + z_k (P = A^chunk for the companion matrix A)
// follow from a Kogge-Stone scan within each warp (P^1..P^16) and across
// the 32 warp totals (P^32..P^512), all powers precomputed in float64 on the
// host; then every thread reruns its chunk from its true start state and
// writes the filter's output.  Pass 1 keeps its output in a float64 row of
// device scratch; pass 2 reads it reversed and writes only the picked
// samples in the row's type.  The kernel is a template on that type: f32
// rows (the fast path) get their samples rounded to f32, double rows (the
// parity analysis' Harvest) keep them; the recurrence is float64 in both.
//
// Bound: latency.  Each pass is 2 x ceil((n + 18) / 1024) dependent float64
// steps per thread plus a 10-step scan; bytes (the row read twice, 16 B a
// sample of scratch) and operations are small.  Built with --fmad=false so
// the recurrence rounds in the C's order.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 9;
constexpr unsigned FULL = 0xffffffffu;

struct V3 {
  double a, b, c;  // (w_t, w_{t-1}, w_{t-2})
};

__device__ __forceinline__ V3 add(V3 x, V3 y) {
  return {x.a + y.a, x.b + y.b, x.c + y.c};
}

// P (row-major 3x3) times v
__device__ __forceinline__ V3 matvec(const double* P, V3 v) {
  return {P[0] * v.a + P[1] * v.b + P[2] * v.c,
          P[3] * v.a + P[4] * v.b + P[5] * v.c,
          P[6] * v.a + P[7] * v.b + P[8] * v.c};
}

__device__ __forceinline__ V3 shfl_up(V3 v, int o) {
  return {__shfl_up_sync(FULL, v.a, o), __shfl_up_sync(FULL, v.b, o),
          __shfl_up_sync(FULL, v.c, o)};
}

// sample i of the reflect-padded row (matlabfunctions.cpp:190-197)
template <typename T>
__device__ __forceinline__ double padded(const T* x, int n, int i) {
  if (i < PAD) return 2.0 * (double)x[0] - (double)x[PAD - i];
  if (i < PAD + n) return (double)x[i - PAD];
  return 2.0 * (double)x[n - 1] - (double)x[n - 2 - (i - PAD - n)];
}

// One pass of the filter over in(t), t in [0, M), emitting out(t, y_t).
// tab: a0 a1 a2 b0 b1, then P^0..P^32, P^64, P^128, P^256, P^512.
template <class In, class Out>
__device__ void filter_pass(In in, Out out, int M, int chunk,
                            const double* tab, V3* tot) {
  const double a0 = tab[0], a1 = tab[1], a2 = tab[2], b0 = tab[3],
               b1 = tab[4];
  const double* pw = tab + 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = min(tid * chunk, M), t1 = min(t0 + chunk, M);
  double w1 = 0.0, w2 = 0.0, w3 = 0.0;
  for (int t = t0; t < t1; ++t) {  // zero-start end state z_k
    const double wt = in(t) + a0 * w1 + a1 * w2 + a2 * w3;
    w3 = w2;
    w2 = w1;
    w1 = wt;
  }
  V3 v = {w1, w2, w3};
  for (int o = 1; o < 32; o <<= 1) {  // v_l = sum_{j<=l} P^(l-j) z_j
    const V3 u = shfl_up(v, o);
    if (lane >= o) v = add(v, matvec(pw + 9 * o, u));
  }
  const V3 prev = shfl_up(v, 1);
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {  // across warps: G_w = sum_{u<=w} (P^32)^(w-u) T_u
    V3 g = tot[lane];
    for (int o = 1, k = 0; o < WARPS; o <<= 1, ++k) {
      const V3 u = shfl_up(g, o);
      if (lane >= o) g = add(g, matvec(pw + 9 * (32 + k), u));
    }
    tot[lane] = g;
  }
  __syncthreads();
  // start state of chunk k = 32w + l: E_{k-1} = I_{k-1} + P^l G_{w-1}
  V3 s = lane > 0 ? prev : V3{0.0, 0.0, 0.0};
  if (warp > 0) s = add(s, matvec(pw + 9 * lane, tot[warp - 1]));
  w1 = s.a;
  w2 = s.b;
  w3 = s.c;
  for (int t = t0; t < t1; ++t) {
    const double wt = in(t) + a0 * w1 + a1 * w2 + a2 * w3;
    out(t, b0 * wt + b1 * w1 + b1 * w2 + b0 * w3);
    w3 = w2;
    w2 = w1;
    w1 = wt;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
harvest_decimate_kernel(const T* __restrict__ x, int n, int r, int chunk,
                        int nbeg, int count, const double* __restrict__ tab,
                        double* __restrict__ scratch, T* __restrict__ out) {
  __shared__ V3 tot[WARPS];
  const int M = n + 2 * PAD;
  const T* xr = x + (size_t)blockIdx.x * n;
  double* sc = scratch + (size_t)blockIdx.x * M;
  T* o = out + (size_t)blockIdx.x * count;
  filter_pass([&](int t) { return padded(xr, n, t); },
              [&](int t, double y) { sc[t] = y; }, M, chunk, tab, tot);
  // pass 2 on the reversed row; its output reversed again is picked at
  // nbeg + k*r + 8, i.e. at t = M - 1 - (nbeg + 8) - k*r
  const int last = M - 1 - nbeg - (PAD - 1);
  filter_pass([&](int t) { return sc[M - 1 - t]; },
              [&](int t, double y) {
                const int d = last - t;
                if (d >= 0 && d % r == 0 && d / r < count) o[d / r] = (T)y;
              },
              M, chunk, tab, tot);
}

}  // namespace

// f64: 0 for float rows x and out, 1 for double.
extern "C" int harvest_decimate_launch(const void* x, int B, int n, int r,
                                       int chunk, int nbeg, int count,
                                       int f64, const double* tab,
                                       double* scratch, void* out,
                                       cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if ((long long)chunk * THREADS < (long long)n + 2 * PAD)
    return (int)cudaErrorInvalidValue;
  if (f64)
    harvest_decimate_kernel<double><<<B, THREADS, 0, s>>>(
        static_cast<const double*>(x), n, r, chunk, nbeg, count, tab, scratch,
        static_cast<double*>(out));
  else
    harvest_decimate_kernel<float><<<B, THREADS, 0, s>>>(
        static_cast<const float*>(x), n, r, chunk, nbeg, count, tab, scratch,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}
