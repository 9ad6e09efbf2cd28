// K37: the SPTK engine's MGLSA synthesis filter (MGLSADF), as the JAX
// package realises it: each frame's excitation through the frame's exact
// transfer function by a windowed overlap-add, float64.  Two launchers:
//
// - frames (mglsa_frames_launch) replaces
//   hts_train_world_tpu/ops/excitation.py:110-139 with ops/codec.py:198-208
//   (mgc2sp_real), which on the TPU ran a (T, m+1) x (m+1, N/2+1) freqt
//   product, an rfft for log |H|, the exp, a (T, 2 shift) gather of Hann
//   segments, rfft, the product and irfft over every frame.  It enqueues
//   two kernels:
//   1. log H = mgc G for all frames as one tiled product on the FP64
//      tensor cores (mma.m8n8k4; G the folded (m+1, N/2+1) table: freqt
//      to N/2 at -alpha, then the cosine sum, as K22 folds c2acr's
//      transform), a block a tile of 32 frames x 64 bins, the tiles of
//      mgc and G staged by cp.async in double-buffered chunks of 16
//      coefficients; H = exp(log H) into a (T, N/2+1) scratch array;
//   2. the frames on K39's register FFT (fft_r2c_core.cuh), as K39 holds
//      rows (N/2 / 16 threads a frame, 2048 / (N/2) frames a block): the
//      frame's L = 2 shift segment of the excitation (zeros before 0 and
//      past n) times the Hann window read straight into registers as z_m
//      = x_2m + i x_2m+1, the forward passes (the sparse plan, a radix-8
//      pass folded into the loads, where fftmat.r2c_plan(N, L) takes it),
//      then per pair of bins k, N/2 - k in one thread: the split to X_k,
//      the product with the real H_k, and the inverse split Z'_k = (Y_k +
//      conj Y_(M-k)) + i W_N^-k (Y_k - conj Y_(M-k)) written back in
//      place; the same passes (dense plan) on conj Z' give N y = conj of
//      the result, and only the W = 6 shift taps the overlap-add uses,
//      [-K, L+K) with K = 2 shift (zero phase: the negative times wrap to
//      the end of the buffer), are written, into a (T, W) scratch array.
//      Twiddles from K39's tables, no sin or cos.  An N that is not a
//      power of two in [64, 8192] takes a direct DFT instead: the L
//      non-zero inputs to the N/2+1 bins, then the W outputs.
// - overlap-add (mglsa_ola_launch) replaces :140-145, the scatter-add
//   out.at[idx].add(taps): a gather, a thread an output sample, summing
//   the (at most ceil(W/shift)) frames that cover it in frame order from
//   0.0, the order of XLA's CPU scatter and of the twin's index_add_.  No
//   atomics.
//
// Bound: operations.  A frame's (m+1)(N/2+1) multiply-adds at the FP64
// tensor cores' rate, the exps and two real FFTs of N (2.5 N log2 N each),
// against the excitation read and the taps written once.
#include "common.cuh"
#include "fft_r2c_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXM = 256;

using r2c::C2;

// ---- 1. H = exp(mgc G) ----

constexpr int HF = 32, HB = 64, HK = 16;   // frames, bins, chunk
constexpr int H_THREADS = 128;             // 4 warps x 8 frames

__device__ __forceinline__ void copy8_async(double* dst, const double* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(ok ? src : nullptr), "r"(ok ? 8 : 0)
               : "memory");
}

// D += A B on the FP64 tensor cores: an 8 x 4 tile of A (lane: row lane/4,
// column lane%4), a 4 x 8 tile of B (row lane%4, column lane/4), the 8 x 8
// sums (row lane/4, columns 2 (lane%4) and the next)
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(H_THREADS)
mglsa_h_kernel(const double* __restrict__ mgc, int Tn, int M, int ldm,
               const double* __restrict__ G, int F, double* __restrict__ H) {
  __shared__ __align__(16) double As[2][HK][HF];   // [k][frame]
  __shared__ __align__(16) double Gs[2][HK][HB];   // [k][bin]
  const int f0 = blockIdx.y * HF, b0 = blockIdx.x * HB;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nch = (M + HK - 1) / HK;
  auto stage = [&](int c, int p) {
    const int k0 = c * HK;
    for (int i = tid; i < HK * HF; i += H_THREADS) {
      const int f = i / HK, k = i % HK;          // along an mgc row
      const bool ok = f0 + f < Tn && k0 + k < M;
      copy8_async(&As[p][k][f], mgc + (size_t)(f0 + f) * ldm + k0 + k, ok);
    }
    for (int i = tid; i < HK * HB; i += H_THREADS) {
      const int k = i / HB, j = i % HB;
      const bool ok = k0 + k < M && b0 + j < F;
      copy8_async(&Gs[p][k][j], G + (size_t)(k0 + k) * F + b0 + j, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  double acc[2 * HB / 8];
#pragma unroll
  for (int j = 0; j < 2 * HB / 8; ++j) acc[j] = 0.0;
  stage(0, 0);
  const int ka = lane & 3, fa = 8 * w + (lane >> 2);
  for (int c = 0; c < nch; ++c) {
    const int p = c & 1;
    if (c + 1 < nch) {
      stage(c + 1, p ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < HK; k0 += 4) {
      const double a = As[p][k0 + ka][fa];
#pragma unroll
      for (int j = 0; j < HB / 8; ++j)
        dmma(acc[2 * j], acc[2 * j + 1], a,
             Gs[p][k0 + ka][8 * j + (lane >> 2)]);
    }
    __syncthreads();   // the buffer is restaged two chunks on
  }
  const int f = f0 + fa;
  if (f >= Tn) return;
  double* Hr = H + (size_t)f * F;
#pragma unroll
  for (int j = 0; j < HB / 8; ++j) {
    const int bin = b0 + 8 * j + 2 * ka;
    if (bin < F) Hr[bin] = exp(acc[2 * j]);
    if (bin + 1 < F) Hr[bin + 1] = exp(acc[2 * j + 1]);
  }
}

// ---- 2. the frames on K39's core ----

template <int M, bool SP>
__global__ void __launch_bounds__(r2c::Geometry<M>::THREADS)
mglsa_fft_kernel(const double* __restrict__ exc, long long n,
                 const double* __restrict__ H,
                 const double* __restrict__ win, int Tn, int shift,
                 const double2* __restrict__ tw_f,
                 const double2* __restrict__ tw_i,
                 double* __restrict__ taps) {
  using G = r2c::Geometry<M>;
  constexpr int N = 2 * M;
  extern __shared__ __align__(16) double smem[];
  const int q = threadIdx.x / G::T, t = threadIdx.x % G::T;
  const int row = blockIdx.x * G::RPB + q;
  const bool live = row < Tn;
  const int fr = live ? row : 0;
  double* sre = smem + (size_t)q * 2 * G::MP;
  double* sim = sre + G::MP;
  const int L = 2 * shift, K = 2 * shift, W = 6 * shift, Lz = (L + 1) >> 1;
  // the segment pad[fr shift + j] = exc[fr shift + j - shift], times win
  const long long s0 = (long long)fr * shift - shift;
  auto x = [&](int j) -> double {
    const long long p = s0 + j;
    return (j < L && p >= 0 && p < n) ? exc[p] * win[j] : 0.0;
  };
  auto z = [&](int m) -> C2 { return {x(2 * m), x(2 * m + 1)}; };
  C2 v[r2c::P];
  if constexpr (SP) {
    // the folded radix-8 pass: d1[i] = z[i/8] + z[i/8 + M/8] W_8^(i mod 8)
    constexpr int R0 = r2c::radix(M, true, 0);
#pragma unroll
    for (int b = 0; b < r2c::P / R0; b++) {
#pragma unroll
      for (int r = 0; r < R0; r++) {
        const int i = t + b * G::T + r * (M / R0), j1 = i >> 3;
        C2 d = z(j1);
        if (j1 + M / 8 < Lz)
          d = r2c::add(d, r2c::mul_w8(z(j1 + M / 8), i & 7));
        v[b * R0 + r] = d;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < r2c::P; r++) v[r] = z(t + r * G::T);
  }
  r2c::passes<M, SP, 0, false>(v, sre, sim, tw_f, t);
  // per pair of bins: X_k and X_(M-k) from A = Z_k, B = Z_(M-k), times H,
  // then Z'_k and Z'_(M-k), conjugated, back in their places (each place
  // is read and written by this thread alone)
  const double* Hr = H + (size_t)fr * (M + 1);
  auto pair = [&](int k) {
    const int ia = r2c::pad(k), ib = r2c::pad((M - k) & (M - 1));
    const C2 a = {sre[ia], sim[ia]}, b = {sre[ib], sim[ib]};
    const double er = (a.x + b.x) * 0.5, ei = (a.y - b.y) * 0.5;
    const double ox = (a.y + b.y) * 0.5, oy = -((a.x - b.x) * 0.5);
    const double2 w = tw_f[k];
    const double px = ox * w.x - oy * w.y, py = ox * w.y + oy * w.x;
    const double h0 = Hr[k], h1 = Hr[M - k];
    const C2 y0 = {(er + px) * h0, (ei + py) * h0};      // Y_k
    const C2 y1 = {(er - px) * h1, (py - ei) * h1};      // Y_(M-k)
    // Z'_k = (Y_k + conj Y_(M-k)) + i conj(W) (Y_k - conj Y_(M-k)), and
    // Z'_(M-k) the same with the two swapped and W_N^-(M-k) = -W_N^k
    auto inv = [&](C2 u, C2 c, double wr, double wi) -> C2 {
      const double sr = u.x + c.x, si = u.y - c.y;       // u + conj c
      const double dr = u.x - c.x, di = u.y + c.y;       // u - conj c
      // conj(w) (dr, di), then times i
      const double tr = wr * dr + wi * di, ti = wr * di - wi * dr;
      return {sr - ti, si + tr};
    };
    const C2 z0 = inv(y0, y1, w.x, w.y);
    sre[ia] = z0.x;
    sim[ia] = -z0.y;
    if (k != 0 && 2 * k != M) {
      const C2 z1 = inv(y1, y0, -w.x, w.y);
      sre[ib] = z1.x;
      sim[ib] = -z1.y;
    }
  };
#pragma unroll
  for (int i = 0; i < r2c::P / 2; i++) pair(t + i * G::T);
  if (t == 0) pair(M / 2);
  __syncthreads();
  r2c::gather<M, r2c::radix(M, false, 0), false, false>(v, sre, sim, t);
  __syncthreads();
  r2c::passes<M, false, 0, false>(v, sre, sim, tw_i, t);
  if (!live) return;
  // y_2m = Re w_m / N, y_2m+1 = -Im w_m / N; the taps [-K, L+K)
  double* out = taps + (size_t)row * W;
  constexpr double inv_n = 1.0 / N;
  for (int u = t; u < W; u += G::T) {
    const int nn = u < K ? N - K + u : u - K;
    const int i = r2c::pad(nn >> 1);
    out[u] = ((nn & 1) ? -sim[i] : sre[i]) * inv_n;
  }
}

// the direct DFT, for N outside K39's sizes: the segment's L values to
// the F bins, times H, then the W outputs
__global__ void __launch_bounds__(THREADS)
mglsa_dft_kernel(const double* __restrict__ exc, long long n,
                 const double* __restrict__ H,
                 const double* __restrict__ win, int shift, int N,
                 double* __restrict__ taps) {
  extern __shared__ __align__(16) double sm[];
  const int F = N / 2 + 1;
  const int L = 2 * shift, K = 2 * shift, W = L + 2 * K;
  const int t = blockIdx.x;
  double* seg = sm;        // L
  double* yr = seg + L;    // F
  double* yi = yr + F;     // F
  const double* Hr = H + (size_t)t * F;
  const long long s0 = (long long)t * shift - shift;
  for (int j = threadIdx.x; j < L; j += THREADS) {
    const long long p = s0 + j;
    seg[j] = ((p >= 0 && p < n) ? exc[p] : 0.0) * win[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < F; k += THREADS) {
    double sr = 0.0, si = 0.0;
    for (int j = 0; j < L; ++j) {
      double s, c;
      sincospi(2.0 * (double)(((long long)j * k) % N) / (double)N, &s, &c);
      sr = sr + seg[j] * c;
      si = si - seg[j] * s;
    }
    yr[k] = sr * Hr[k];
    yi[k] = si * Hr[k];
  }
  __syncthreads();
  // irfft at the W outputs used: bins 1.. count twice but N/2 of an even
  // N; the imaginary parts of bins 0 and N/2 are dropped, as numpy's
  double* row = taps + (size_t)t * W;
  for (int u = threadIdx.x; u < W; u += THREADS) {
    const int nn = u < K ? N - K + u : u - K;
    double y = yr[0];
    for (int k = 1; k < F; ++k) {
      double s, c;
      sincospi(2.0 * (double)(((long long)k * nn) % N) / (double)N, &s, &c);
      y = (2 * k == N) ? y + yr[k] * c : y + 2.0 * (yr[k] * c - yi[k] * s);
    }
    row[u] = y / (double)N;
  }
}

__global__ void __launch_bounds__(THREADS)
mglsa_ola_kernel(const double* __restrict__ taps, int Tn, int shift, int W,
                 long long n, double* __restrict__ out) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const long long p = q + W / 2;     // K + shift = (L + 2K) / 2
  long long t_hi = p / shift;
  t_hi = t_hi < Tn - 1 ? t_hi : Tn - 1;
  const long long lo = p - W + 1;
  const long long t_lo = lo <= 0 ? 0 : (lo + shift - 1) / shift;
  double acc = 0.0;
  for (long long t = t_lo; t <= t_hi; ++t)
    acc = acc + taps[t * W + (p - t * shift)];
  out[q] = acc;
}

template <int M, bool SP>
int launch_fft(const double* exc, long long n, const double* H,
               const double* win, int Tn, int shift, const void* tw_f,
               const void* tw_i, double* taps, cudaStream_t s) {
  using G = r2c::Geometry<M>;
  auto kern = mglsa_fft_kernel<M, SP>;
  if constexpr (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (Tn + G::RPB - 1) / G::RPB;
  kern<<<blocks, G::THREADS, G::SMEM, s>>>(
      exc, n, H, win, Tn, shift, static_cast<const double2*>(tw_f),
      static_cast<const double2*>(tw_i), taps);
  return (int)cudaGetLastError();
}

template <int M>
int launch_m(const double* exc, long long n, const double* H,
             const double* win, int Tn, int shift, const void* tw_f,
             const void* tw_i, int sparse, double* taps, cudaStream_t s) {
  if (!sparse)
    return launch_fft<M, false>(exc, n, H, win, Tn, shift, tw_f, tw_i, taps,
                                s);
  if constexpr (r2c::sparse_ok(M)) {
    if ((2 * shift + 1) / 2 > M / 4) return (int)cudaErrorInvalidValue;
    return launch_fft<M, true>(exc, n, H, win, Tn, shift, tw_f, tw_i, taps,
                               s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

int frames_fft(const double* exc, long long n, const double* H,
               const double* win, int Tn, int shift, int N, const void* tw_f,
               const void* tw_i, int sparse, double* taps, cudaStream_t s) {
  switch (N) {
#define CASE(NN)                                                            \
  case NN:                                                                  \
    return launch_m<NN / 2>(exc, n, H, win, Tn, shift, tw_f, tw_i, sparse,  \
                            taps, s);
    CASE(64) CASE(128) CASE(256) CASE(512) CASE(1024) CASE(2048) CASE(4096)
    CASE(8192)
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

// exc (n,), mgc (T, M) with M <= 256 and rows ldm apart, G (M, N/2+1)
// the folded table, win (2 shift,) the Hann window, float64; tw_f and
// tw_i K39's tables (fftmat.r2c_table_np(N, sparse) and (N, False)) where
// N is a power of two in [64, 8192] (else null: the direct DFT), sparse
// the forward's plan; scratch H (T, N/2+1); taps (T, 6 shift) out;
// 4 shift <= N <= 8192.
extern "C" int mglsa_frames_launch(const void* exc, long long n,
                                   const void* mgc, int T, int M, int ldm,
                                   const void* G, const void* win, int shift,
                                   int N, const void* tw_f, const void* tw_i,
                                   int sparse, void* H, void* taps,
                                   cudaStream_t s) {
  if (M < 1 || M > MAXM || ldm < M || shift < 1 || N < 4 * shift
      || N > 8192)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  const int F = N / 2 + 1;
  const dim3 hgrid((F + HB - 1) / HB, (T + HF - 1) / HF);
  mglsa_h_kernel<<<hgrid, H_THREADS, 0, s>>>(
      (const double*)mgc, T, M, ldm, (const double*)G, F, (double*)H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (tw_f != nullptr && tw_i != nullptr) {
    const int rc = frames_fft((const double*)exc, n, (const double*)H,
                              (const double*)win, T, shift, N, tw_f, tw_i,
                              sparse, (double*)taps, s);
    return rc < 0 ? (int)cudaErrorInvalidValue : rc;
  }
  const size_t smem = (2 * (size_t)shift + 2 * (size_t)F) * sizeof(double);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(mglsa_dft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mglsa_dft_kernel<<<T, THREADS, smem, s>>>(
      (const double*)exc, n, (const double*)H, (const double*)win, shift, N,
      (double*)taps);
  return (int)cudaGetLastError();
}

// taps (T, W) with W = 6 shift; out (n,) = the overlap-add's samples
// [K + shift, K + shift + n), float64.
extern "C" int mglsa_ola_launch(const void* taps, int T, int shift, int W,
                                long long n, void* out, cudaStream_t s) {
  if (shift < 1 || W != 6 * shift) return (int)cudaErrorInvalidValue;
  if (n <= 0 || T <= 0) return (int)cudaGetLastError();
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  mglsa_ola_kernel<<<blocks, THREADS, 0, s>>>((const double*)taps, T, shift,
                                              W, n, (double*)out);
  return (int)cudaGetLastError();
}
