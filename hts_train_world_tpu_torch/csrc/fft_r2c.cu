// K39: a batched real forward DFT, rows x (R, L) zero-padded to N points
// -> the N/2+1 bins of rfft(x, N).
//
// Replaces hts_train_world_tpu/ops/fftmat.py:46-83,171-176 (rfft_matmul,
// rfft_power_matmul) and the forward half of :122-155 (minphase_mats):
// on the TPU every per-frame and per-pulse DFT up to 4096 points ran as a
// matmul against cos/sin tables (MATMUL_FFT_LIMIT, :38-43), since XLA's
// TPU FFT ran ~4x off the MXU's pace.  On the H100 this is an FFT, O(N
// log N) a row.
//
// Modes:
//   0 reim:  planar Re and Im (R, N/2+1) (rfft_matmul);
//   1 power: Re^2 + Im^2 (R, N/2+1) (rfft_power_matmul);
//   2 fold:  reim of the input scaled by w_n / N at load, w = 1 at n = 0
//            and n = N/2, else 2 (the cepstral fold of the minimum-phase
//            log spectrum; its first half is K40's half output).
//
// Design (fft_r2c_core.cuh): z_m = x_2m + i x_2m+1 is read from the row
// straight into registers (16 points a thread, every load issued at once
// with its index clamped into the row, the points past the row's L
// samples then set to zero; rows of at most N/4 samples take the sparse
// plan, which skips the first pass), the N/2-point FFT runs in
// radix-16/8 passes in registers with conflict-free exchanges through
// shared memory, twiddles from a table in the threads' order, and the
// split runs on registers and writes each pair of bins once, rounded once
// to the rows' type.  Float64 inside: a float32
// FFT's roundings in its last passes sit at the scale of the spectrum's
// peaks (a harmonic frame's peak bin is ~20x its row's 2-norm) and spread
// to every bin, ~2e-6 of the row's norm on StoneMask's frames.
// --fmad=false: the codelets round unfused; the table twiddles are fused
// multiply-adds by hand.  Shared memory: 17/16 x 16 bytes a point, 2048
// points a block (35 KB; M = 4096: 70 KB, opted in).
//
// Bound: bytes at the launches' sizes (each input word read once, each
// output word written once; the ~2.5 N log2 N operations a row at the
// rows' type's rate take less).  The kernel's own float64 arithmetic is
// the larger for the D4C bands' rows (4096 points for 513 samples).
//
// A template on float and double rows and on N/2 (dense and sparse
// plans); N a power of two in [64, 8192], 1 <= L <= N.
#include "common.cuh"
#include "fft_r2c_core.cuh"

namespace {

enum { REIM = 0, POWER = 1, FOLD = 2 };

using r2c::C2;

template <typename T, int M, bool SP>
__global__ void __launch_bounds__(r2c::Geometry<M>::THREADS)
fft_r2c_kernel(const T* __restrict__ x, int R, int L, int mode,
               const double2* __restrict__ tw, T* __restrict__ out0,
               T* __restrict__ out1) {
  using G = r2c::Geometry<M>;
  extern __shared__ __align__(16) double smem[];
  const int q = threadIdx.x / G::T, t = threadIdx.x % G::T;
  const long long row = (long long)blockIdx.x * G::RPB + q;
  const bool live = row < R;
  double* sre = smem + (size_t)q * 2 * G::MP;
  double* sim = sre + G::MP;
  const T* xr = x + (live ? row : 0) * L;
  const int Lz = (L + 1) >> 1;
  const double inv_n = 0.5 / M;                 // 1/N, exact
  // the two samples of z_m as loaded (indices clamped into the row, so
  // every load is unconditional and all of a thread's loads are in
  // flight together), then zero past the row, folded in FOLD mode
  auto at = [&](int n) { return xr[n < L ? n : L - 1]; };
  auto z = [&](int m, T a, T b) -> C2 {
    double re = 2 * m < L ? (double)a : 0.0;
    double im = 2 * m + 1 < L ? (double)b : 0.0;
    if (mode == FOLD) {
      re *= (m == 0 || 2 * m == M) ? inv_n : 2.0 * inv_n;
      im *= 2.0 * inv_n;
    }
    return {re, im};
  };
  C2 v[r2c::P];
  T raw[2 * r2c::P];
  if constexpr (SP) {
    // the folded radix-8 pass: d1[i] = z[i/8] + z[i/8 + M/8] W_8^(i mod 8)
    constexpr int R0 = r2c::radix(M, true, 0);
#pragma unroll
    for (int b = 0; b < r2c::P / R0; b++) {
#pragma unroll
      for (int r = 0; r < R0; r++) {
        const int j1 = (t + b * G::T + r * (M / R0)) >> 3;
        raw[2 * (b * R0 + r)] = at(2 * j1);
        raw[2 * (b * R0 + r) + 1] = at(2 * j1 + 1);
      }
    }
#pragma unroll
    for (int b = 0; b < r2c::P / R0; b++) {
#pragma unroll
      for (int r = 0; r < R0; r++) {
        const int e = b * R0 + r;
        const int i = t + b * G::T + r * (M / R0), j1 = i >> 3;
        C2 d = z(j1, raw[2 * e], raw[2 * e + 1]);
        if (j1 + M / 8 < Lz) {                  // rare: z past M/8
          const C2 u = z(j1 + M / 8, at(2 * (j1 + M / 8)),
                         at(2 * (j1 + M / 8) + 1));
          d = r2c::add(d, r2c::mul_w8(u, i & 7));
        }
        v[e] = d;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < r2c::P; r++) {
      const int m = t + r * G::T;
      raw[2 * r] = at(2 * m);
      raw[2 * r + 1] = at(2 * m + 1);
    }
#pragma unroll
    for (int r = 0; r < r2c::P; r++)
      v[r] = z(t + r * G::T, raw[2 * r], raw[2 * r + 1]);
  }
  r2c::passes<M, SP, 0>(v, sre, sim, tw, t);
  constexpr bool PAIR = r2c::paired(M, SP);
  constexpr int RL = r2c::last_radix(M, SP), NS = M / RL, B = r2c::P / RL;
  // the partners' outputs a shuffle away (B = 1): Z_(M-k) for k = j + r NS,
  // r < RL/2, is the partner lane's output RL-1-r
  C2 pv[RL / 2];
  if constexpr (PAIR && B == 1) {
#pragma unroll
    for (int r = 0; r < RL / 2; r++)
      pv[r] = {__shfl_xor_sync(0xffffffffu, v[RL - 1 - r].x, 16),
               __shfl_xor_sync(0xffffffffu, v[RL - 1 - r].y, 16)};
  }
  if (!live) return;
  T* o0 = out0 + row * (M + 1);
  T* o1 = mode == POWER ? nullptr : out1 + row * (M + 1);
  // X_k and X_(M-k), k <= M/2, from A = Z_k and B = Z_(M-k)
  auto pair = [&](int k, C2 a, C2 b) {
    const double er = (a.x + b.x) * 0.5, ei = (a.y - b.y) * 0.5;
    const double ox = (a.y + b.y) * 0.5, oy = -((a.x - b.x) * 0.5);
    const double2 w = tw[k];
    const double px = ox * w.x - oy * w.y, py = ox * w.y + oy * w.x;
    const double xr0 = er + px, xi0 = ei + py;   // X_k
    const double xr1 = er - px, xi1 = py - ei;   // X_(M-k)
    if (mode == POWER) {
      o0[k] = (T)(xr0 * xr0 + xi0 * xi0);
      if (k != M - k) o0[M - k] = (T)(xr1 * xr1 + xi1 * xi1);
    } else {
      o0[k] = (T)xr0;
      o1[k] = (T)xi0;
      if (k != M - k) {
        o0[M - k] = (T)xr1;
        o1[M - k] = (T)xi1;
      }
    }
  };
  if constexpr (!PAIR) {
    // through shared memory: k = t + i T < M/2 for i < 8, then M/2
    auto z2 = [&](int k) {
      const int i = r2c::pad(k & (M - 1));
      return C2{sre[i], sim[i]};
    };
#pragma unroll
    for (int i = 0; i < r2c::P / 2; i++) {
      const int k = t + i * G::T;
      pair(k, z2(k), z2(M - k));
    }
    if (t == 0) pair(M / 2, z2(M / 2), z2(M / 2));
  } else if constexpr (B >= 2) {
#pragma unroll
    for (int c = 0; c < B / 2; c++) {
      const C2* a = v + 2 * c * RL;         // butterfly j
      const C2* b = a + RL;                 // its partner
      const int j = t + c * G::T;
      if (j == 0) {                        // butterflies 0 and NS/2
#pragma unroll
        for (int r = 0; r <= RL / 2; r++)
          pair(r * NS, a[r], a[(RL - r) & (RL - 1)]);
#pragma unroll
        for (int r = 0; r < RL / 2; r++)
          pair(NS / 2 + r * NS, b[r], b[RL - 1 - r]);
      } else {
#pragma unroll
        for (int r = 0; r < RL / 2; r++) pair(j + r * NS, a[r], b[RL - 1 - r]);
#pragma unroll
        for (int r = 0; r < RL / 2; r++)
          pair(NS - j + r * NS, b[r], a[RL - 1 - r]);
      }
    }
  } else {
    const int j = r2c::last_j<M, SP>(t, 0);
    if (t == 0) {                          // butterfly 0
#pragma unroll
      for (int r = 0; r <= RL / 2; r++)
        pair(r * NS, v[r], v[(RL - r) & (RL - 1)]);
    } else if (t == 16) {                  // butterfly NS/2
#pragma unroll
      for (int r = 0; r < RL / 2; r++)
        pair(NS / 2 + r * NS, v[r], v[RL - 1 - r]);
    } else {
#pragma unroll
      for (int r = 0; r < RL / 2; r++) pair(j + r * NS, v[r], pv[r]);
    }
  }
}

template <typename T, int M, bool SP>
int launch_plan(const void* x, int R, int L, int mode, const void* tw,
                void* out0, void* out1, cudaStream_t s) {
  using G = r2c::Geometry<M>;
  if constexpr (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_r2c_kernel<T, M, SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (R + G::RPB - 1) / G::RPB;
  fft_r2c_kernel<T, M, SP><<<blocks, G::THREADS, G::SMEM, s>>>(
      static_cast<const T*>(x), R, L, mode, static_cast<const double2*>(tw),
      static_cast<T*>(out0), static_cast<T*>(out1));
  return (int)cudaGetLastError();
}

template <typename T, int M>
int launch_m(const void* x, int R, int L, int mode, const void* tw, int sp,
             void* out0, void* out1, cudaStream_t s) {
  if (!sp) return launch_plan<T, M, false>(x, R, L, mode, tw, out0, out1, s);
  if constexpr (r2c::sparse_ok(M)) {
    if ((L + 1) / 2 > M / 4) return (int)cudaErrorInvalidValue;
    return launch_plan<T, M, true>(x, R, L, mode, tw, out0, out1, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, int R, int L, int N, int mode, const void* tw,
           int sp, void* out0, void* out1, cudaStream_t s) {
  if (L < 1 || L > N || R < 0 || mode < REIM || mode > FOLD
      || (mode != POWER && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  switch (N) {
    case 64: return launch_m<T, 32>(x, R, L, mode, tw, sp, out0, out1, s);
    case 128: return launch_m<T, 64>(x, R, L, mode, tw, sp, out0, out1, s);
    case 256: return launch_m<T, 128>(x, R, L, mode, tw, sp, out0, out1, s);
    case 512: return launch_m<T, 256>(x, R, L, mode, tw, sp, out0, out1, s);
    case 1024: return launch_m<T, 512>(x, R, L, mode, tw, sp, out0, out1, s);
    case 2048: return launch_m<T, 1024>(x, R, L, mode, tw, sp, out0, out1, s);
    case 4096: return launch_m<T, 2048>(x, R, L, mode, tw, sp, out0, out1, s);
    case 8192: return launch_m<T, 4096>(x, R, L, mode, tw, sp, out0, out1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (R, L) contiguous; tw the launch size's float64 table
// (fftmat._r2c_table(N, sparse)); mode 0 (out0 = Re, out1 = Im), 1 (out0
// = power, out1 unused) or 2 (as 0, on the folded input); sparse 1 for
// the sparse plan (ceil(L/2) <= N/8, N/2 in 64, 128, 512, 1024, 2048);
// outputs (R, N/2+1).  f64: 0 for float, 1 for double.
extern "C" int fft_r2c_launch(const void* x, int R, int L, int N, int mode,
                              const void* tw, int sparse, int f64,
                              void* out0, void* out1, cudaStream_t s) {
  return f64 ? launch<double>(x, R, L, N, mode, tw, sparse, out0, out1, s)
             : launch<float>(x, R, L, N, mode, tw, sparse, out0, out1, s);
}
