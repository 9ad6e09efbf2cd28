// K39's FFT core: the M = N/2-point complex FFT of z_m = x_2m + i x_2m+1
// in float64, held in registers, then the split into the N/2+1 bins of
// rfft(x, N).  It is the port's one FFT core: K37's frames
// (mglsa_filter.cu) run it forward and, on the conjugate of the inverse
// split, backward, and K40 (fft_c2r.cu) runs the inverse that way alone,
// its outputs stored from registers.
//
// Threads.  A row has T = M/16 threads and each thread holds P = 16
// complex points in registers (v[], float64 pairs).  A pass of radix R
// runs 16/R R-point DFTs a thread, written out as unrolled codelets
// (radix 2, 4, 8 and 16; 8 and 16 as 4x2 and 4x4 with their inner
// twiddles as constants).  A block holds 2048/M rows (one at M >= 2048): 128 threads
// up to M = 2048, 256 at M = 4096.
//
// Passes (Stockham, decimation in time).  Pass p of radix R with Ns the
// product of the earlier radices takes butterfly j (j < M/R) from
// d[j + r M/R], turns input r by W_{R Ns}^{r (j mod Ns)}, runs the R-point
// DFT and writes output r to d'[(j - j mod Ns) R + j mod Ns + r Ns]; the
// last pass leaves Z in natural order.  The plan (`n_passes`, `radix`;
// mirrored by fftmat.r2c_plan):
//   dense:  16 x ... x 16 x 2^(log2 M mod 4), e.g. M = 2048: 16 x 16 x 8;
//   sparse: when z is zero past M/4 (L <= N/4), a first radix-8 pass
//           whose inputs past the second are zero; it is folded into the
//           next pass's loads (d1[i] = z[i/8] + z[i/8 + M/8] W_8^(i mod 8))
//           and the rest as dense on M/8, e.g. M = 2048: (8) x 16 x 16.
//           Taken where it saves a pass: M = 64, 128, 512, 1024, 2048.
// The first pass reads its inputs from the row in global memory; inputs
// at m >= ceil(L/2) are zero and neither loaded nor written anywhere.
//
// Exchanges.  Between passes the points go through shared memory as two
// float64 planes (Re, Im) with one pad word every 16 (index i + i/16):
// 8-byte accesses, and every half-warp's 16 reads or writes of a pass
// fall in 16 distinct banks (tests/test_torch_fft_plan.py emulates
// the indices).  Two barriers an exchange; M = 2048: two, between the
// three passes (the bands' sparse plan: one).
//
// Twiddles.  One float64 table a launch size (fftmat._r2c_table), read in
// the threads' order: first W_N^k for the split (k <= M/2), then for each
// pass with Ns > 1 the (R-1) x Ns values W_{R Ns}^(r k), r >= 1, at
// [(r-1) Ns + k], so a warp reads consecutive words.  The codelets' own
// constants are literals.  No sin or cos in the kernel.
//
// The split.  From A = Z_k and B = Z_(M-k), k <= M/2, E = (A + conj B)/2
// and O = (A - conj B)/(2i), X_k = E + W_N^k O and X_(M-k) = conj(E -
// W_N^k O) (W_N^(M-k) = -conj W_N^k): each pair once.  The last pass
// assigns butterflies so that the two of a pair sit in one thread, or in
// lanes l and l+16 of a warp and meet by a shuffle (`last_j`), and the
// split runs on registers; plans of one pass, or rows of fewer than 32
// threads, write Z to shared memory and split from there.
#pragma once
#include <cuda_runtime.h>

namespace r2c {

constexpr int P = 16;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}
// log2 of the points the passes (not the folded sparse pass) cover
__host__ __device__ constexpr int real_log(int M, bool sp) {
  return ilog2(M) - (sp ? 3 : 0);
}
__host__ __device__ constexpr int n_passes(int M, bool sp) {
  return (real_log(M, sp) + 3) / 4;
}
__host__ __device__ constexpr int radix(int M, bool sp, int p) {
  return p < real_log(M, sp) / 4 ? 16 : (1 << (real_log(M, sp) % 4));
}
// the sparse plan is built where it runs fewer passes than the dense
__host__ __device__ constexpr bool sparse_ok(int M) {
  return M >= 64 && n_passes(M, true) < n_passes(M, false);
}

template <int M>
struct Geometry {
  static constexpr int T = M / P;                           // a row's
  static constexpr int RPB = M >= 2048 ? 1 : 2048 / M;      // rows a block
  static constexpr int THREADS = T * RPB;
  static constexpr int MP = M + M / 16;                     // padded plane
  static constexpr size_t SMEM = (size_t)RPB * 2 * MP * sizeof(double);
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// ---- complex helpers (float64) ----

struct C2 {
  double x, y;
};

__device__ __forceinline__ C2 add(C2 a, C2 b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ C2 sub(C2 a, C2 b) { return {a.x - b.x, a.y - b.y}; }
// a * (-i)
__device__ __forceinline__ C2 mul_mi(C2 a) { return {a.y, -a.x}; }
// a * w for a table twiddle
__device__ __forceinline__ C2 mul(C2 a, double wr, double wi) {
  return {__fma_rn(a.x, wr, -(a.y * wi)), __fma_rn(a.x, wi, a.y * wr)};
}

// W_16^e = (cos, -sin)(2 pi e / 16), e in [0, 16), as constants
constexpr double C16_1 = 0.92387953251128674;   // cos(pi/8)
constexpr double S16_1 = 0.38268343236508978;   // sin(pi/8)
constexpr double C16_2 = 0.70710678118654752;   // cos(pi/4)

template <int E>
__device__ __forceinline__ C2 mul_w16(C2 a) {
  constexpr int e = E & 15;
  if constexpr (e == 0) {
    return a;
  } else if constexpr (e == 4) {
    return mul_mi(a);
  } else if constexpr (e == 8) {
    return {-a.x, -a.y};
  } else if constexpr (e == 12) {
    return {-a.y, a.x};
  } else if constexpr (e == 2) {                 // (c, -c)
    return {C16_2 * (a.x + a.y), C16_2 * (a.y - a.x)};
  } else if constexpr (e == 6) {                 // (-c, -c)
    return {C16_2 * (a.y - a.x), -(C16_2 * (a.x + a.y))};
  } else if constexpr (e == 10) {                // (-c, c)
    return {-(C16_2 * (a.x + a.y)), C16_2 * (a.x - a.y)};
  } else if constexpr (e == 14) {                // (c, c)
    return {C16_2 * (a.x - a.y), C16_2 * (a.x + a.y)};
  } else {
    // odd e: cos and sin of 2 pi e / 16 are +-C16_1 or +-S16_1
    constexpr int q = e & 3;                     // 1 or 3
    constexpr double c0 = q == 1 ? C16_1 : S16_1;   // |cos| in quadrant 0
    constexpr double s0 = q == 1 ? S16_1 : C16_1;
    // rotate by the quadrant: e = 4 h + q
    constexpr int h = e >> 2;
    constexpr double c = h == 0 ? c0 : h == 1 ? -s0 : h == 2 ? -c0 : s0;
    constexpr double s = h == 0 ? s0 : h == 1 ? c0 : h == 2 ? -s0 : -c0;
    // W = (c, -s)
    return {a.x * c + a.y * s, a.y * c - a.x * s};
  }
}

// u * W_8^p, p in [0, 8)
__device__ __forceinline__ C2 mul_w8(C2 u, int p) {
  if (p & 1) u = {C16_2 * (u.x + u.y), C16_2 * (u.y - u.x)};
  const int h = p >> 1;                       // times (-i)^h
  if (h == 1) u = {u.y, -u.x};
  else if (h == 2) u = {-u.x, -u.y};
  else if (h == 3) u = {-u.y, u.x};
  return u;
}

// ---- codelets: the R-point forward DFT of v[0..R), in natural order ----

__device__ __forceinline__ void dft2(C2* v) {
  const C2 a = v[0], b = v[1];
  v[0] = add(a, b);
  v[1] = sub(a, b);
}

__device__ __forceinline__ void dft4(C2& a0, C2& a1, C2& a2, C2& a3) {
  const C2 t0 = add(a0, a2), t1 = sub(a0, a2);
  const C2 t2 = add(a1, a3), t3 = mul_mi(sub(a1, a3));
  a0 = add(t0, t2);
  a1 = add(t1, t3);
  a2 = sub(t0, t2);
  a3 = sub(t1, t3);
}

// n = 2 n1 + n2, k = k1 + 4 k2
__device__ __forceinline__ void dft8(C2* v) {
  C2 y[2][4];
#pragma unroll
  for (int n2 = 0; n2 < 2; n2++) {
#pragma unroll
    for (int n1 = 0; n1 < 4; n1++) y[n2][n1] = v[2 * n1 + n2];
    dft4(y[n2][0], y[n2][1], y[n2][2], y[n2][3]);
  }
  y[1][1] = mul_w16<2>(y[1][1]);
  y[1][2] = mul_w16<4>(y[1][2]);
  y[1][3] = mul_w16<6>(y[1][3]);
#pragma unroll
  for (int k1 = 0; k1 < 4; k1++) {
    v[k1] = add(y[0][k1], y[1][k1]);
    v[k1 + 4] = sub(y[0][k1], y[1][k1]);
  }
}

template <int N2, int K1>
__device__ __forceinline__ void tw16(C2& a) { a = mul_w16<N2 * K1>(a); }

// n = 4 n1 + n2, k = k1 + 4 k2
__device__ __forceinline__ void dft16(C2* v) {
  C2 y[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; n2++) {
#pragma unroll
    for (int n1 = 0; n1 < 4; n1++) y[n2][n1] = v[4 * n1 + n2];
    dft4(y[n2][0], y[n2][1], y[n2][2], y[n2][3]);
  }
  tw16<1, 1>(y[1][1]); tw16<1, 2>(y[1][2]); tw16<1, 3>(y[1][3]);
  tw16<2, 1>(y[2][1]); tw16<2, 2>(y[2][2]); tw16<2, 3>(y[2][3]);
  tw16<3, 1>(y[3][1]); tw16<3, 2>(y[3][2]); tw16<3, 3>(y[3][3]);
#pragma unroll
  for (int k1 = 0; k1 < 4; k1++) {
    dft4(y[0][k1], y[1][k1], y[2][k1], y[3][k1]);
#pragma unroll
    for (int k2 = 0; k2 < 4; k2++) v[k1 + 4 * k2] = y[k2][k1];
  }
}

template <int R>
__device__ __forceinline__ void dft(C2* v) {
  if constexpr (R == 2) dft2(v);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else if constexpr (R == 8) dft8(v);
  else dft16(v);
}

// ---- the table's layout ----

// entries of W_N^k, k <= M/2, before the passes' tables
__host__ __device__ constexpr int split_entries(int M) { return M / 2 + 1; }

// pass p's Ns, and the offset of its table (where Ns > 1)
__host__ __device__ constexpr int pass_ns(int M, bool sp, int p) {
  return p == 0 ? (sp ? 8 : 1) : pass_ns(M, sp, p - 1) * radix(M, sp, p - 1);
}
__host__ __device__ constexpr int tw_offset(int M, bool sp, int p) {
  return p == 0 ? split_entries(M)
                : tw_offset(M, sp, p - 1)
                      + (pass_ns(M, sp, p - 1) > 1
                             ? (radix(M, sp, p - 1) - 1) * pass_ns(M, sp, p - 1)
                             : 0);
}

// ---- the pass chain ----

// The last pass pairs butterflies so that each thread can split in
// registers: butterfly j's outputs are Z_(j + r Ns) and butterfly Ns - j's
// are their partners Z_(M - j - r Ns) (0 and Ns/2 pair with themselves).
// With two or more butterflies a thread (B = 16/R), slot 2c holds
// j = t + c T < Ns/2 and slot 2c+1 its partner; with one (B = 1, T >= 32),
// lane l < 16 of warp w holds j = 16 w + l and lane l + 16 its partner,
// and the pair meets by a shuffle.  One-pass plans and rows narrower than
// a warp keep the split through shared memory.
__host__ __device__ constexpr int last_radix(int M, bool sp) {
  return radix(M, sp, n_passes(M, sp) - 1);
}
__host__ __device__ constexpr bool paired(int M, bool sp) {
  return n_passes(M, sp) >= 2 && (P / last_radix(M, sp) >= 2 || M / P >= 32);
}

template <int M, bool SP>
__device__ __forceinline__ int last_j(int t, int b) {
  constexpr int NS = M / last_radix(M, SP), B = P / last_radix(M, SP);
  int j, first;
  if constexpr (B >= 2) {
    j = t + (b >> 1) * Geometry<M>::T;
    first = (b & 1) == 0;
  } else {
    j = 16 * (t >> 5) + (t & 15);
    first = (t & 16) == 0;
  }
  return first ? j : j == 0 ? NS / 2 : NS - j;
}

// the next pass's inputs: butterfly b of this thread (j = t + b T, or the
// last pass's pairing), input r from d[j + r M/R]
template <int M, int R, bool LASTPAIR, bool SP>
__device__ __forceinline__ void gather(C2* v, const double* sre,
                                       const double* sim, int t) {
  constexpr int T = Geometry<M>::T;
#pragma unroll
  for (int b = 0; b < P / R; b++) {
    const int j = LASTPAIR ? last_j<M, SP>(t, b) : t + b * T;
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int i = pad(j + r * (M / R));
      v[b * R + r] = {sre[i], sim[i]};
    }
  }
}

// KEEP: the last pass keeps its outputs in registers in `last_j`'s
// pairing where the plan allows it (K39's split on registers); without
// it every plan ends with Z in natural order in the planes (K37), or,
// with REG, in registers in the natural butterflies j = t + b T: output r
// of butterfly j is Z_(j + r M/R) (K40's stores)
template <int M, bool SP, int p, bool KEEP = true, bool REG = false>
__device__ __forceinline__ void passes(C2* v, double* sre, double* sim,
                                       const double2* __restrict__ tw,
                                       int t) {
  constexpr int R = radix(M, SP, p), NS = pass_ns(M, SP, p);
  constexpr int T = Geometry<M>::T;
  constexpr bool LAST = p + 1 == n_passes(M, SP);
  constexpr bool PAIR = LAST && KEEP && paired(M, SP);
  constexpr bool STAY = PAIR || (LAST && REG);
#pragma unroll
  for (int b = 0; b < P / R; b++) {
    const int j = PAIR ? last_j<M, SP>(t, b) : t + b * T, k = j & (NS - 1);
    if constexpr (NS > 1) {
      const double2* w = tw + tw_offset(M, SP, p) + k;
#pragma unroll
      for (int r = 1; r < R; r++) {
        const double2 wr = w[(r - 1) * NS];
        v[b * R + r] = mul(v[b * R + r], wr.x, wr.y);
      }
    }
    dft<R>(v + b * R);
    if constexpr (!STAY) {
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; r++) {
        const int i = pad(base + r * NS);
        sre[i] = v[b * R + r].x;
        sim[i] = v[b * R + r].y;
      }
    }
  }
  if constexpr (!STAY) __syncthreads();
  if constexpr (!LAST) {
    constexpr bool NEXT_PAIR =
        p + 2 == n_passes(M, SP) && KEEP && paired(M, SP);
    gather<M, radix(M, SP, p + 1), NEXT_PAIR, SP>(v, sre, sim, t);
    __syncthreads();
    passes<M, SP, p + 1, KEEP, REG>(v, sre, sim, tw, t);
  }
}

}  // namespace r2c
