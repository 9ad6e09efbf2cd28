// The complex FFT that K39 (fft_r2c.cu) and K40 (fft_c2r.cu) run on each
// row: M = N/2 points in shared memory, in float64 whatever the rows'
// type, Stockham autosort in place.  Passes of radix 4, with one pass of
// radix 2 first where log2 M is odd.  Pass p, with Ns the product of the
// earlier passes' radices, takes butterfly j (0 <= j < M/R) from
// d[j + r M/R], turns input r by W_{R Ns}^{r (j mod Ns)}, runs the R-point
// DFT and writes output r to d[(j - j mod Ns) R + j mod Ns + r Ns].  Each
// thread reads all of its butterflies' inputs into registers, the block
// meets at a barrier, and then writes their outputs over them: one buffer
// of M double2, 8 N bytes.  A thread a radix-4 butterfly keeps the
// registers a thread needs low, so several blocks share an SM.
//
// Why float64 inside: a float32 FFT's roundings in its last passes sit at
// the scale of the spectrum's peaks (a harmonic frame's peak bin is ~20
// times its row's 2-norm) and spread to every bin, ~2e-6 of the row's
// norm on StoneMask's frames; in float64 only the output's own rounding
// is left.
//
// The twiddles come from a table of W_N^t = (cos, -sin)(2 pi t / N), t <
// N, interleaved, computed on the host in float64 (fftmat._twiddles);
// W_{R Ns}^u is W_N^{u N / (R Ns)}.  The inverse transform reads them
// conjugated.  No sin/cos in the kernels.
#pragma once
#include <cuda_runtime.h>

namespace fft {

// a block has M / 4 threads (at least a warp): one radix-4 butterfly a
// thread, two of radix 2; M / 4 = 1024 at M = 4096
constexpr int MAX_B2 = 2, MAX_THREADS = 1024;

// v * W (W = tw[t], conjugated for the inverse)
template <bool INV>
__device__ __forceinline__ void turn(double2& v,
                                     const double2* __restrict__ tw,
                                     int t) {
  const double2 w = tw[t];
  const double c = w.x, s = INV ? -w.y : w.y;
  const double r = v.x * c - v.y * s;
  v.y = v.x * s + v.y * c;
  v.x = r;
}

// the first pass where log2 M is odd: radix 2 at Ns = 1 (no twiddles)
__device__ __forceinline__ void radix2(double2* d, int M) {
  const int nb = M >> 1;
  double2 v[MAX_B2][2];
#pragma unroll
  for (int i = 0; i < MAX_B2; i++) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nb) {
      v[i][0] = d[j];
      v[i][1] = d[j + nb];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAX_B2; i++) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nb) {
      const double2 a = v[i][0], b = v[i][1];
      d[2 * j] = make_double2(a.x + b.x, a.y + b.y);
      d[2 * j + 1] = make_double2(a.x - b.x, a.y - b.y);
    }
  }
  __syncthreads();
}

template <bool INV>
__device__ __forceinline__ void radix4(double2* d, int M, int Ns, int ts,
                                       const double2* __restrict__ tw) {
  const int nb = M >> 2, j = threadIdx.x;
  double2 a0, a1, a2, a3;
  if (j < nb) {
    a0 = d[j];
    a1 = d[j + nb];
    a2 = d[j + 2 * nb];
    a3 = d[j + 3 * nb];
  }
  __syncthreads();
  if (j < nb) {
    const int k = j & (Ns - 1);
    if (k) {
      const int t = k * ts;
      turn<INV>(a1, tw, t);
      turn<INV>(a2, tw, 2 * t);
      turn<INV>(a3, tw, 3 * t);
    }
    const double t0r = a0.x + a2.x, t0i = a0.y + a2.y;
    const double t1r = a0.x - a2.x, t1i = a0.y - a2.y;
    const double t2r = a1.x + a3.x, t2i = a1.y + a3.y;
    const double dr = a1.x - a3.x, di = a1.y - a3.y;
    // (a1 - a3) times -i (forward) or +i (inverse)
    const double t3r = INV ? -di : di, t3i = INV ? dr : -dr;
    const int o = (j - k) * 4 + k;
    d[o] = make_double2(t0r + t2r, t0i + t2i);
    d[o + Ns] = make_double2(t1r + t3r, t1i + t3i);
    d[o + 2 * Ns] = make_double2(t0r - t2r, t0i - t2i);
    d[o + 3 * Ns] = make_double2(t1r - t3r, t1i - t3i);
  }
  __syncthreads();
}

// The M-point transform of d in place (forward, or inverse unnormalised).
// Every thread of the block calls it, after a barrier that follows the
// writes of d; it ends with one.
template <bool INV>
__device__ void stockham(double2* d, int M, int N,
                         const double2* __restrict__ tw) {
  int Ns = 1;
  if ((__ffs(M) - 1) & 1) {
    radix2(d, M);
    Ns = 2;
  }
  for (; Ns < M; Ns <<= 2) radix4<INV>(d, M, Ns, N / (4 * Ns), tw);
}

// threads a block: one radix-4 butterfly each, at least a warp
inline int block_threads(int M) {
  const int t = M / 4;
  return t < 32 ? 32 : t;
}

inline bool size_ok(int N) {
  return N >= 64 && N <= 8192 && (N & (N - 1)) == 0;
}

// shared memory a row takes: M double2
inline size_t smem_bytes(int N) { return (size_t)(N / 2) * sizeof(double2); }

// opt in to the dynamic shared memory a size needs past 48 KB
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace fft
