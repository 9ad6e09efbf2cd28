// K37: the SPTK engine's MGLSA synthesis filter (MGLSADF), as the JAX
// package realises it: each frame's excitation through the frame's exact
// transfer function by a windowed overlap-add.  Two launchers:
//
// - frames (mglsa_frames_launch) replaces
//   hts_train_world_tpu/ops/excitation.py:110-139 with ops/codec.py:198-208
//   (mgc2sp_real), which on the TPU ran a (T, m+1) x (m+1, N/2+1) freqt
//   product, an rfft for log |H|, the exp, a (T, 2 shift) gather of Hann
//   segments, rfft, the product and irfft over every frame.  Here one
//   block a frame: log H[k] = sum_m mgc[m] G[m, k] with G the folded
//   (m+1, N/2+1) table (freqt to N/2 at -alpha, then the cosine sum; as K22
//   folds c2acr's transform), H = exp; the frame's L = 2 shift segment of
//   the excitation (zeros before 0 and past n) times the Hann window into
//   shared memory; a radix-2 complex FFT of N in shared memory (the
//   segment in the real part, bit-reversed on load), the product with H
//   (real and even), the inverse FFT; the L + 2K taps the overlap-add
//   uses, [-K, L+K) with K = 2 shift (zero phase: the negative times wrap
//   to the end of the buffer), into a (T, L+2K) scratch array.  An N that
//   is not a power of two takes a direct DFT in the same kernel: the L
//   non-zero inputs to the N/2+1 bins, then the L + 2K outputs.
// - overlap-add (mglsa_ola_launch) replaces :140-145, the scatter-add
//   out.at[idx].add(taps): a gather, a thread an output sample, summing
//   the (at most ceil((L+2K)/shift)) frames that cover it in frame order
//   from 0.0, the order of XLA's CPU scatter and of the twin's
//   index_add_.  No atomics.
//
// Bound: operations.  A frame's (m+1)(N/2+1) multiply-adds and exps for H
// and two FFTs of N (5 N log2 N each), against the excitation read and
// the taps written once.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXM = 256;

template <typename T>
__device__ __forceinline__ void sincospi_t(T x, T* s, T* c);
template <>
__device__ __forceinline__ void sincospi_t<double>(double x, double* s,
                                                   double* c) {
  sincospi(x, s, c);
}
template <>
__device__ __forceinline__ void sincospi_t<float>(float x, float* s,
                                                  float* c) {
  sincospif(x, s, c);
}

// In-place radix-2 FFT of N = 2^logN points (re, im in shared memory),
// input in bit-reversed order, sign -1 forward, +1 inverse.
template <typename T>
__device__ void fft_stages(T* re, T* im, int N, T sign) {
  for (int len = 2; len <= N; len <<= 1) {
    const int half = len >> 1;
    for (int q = threadIdx.x; q < N / 2; q += THREADS) {
      const int pos = q % half;
      const int i = (q / half) * len + pos;
      const int j = i + half;
      T s, c;
      sincospi_t<T>((T)2 * (T)pos / (T)len, &s, &c);
      s = sign * s;
      const T tr = c * re[j] - s * im[j];
      const T ti = c * im[j] + s * re[j];
      re[j] = re[i] - tr;
      im[j] = im[i] - ti;
      re[i] = re[i] + tr;
      im[i] = im[i] + ti;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mglsa_frames_kernel(const T* __restrict__ exc, long long n,
                    const T* __restrict__ mgc, int M,
                    const T* __restrict__ G, const T* __restrict__ win,
                    int shift, int N, int logN, T* __restrict__ taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int F = N / 2 + 1;
  const int L = 2 * shift, K = 2 * shift, W = L + 2 * K;
  const int t = blockIdx.x;
  T* cm = sm;              // M
  T* H = cm + M;           // F
  T* re = H + F;           // N (power of two) or L (the segment)
  T* im = re + (logN >= 0 ? N : L);   // N, or the F bins' real parts
  T* xi = im + F;          // the direct DFT's F imaginary parts

  for (int m = threadIdx.x; m < M; m += THREADS)
    cm[m] = mgc[(size_t)t * M + m];
  __syncthreads();
  for (int k = threadIdx.x; k < F; k += THREADS) {
    T s = (T)0;
    for (int m = 0; m < M; ++m) s = s + cm[m] * G[(size_t)m * F + k];
    H[k] = exp(s);
  }
  // the segment pad[t shift + j] = exc[t shift + j - shift], times win
  const long long s0 = (long long)t * shift - shift;
  T* row = taps + (size_t)t * W;
  if (logN >= 0) {
    for (int j = threadIdx.x; j < N; j += THREADS) {
      re[j] = (T)0;
      im[j] = (T)0;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < L; j += THREADS) {
      const long long p = s0 + j;
      const T x = (p >= 0 && p < n) ? exc[p] : (T)0;
      re[__brev((unsigned)j) >> (32 - logN)] = x * win[j];
    }
    __syncthreads();
    fft_stages(re, im, N, (T)-1);
    for (int k = threadIdx.x; k < N; k += THREADS) {
      const T h = H[k <= N / 2 ? k : N - k];
      re[k] = re[k] * h;
      im[k] = im[k] * h;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < N; k += THREADS) {
      const int r = (int)(__brev((unsigned)k) >> (32 - logN));
      if (k < r) {
        const T a = re[k], b = im[k];
        re[k] = re[r];
        im[k] = im[r];
        re[r] = a;
        im[r] = b;
      }
    }
    __syncthreads();
    fft_stages(re, im, N, (T)1);
    for (int u = threadIdx.x; u < W; u += THREADS)
      row[u] = re[u < K ? N - K + u : u - K] / (T)N;
    return;
  }
  // direct DFT: the segment's L values to the F bins, times H
  for (int j = threadIdx.x; j < L; j += THREADS) {
    const long long p = s0 + j;
    re[j] = ((p >= 0 && p < n) ? exc[p] : (T)0) * win[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < F; k += THREADS) {
    T sr = (T)0, si = (T)0;
    for (int j = 0; j < L; ++j) {
      T s, c;
      sincospi_t<T>((T)2 * (T)(((long long)j * k) % N) / (T)N, &s, &c);
      sr = sr + re[j] * c;
      si = si - re[j] * s;
    }
    im[k] = sr * H[k];
    xi[k] = si * H[k];
  }
  __syncthreads();
  // irfft at the W outputs used: bins 1.. count twice but N/2 of an even
  // N; the imaginary parts of bins 0 and N/2 are dropped, as numpy's
  for (int u = threadIdx.x; u < W; u += THREADS) {
    const int nn = u < K ? N - K + u : u - K;
    T y = im[0];
    for (int k = 1; k < F; ++k) {
      T s, c;
      sincospi_t<T>((T)2 * (T)(((long long)k * nn) % N) / (T)N, &s, &c);
      y = (2 * k == N) ? y + im[k] * c
                       : y + (T)2 * (im[k] * c - xi[k] * s);
    }
    row[u] = y / (T)N;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mglsa_ola_kernel(const T* __restrict__ taps, int Tn, int shift, int W,
                 long long n, T* __restrict__ out) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const long long p = q + W / 2;     // K + shift = (L + 2K) / 2
  long long t_hi = p / shift;
  t_hi = t_hi < Tn - 1 ? t_hi : Tn - 1;
  const long long lo = p - W + 1;
  const long long t_lo = lo <= 0 ? 0 : (lo + shift - 1) / shift;
  T acc = (T)0;
  for (long long t = t_lo; t <= t_hi; ++t)
    acc = acc + taps[t * W + (p - t * shift)];
  out[q] = acc;
}

template <typename T>
int frames(const void* exc, long long n, const void* mgc, int Tn, int M,
           const void* G, const void* win, int shift, int N, void* taps,
           cudaStream_t s) {
  int logN = -1;
  if ((N & (N - 1)) == 0) {
    logN = 0;
    while ((1 << logN) < N) ++logN;
  }
  const int F = N / 2 + 1, L = 2 * shift;
  const size_t words = logN >= 0 ? (size_t)M + F + 2 * (size_t)N
                                 : (size_t)M + L + 3 * (size_t)F;
  const size_t smem = words * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mglsa_frames_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mglsa_frames_kernel<T><<<Tn, THREADS, smem, s>>>(
      (const T*)exc, n, (const T*)mgc, M, (const T*)G, (const T*)win, shift,
      N, logN, (T*)taps);
  return (int)cudaGetLastError();
}

}  // namespace

// exc (n,), mgc (T, M) with M <= 256, G (M, N/2+1) the folded table, win
// (2 shift,) the Hann window; taps (T, 6 shift) out; 4 shift <= N <=
// 8192; f64 picks double.
extern "C" int mglsa_frames_launch(const void* exc, long long n,
                                   const void* mgc, int T, int M,
                                   const void* G, const void* win, int shift,
                                   int N, int f64, void* taps,
                                   cudaStream_t s) {
  if (M < 1 || M > MAXM || shift < 1 || N < 4 * shift || N > 8192)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  return f64 ? frames<double>(exc, n, mgc, T, M, G, win, shift, N, taps, s)
             : frames<float>(exc, n, mgc, T, M, G, win, shift, N, taps, s);
}

// taps (T, W) with W = 6 shift; out (n,) = the overlap-add's samples
// [K + shift, K + shift + n); f64 picks double.
extern "C" int mglsa_ola_launch(const void* taps, int T, int shift, int W,
                                long long n, int f64, void* out,
                                cudaStream_t s) {
  if (shift < 1 || W != 6 * shift) return (int)cudaErrorInvalidValue;
  if (n <= 0 || T <= 0) return (int)cudaGetLastError();
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  if (f64)
    mglsa_ola_kernel<double><<<blocks, THREADS, 0, s>>>(
        (const double*)taps, T, shift, W, n, (double*)out);
  else
    mglsa_ola_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)taps, T, shift, W, n, (float*)out);
  return (int)cudaGetLastError();
}
