// K6: the feature encoder's spectral half, mgc and bap in one launch.
//
// Replaces hts_train_world_tpu/ops/codec.py:106-118 (code_spectral_envelope:
// log -> mel-axis gather-lerp -> DCT matmul) as cli.py:45-53 applies it to
// sp and ap (scale by 1e4, sp's zero floor, mgc[0] += 12, bap[0] -= LN_1E4
// with the small-positive snap).  On the TPU that was an XLA elementwise
// pass writing the (rows, N/2) mel-log rows and an MXU matmul reading them
// back.  Here the mel-log rows never touch device memory: the product is
// tiled, and each tile forms its operand in a prologue.
//
// Grid: (tiles of FT = 32 frames) x {sp -> mgc, ap -> bap} (a y-block for
// each 64 coefficients, one each at the default 50 / 25), 256 threads.  A
// block walks the mel axis M in chunks of KC = 32 entries.  For each chunk
// it gathers the chunk's distinct source bins (the wrapper's table of the
// bins the mel axis reads: 806 of 1025 at 48 kHz) for its 32 frames into
// shared memory by cp.async, takes each one's log once (scaled by 1e4, sp's
// zeros floored), lerps them into the A tile (KC x FT), and accumulates the
// product with the chunk of DCT rows (KC x the coefficients, padded to a
// multiple of 8 and staged by cp.async, double-buffered) in registers.  The
// next chunk's bins are gathered while the product runs.  float sums by
// explicit fmaf() (no TF32), 4 frames x 2 coefficients a thread; double on
// the FP64 tensor cores (mma.m8n8k4: a warp's 8 frames x 4 tiles of 8
// coefficients, measured faster than the FMA pipes' fma(), PERF.md §6).
// The epilogue adds 12 to c0 of mgc and takes LN_1E4 from c0 of bap with
// the snap.  Built with --fmad=false, so the lerp rounds as the twin's
// separate operations; the DCT sums in another order than the twin's
// matmul.
//
// Bound: bytes (sp and ap read once: 2 x 8 x 1025 bytes a frame in
// float64) above the DCT's 2 x 1024 x 75 operations a frame.  What the
// kernel spends beyond it: the table read again by every tile (~720 KB
// from L2 each in float64), the logs of the distinct bins (~20 FP64
// operations each), and four block barriers a chunk.
//
// A template on the scalar type: float for the feature lane, double for
// the `analysis` command's parity output (the JAX CLI under x64,
// cli.py:42-56), where the floor, logs, lerp, DCT sums and c0 fixes are
// all in double.
#include "common.cuh"

namespace {

constexpr int NT = 256;   // threads
constexpr int NW = NT / 32;
constexpr int FT = 32;    // frames a tile
constexpr int KC = 32;    // mel entries a chunk
constexpr int GW = 64;    // coefficients a y-block
constexpr int TPF = NT / FT;  // threads a frame in the gather and the logs
constexpr int TF = 4;     // frames a thread (FMA)
constexpr int TQ = 2;     // coefficient slots a thread (FMA; stride 32)
constexpr int TJ = 4;     // 8-wide coefficient tiles a warp (FP64 MMA)

// the CLIs' constants in each type (float: the float32 literals)
template <typename T> struct Lit;
template <> struct Lit<float> {
  static constexpr float ln1e4 = 9.210340f, scale = 1e4f, floor = 1e-4f,
                         c0 = 12.0f;
};
template <> struct Lit<double> {
  static constexpr double ln1e4 = 9.210340, scale = 1e4, floor = 1e-4,
                          c0 = 12.0;
};

__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
// (the float64 forms of fma_t and load4 serve the FMA-pipe build that
// kernel_variants.py times: its `sizeof(T) == 8` branches switched off)
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// asynchronous copies to shared memory, zero-filled where !ok
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(ok ? src : nullptr), "n"(BYTES), "r"(ok ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the A tile's row stride: float64 rows padded by 8 so that the tensor
// cores' fragment loads (4 rows x 8 frames) spread over the banks
template <typename T> __host__ __device__ constexpr int a_stride() {
  return sizeof(T) == 8 ? FT + 8 : FT;
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

// four consecutive frames of the A tile
__device__ __forceinline__ void load4(const float* a, float (&v)[TF]) {
  const float4 u = *reinterpret_cast<const float4*>(a);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const double* a, double (&v)[TF]) {
  const double2 u = *reinterpret_cast<const double2*>(a);
  const double2 w = *reinterpret_cast<const double2*>(a + 2);
  v[0] = u.x; v[1] = u.y; v[2] = w.x; v[3] = w.y;
}

template <typename T>
__global__ void __launch_bounds__(NT, 4)
codec_encode_kernel(const T* __restrict__ sp, const T* __restrict__ ap,
                    int R, int n, const int* __restrict__ ub,
                    const int* __restrict__ iu, const T* __restrict__ st,
                    int M, int nbm, const T* __restrict__ dm, int n_m,
                    int dpm, const T* __restrict__ db, int n_b, int dpb,
                    int bw, T* __restrict__ mgc, T* __restrict__ bap) {
  const int gm = (dpm + GW - 1) / GW;
  const bool is_m = (int)blockIdx.y < gm;
  const int g = is_m ? blockIdx.y : blockIdx.y - gm;
  const T* __restrict__ x = is_m ? sp : ap;
  const T* __restrict__ tab = is_m ? dm : db;
  const int D = is_m ? n_m : n_b, dp = is_m ? dpm : dpb;
  const int col0 = g * GW, width = min(GW, dp - col0);
  T* __restrict__ out = is_m ? mgc : bap;
  const int row0 = blockIdx.x * FT, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const int nbs = nbm | 1;  // odd stride: the lerp's column reads spread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int AS = a_stride<T>();
  T* Bs = reinterpret_cast<T*>(smem_raw);  // 2 x KC x bw
  T* A = Bs + 2 * KC * bw;                 // KC x AS
  T* Raw = A + KC * AS;                    // FT x nbs
  const int nch = (M + KC - 1) / KC;
  int* cu0 = reinterpret_cast<int*>(Raw + FT * nbs);  // each chunk's
  int* cnb = cu0 + nch;  // first bin and bin count
  const int* iu1 = iu + M;
  for (int c = t; c < nch; c += NT) {
    cu0[c] = iu[c * KC];
    cnb[c] = iu1[min(M, c * KC + KC) - 1] - cu0[c] + 1;
  }

  // the chunk's table rows: a 16-byte copy a lane, GW values a row
  auto stage_table = [&](int c) {
    T* dst = Bs + (c & 1) * KC * bw;
    constexpr int V = 16 / sizeof(T);            // values a copy
    constexpr int LPR = GW / V, RPP = 32 / LPR;  // lanes a row, rows a pass
    const int v = (lane % LPR) * V;
#pragma unroll
    for (int i = 0; i < KC / (NW * RPP); ++i) {
      const int k = (NW * i + w) * RPP + lane / LPR, m = c * KC + k;
      if (v < width)
        copy_async<16>(dst + k * bw + v, tab + (size_t)m * dp + col0 + v,
                       m < M);
    }
  };
  // the chunk's bins for the tile's frames: TPF threads a frame, every
  // index load issued before the copies (2 KC bins at most)
  const int fb = t / TPF, ut = t % TPF, rb = row0 + fb;
  const T* __restrict__ xr = x + (size_t)min(rb, R - 1) * n;
  auto stage_bins = [&](int c) {
    T* dst = Raw + fb * nbs;
    const int u0 = cu0[c], nb = cnb[c];
#pragma unroll
    for (int i = 0; i < 2 * KC / TPF; ++i) {
      const int u = ut + TPF * i;
      if (u < nb) copy_async<sizeof(T)>(dst + u, xr + ub[u0 + u], rb < R);
    }
  };

  // FMA: frames f0 + i (i < TF), coefficients dg + 16 (2 qq + h) (qq <
  // TQ); FP64 MMA: frames 8 (w % 4) + lane / 4, tiles 2 jj + h (jj < TJ)
  const int h = w / 4;
  const int f0 = (w % 4) * 8 + (lane >> 4) * TF, dg = lane & 15;
  T acc[TF * TQ];  // FMA: [frame][slot]; FP64 MMA: [tile][2]
#pragma unroll
  for (int i = 0; i < TF * TQ; ++i) acc[i] = T(0);

  __syncthreads();  // the chunk table
  stage_bins(0);
  stage_table(0);
  copy_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) stage_table(c + 1);
    copy_commit();
    copy_wait1();  // the bins and the table of chunk c
    __syncthreads();
    const int u0 = cu0[c], nb = cnb[c];
    // each bin's log once: scaled by 1e4, sp's zeros floored
#pragma unroll
    for (int i = 0; i < 2 * KC / TPF; ++i) {
      const int u = ut + TPF * i;
      if (u < nb) {
        T* v = Raw + fb * nbs + u;
        T y = *v * Lit<T>::scale;
        if (is_m && y == T(0)) y = Lit<T>::floor;
        *v = log_t(y);
      }
    }
    __syncthreads();
    // the lerp onto the mel axis (three roundings, as the twin's): a
    // frame a lane, a mel entry a warp
#pragma unroll
    for (int i = 0; i < KC / NW; ++i) {
      const int k = w + NW * i, m = c * KC + k;
      T a = T(0);
      if (m < M) {
        const T v0 = Raw[lane * nbs + iu[m] - u0];
        const T v1 = Raw[lane * nbs + iu1[m] - u0];
        a = v0 + st[m] * (v1 - v0);
      }
      A[k * AS + lane] = a;
    }
    __syncthreads();
    if (c + 1 < nch) stage_bins(c + 1);
    copy_commit();
    const T* B = Bs + (c & 1) * KC * bw;
    if constexpr (sizeof(T) == 8) {
      // the warp's 8 frames x its tiles of 8 coefficients, k in steps of 4
      const int ka = lane & 3, fa = 8 * (w % 4) + (lane >> 2);
#pragma unroll 2
      for (int k0 = 0; k0 < KC; k0 += 4) {
        const double a = A[(k0 + ka) * AS + fa];
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
          const int j = 2 * jj + h;
          if (8 * j < width)
            dmma(acc[2 * jj], acc[2 * jj + 1], a,
                 B[(k0 + ka) * bw + 8 * j + (lane >> 2)]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        T a[TF], b[TQ];
        load4(A + k * AS + f0, a);
#pragma unroll
        for (int qq = 0; qq < TQ; ++qq) {
          const int d = dg + 16 * (2 * qq + h);
          b[qq] = d < width ? B[k * bw + d] : T(0);
        }
#pragma unroll
        for (int qq = 0; qq < TQ; ++qq)
          if (16 * (2 * qq + h) < width)
#pragma unroll
            for (int i = 0; i < TF; ++i)
              acc[i * TQ + qq] = fma_t(a[i], b[qq], acc[i * TQ + qq]);
      }
    }
    __syncthreads();
  }

  // frame r, coefficient d (both in range): the c0 fixes, the store
  auto put = [&](int r, int d, T o) {
    if (d == 0) {
      if (is_m) {
        o = o + Lit<T>::c0;
      } else {
        o = o - Lit<T>::ln1e4;  // LN_1E4, the CLIs' literal
        if (o > T(0) && o < Lit<T>::floor) o = T(0);
      }
    }
    out[(size_t)r * D + d] = o;
  };
  if constexpr (sizeof(T) == 8) {
    const int r = row0 + 8 * (w % 4) + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = 8 * (2 * jj + h) + 2 * (lane & 3) + i;
        if (d < width && r < R && col0 + d < D)
          put(r, col0 + d, acc[2 * jj + i]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < TF; ++i)
#pragma unroll
      for (int qq = 0; qq < TQ; ++qq) {
        const int r = row0 + f0 + i, d = dg + 16 * (2 * qq + h);
        if (d < width && r < R && col0 + d < D) put(r, col0 + d,
                                                    acc[i * TQ + qq]);
      }
  }
}

template <typename T>
int launch(const void* sp, const void* ap, int R, int n, const int* ub,
           const int* iu, const void* st, int M, int nbm, const void* dm,
           int n_m, int dpm, const void* db, int n_b, int dpb, void* mgc,
           void* bap, cudaStream_t s) {
  // the table's row stride: an odd multiple of 8 values, so the tensor
  // cores' fragment loads (4 rows x 8 coefficients) spread over the banks
  const int bw = min(GW, max(dpm, dpb)) | 8;
  const size_t smem = sizeof(T) * ((size_t)2 * KC * bw
                                   + (size_t)KC * a_stride<T>()
                                   + (size_t)FT * (nbm | 1))
                      + 2 * sizeof(int) * ((M + KC - 1) / KC);
  cudaError_t e = cudaFuncSetAttribute(
      codec_encode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + FT - 1) / FT,
                  (dpm + GW - 1) / GW + (dpb + GW - 1) / GW);
  codec_encode_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(sp), static_cast<const T*>(ap), R, n, ub, iu,
      static_cast<const T*>(st), M, nbm, static_cast<const T*>(dm), n_m, dpm,
      static_cast<const T*>(db), n_b, dpb, bw, static_cast<T*>(mgc),
      static_cast<T*>(bap));
  return (int)cudaGetLastError();
}

}  // namespace

// sp, ap (R, n = M + 1); ub the distinct source bins the mel axis reads,
// iu (2, M) each mel entry's two bins as positions in ub, st (M,) the lerp
// weights; nbm the most bins of ub a chunk of kc mel entries reads; dm (M,
// dpm), db (M, dpb) the DCT matrices, zero-padded to a multiple of 8
// columns -> mgc (R, n_m), bap (R, n_b).  f64: 0 for float tensors, 1 for
// double.
extern "C" int codec_encode_launch(const void* sp, const void* ap, int R,
                                   int n, const int* ub, const int* iu,
                                   const void* st, int M, int kc, int nbm,
                                   const void* dm, int n_m, int dpm,
                                   const void* db, int n_b, int dpb, int f64,
                                   void* mgc, void* bap, cudaStream_t s) {
  if (R <= 0) return (int)cudaGetLastError();
  if (n != M + 1 || kc != KC || nbm < 1 || nbm > 2 * KC + 1 || dpm % 8
      || dpb % 8 || dpm < n_m || dpb < n_b || n_m < 1 || n_b < 1)
    return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(sp, ap, R, n, ub, iu, st, M, nbm, dm, n_m, dpm,
                              db, n_b, dpb, mgc, bap, s)
             : launch<float>(sp, ap, R, n, ub, iu, st, M, nbm, dm, n_m, dpm,
                             db, n_b, dpb, mgc, bap, s);
}
