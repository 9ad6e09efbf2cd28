// K24: StoneMask's instantaneous-frequency readout, one thread per frame.
//
// Replaces hts_train_world_tpu/ops/stonemask.py:117-140 (`fix` and
// `refine` of the slab formulation), which on the TPU formed the two full
// (frames, B_max/2+1) arrays |sm|^2 and Im(conj(sm) sd) and gathered six
// harmonic bins of each.  Here a thread reads only the <= 12 bins of the
// four DFT outputs its frame needs (bin k*f0*B_c/fs at stride
// r = B_max/B_c) and forms power and numerator there.  Per frame:
// B_c = 4 * 2^floor(log2(2h+1)) (an integer log: 2h+1 is odd, so the
// twin's float log lands on the same integer), pass 1 over 2 harmonics,
// the ok1 test, pass 2 over 6 harmonics seeded with pass 1, the 20 % guard
// and the gate.  The arithmetic is the twin's float32 operations in its
// order (true divisions, the six-term sums in the twin's SUM_ORDER,
// --fmad=false), so the kernel is bit-equal to the twin on the card.
//
// Bound: bytes (12 bins x 4 arrays x 4 B a frame, scattered, plus the
// frame's f0, h, gate and result); the operations are ~300 a frame.
//
// A template on the scalar type.  float64 is the parity analysis: the JAX
// package's bucket path (stonemask.py:170-226 with _fix_f0 at :40-57),
// where each frame's spectra come from a DFT at its own bucket size B_c,
// so the readout runs at bin stride 1 (b_max = B_c) with 2 pi in double.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
// the twin's order of the six-term sums (ops/stonemask.py SUM_ORDER)
__device__ __constant__ int SUM_ORDER[6] = {0, 4, 5, 1, 2, 3};

// 2 pi in each type (float: float32(2 pi), as the twin divides by it)
template <typename T> struct TwoPi;
template <> struct TwoPi<float> { static constexpr float v = 6.2831855f; };
template <> struct TwoPi<double> {
  static constexpr double v = 6.283185307179586;
};

__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ long long matlab_round(T x) {
  return (long long)trunc(x > T(0) ? x + T(0.5) : x - T(0.5));
}

// sum_k amp_k inst_k / (sum_k amp_k k + guard) over the first `nh` of six
// harmonics of f0 `seed`; masked terms are multiplied by 0 as in the twin.
template <typename T>
__device__ T fix(const T* __restrict__ smr, const T* __restrict__ smi,
                 const T* __restrict__ sdr, const T* __restrict__ sdi,
                 T seed, T bcf, long long bc, long long r, T fsf, int nh) {
  const T q = (seed * bcf) / fsf;
  T num = T(0), den = T(0);
  for (int j = 0; j < 6; ++j) {
    const int k = SUM_ORDER[j];
    const T kf = (T)(k + 1);
    long long ic = matlab_round(q * kf);
    if (ic < 0) ic = 0;
    if (ic > bc / 2) ic = bc / 2;
    const long long idx = ic * r;
    const T a = smr[idx], b = smi[idx], c = sdr[idx], d = sdi[idx];
    const T p = a * a + b * b;
    const T n = a * d - b * c;
    const T inst =
        p == T(0) ? T(0)
                  : ((T)ic * fsf) / bcf + ((n / p) * fsf) / TwoPi<T>::v;
    const T amp = sqrt_t(p);
    const T m = k < nh ? T(1) : T(0);
    const T tn = amp * inst * m, td = amp * kf * m;
    if (j == 0) {
      num = tn;
      den = td;
    } else {
      num = num + tn;
      den = den + td;
    }
  }
  return num / (den + T(1e-12));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stonemask_if_kernel(const T* __restrict__ smr, const T* __restrict__ smi,
                    const T* __restrict__ sdr, const T* __restrict__ sdi,
                    int R, int H, const T* __restrict__ f0s,
                    const int* __restrict__ h,
                    const unsigned char* __restrict__ gate, T fsf,
                    int b_max, T* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= R) return;
  if (gate[i]) {
    out[i] = T(0);
    return;
  }
  const size_t o = (size_t)i * H;
  const int e = 31 - __clz(2 * h[i] + 1);     // floor(log2(2h+1))
  const long long bc = 4LL << e;
  const long long r = (long long)(b_max / 4) / (bc / 4);
  const T bcf = (T)bc;
  const T f0 = f0s[i];
  const T t1 = fix(smr + o, smi + o, sdr + o, sdi + o, f0, bcf, bc, r, fsf,
                   2);
  const bool ok1 = (t1 > T(0)) & (t1 <= f0 * T(2));
  const T t2 = fix(smr + o, smi + o, sdr + o, sdi + o, t1, bcf, bc, r, fsf,
                   6);
  const T mean_f0 = ok1 ? t2 : T(0);
  out[i] = abs_t(mean_f0 - f0) / f0 > T(0.2) ? f0 : mean_f0;
}

template <typename T>
int launch(const void* smr, const void* smi, const void* sdr,
           const void* sdi, int R, int H, const void* f0s, const int* h,
           const unsigned char* gate, double fs, int b_max, void* out,
           cudaStream_t s) {
  if (R > 0)
    stonemask_if_kernel<T><<<(R + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const T*>(smr), static_cast<const T*>(smi),
        static_cast<const T*>(sdr), static_cast<const T*>(sdi), R, H,
        static_cast<const T*>(f0s), h, gate, (T)fs, b_max,
        static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// f64: 0 for float tensors (the four spectra, f0s, out), 1 for double.
extern "C" int stonemask_if_launch(const void* smr, const void* smi,
                                   const void* sdr, const void* sdi, int R,
                                   int H, const void* f0s, const int* h,
                                   const unsigned char* gate, double fs,
                                   int b_max, int f64, void* out,
                                   cudaStream_t s) {
  return f64 ? launch<double>(smr, smi, sdr, sdi, R, H, f0s, h, gate, fs,
                              b_max, out, s)
             : launch<float>(smr, smi, sdr, sdi, R, H, f0s, h, gate, fs,
                             b_max, out, s);
}
