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
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float TWO_PI_F32 = 6.2831855f;      // float32(2 pi)
constexpr float SAFE_GUARD = 1e-12f;          // kMySafeGuardMinimum
// the twin's order of the six-term sums (ops/stonemask.py SUM_ORDER)
__device__ __constant__ int SUM_ORDER[6] = {0, 4, 5, 1, 2, 3};

__device__ __forceinline__ long long matlab_round(float x) {
  return (long long)truncf(x > 0.f ? x + 0.5f : x - 0.5f);
}

// sum_k amp_k inst_k / (sum_k amp_k k + guard) over the first `nh` of six
// harmonics of f0 `seed`; masked terms are multiplied by 0 as in the twin.
__device__ float fix(const float* __restrict__ smr,
                     const float* __restrict__ smi,
                     const float* __restrict__ sdr,
                     const float* __restrict__ sdi, float seed, float bcf,
                     long long bc, long long r, float fsf, int nh) {
  const float q = (seed * bcf) / fsf;
  float num = 0.f, den = 0.f;
  for (int j = 0; j < 6; ++j) {
    const int k = SUM_ORDER[j];
    const float kf = (float)(k + 1);
    long long ic = matlab_round(q * kf);
    if (ic < 0) ic = 0;
    if (ic > bc / 2) ic = bc / 2;
    const long long idx = ic * r;
    const float a = smr[idx], b = smi[idx], c = sdr[idx], d = sdi[idx];
    const float p = a * a + b * b;
    const float n = a * d - b * c;
    const float inst =
        p == 0.f ? 0.f
                 : ((float)ic * fsf) / bcf + ((n / p) * fsf) / TWO_PI_F32;
    const float amp = sqrtf(p);
    const float m = k < nh ? 1.f : 0.f;
    const float tn = amp * inst * m, td = amp * kf * m;
    if (j == 0) {
      num = tn;
      den = td;
    } else {
      num = num + tn;
      den = den + td;
    }
  }
  return num / (den + SAFE_GUARD);
}

__global__ void __launch_bounds__(THREADS)
stonemask_if_kernel(const float* __restrict__ smr,
                    const float* __restrict__ smi,
                    const float* __restrict__ sdr,
                    const float* __restrict__ sdi, int R, int H,
                    const float* __restrict__ f0s,
                    const int* __restrict__ h,
                    const unsigned char* __restrict__ gate, float fsf,
                    int b_max, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= R) return;
  if (gate[i]) {
    out[i] = 0.f;
    return;
  }
  const size_t o = (size_t)i * H;
  const int e = 31 - __clz(2 * h[i] + 1);     // floor(log2(2h+1))
  const long long bc = 4LL << e;
  const long long r = (long long)(b_max / 4) / (bc / 4);
  const float bcf = (float)bc;
  const float f0 = f0s[i];
  const float t1 = fix(smr + o, smi + o, sdr + o, sdi + o, f0, bcf, bc, r,
                       fsf, 2);
  const bool ok1 = (t1 > 0.f) & (t1 <= f0 * 2.0f);
  const float t2 = fix(smr + o, smi + o, sdr + o, sdi + o, t1, bcf, bc, r,
                       fsf, 6);
  const float mean_f0 = ok1 ? t2 : 0.f;
  out[i] = fabsf(mean_f0 - f0) / f0 > 0.2f ? f0 : mean_f0;
}

}  // namespace

extern "C" int stonemask_if_launch(const float* smr, const float* smi,
                                   const float* sdr, const float* sdi, int R,
                                   int H, const float* f0s, const int* h,
                                   const unsigned char* gate, float fs,
                                   int b_max, float* out, cudaStream_t s) {
  if (R > 0)
    stonemask_if_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        smr, smi, sdr, sdi, R, H, f0s, h, gate, fs, b_max, out);
  return (int)cudaGetLastError();
}
