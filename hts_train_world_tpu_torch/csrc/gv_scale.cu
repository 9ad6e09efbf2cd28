// K23: GV scaling (variance scaling toward the GV model), one block per
// column.
//
// Replaces hts_train_world_tpu/ops/gv.py:22-27 (gv_scale), which pgen's
// generate_parameters runs per GV stream (models/pgen.py:283-302): per
// column the mean and the population variance (two passes, as jnp.var),
// then mean + (gv / max(var, 1e-12))^(w/2) (x - mean).  On the TPU that was
// two reductions and an elementwise pass over the whole (T, D) array, and
// for lf0 a host gather of the voiced, non-MAGIC rows first.  Here a block
// owns one column: it sums the rows its mask keeps (every row without a
// mask) in float64, then the squared deviations from that mean, and writes
// the scaled rows in place of the input's layout; rows outside the mask are
// copied unchanged.  With a mask, a column keeps its input when the mask
// holds 2 rows or fewer (`if v.sum() > 2`), so the caller reads nothing back.
//
// Bound: bytes, and at generation's sizes (T <= ~1100, D <= 50) latency:
// three passes over a column of T doubles, strided by D.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gv_scale_kernel(const double* __restrict__ x, int T, int D,
                const double* __restrict__ gv_mean, double weight,
                const unsigned char* __restrict__ mask,
                double* __restrict__ out) {
  __shared__ double red[32];
  const int d = blockIdx.x;
  double s = 0.0, n = 0.0;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    if (mask && !mask[t]) continue;
    s += x[(size_t)t * D + d];
    n += 1.0;
  }
  s = block_sum(s, red);
  n = block_sum(n, red);
  const double mu = s / n;
  double q = 0.0;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    if (mask && !mask[t]) continue;
    const double e = x[(size_t)t * D + d] - mu;
    q += e * e;
  }
  q = block_sum(q, red);
  const double var = q / n;
  // jnp.maximum: a NaN variance stays NaN
  const double ratio = pow(sqrt(gv_mean[d] / (var < 1e-12 ? 1e-12 : var)),
                           weight);
  const bool keep = mask && n <= 2.0;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const size_t i = (size_t)t * D + d;
    const bool in = !keep && (!mask || mask[t]);
    out[i] = in ? mu + ratio * (x[i] - mu) : x[i];
  }
}

}  // namespace

// mask: (T,) bytes (non-zero keeps the row) or null for every row.
extern "C" int gv_scale_launch(const double* x, int T, int D,
                               const double* gv_mean, double weight,
                               const unsigned char* mask, double* out,
                               cudaStream_t s) {
  if (T > 0 && D > 0)
    gv_scale_kernel<<<D, THREADS, 0, s>>>(x, T, D, gv_mean, weight, mask,
                                           out);
  return (int)cudaGetLastError();
}
