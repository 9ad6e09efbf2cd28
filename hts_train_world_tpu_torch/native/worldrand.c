/* Exact reimplementation of the WORLD reference PRNG stream.
 *
 * The reference (externs/WORLD_v2/src/matlabfunctions.cpp:247-277 in
 * turbocast/HTS-train-WORLD) draws approximately-Gaussian values from a
 * xorshift128 generator: each randn() performs 12 xorshift steps, sums
 * (w >> 4) over those steps, and returns sum / 2^28 - 6.  randn_reseed()
 * resets the state to fixed constants; the reference calls it at the top of
 * CheapTrick, D4C and Synthesis, making every stochastic stage
 * bit-reproducible.
 *
 * The recurrence is strictly serial, so the stream is generated natively
 * and handed to the kernels as an input array (in the exact order the C++
 * loops consume it).  The port's own copy of native/worldrand.c (built by runtime/native.py).
 *
 * Build: gcc -O2 -shared -fPIC -o libworldrand.so worldrand.c
 */
#include <stdint.h>

typedef struct {
  uint32_t x, y, z, w;
} wr_state;

static inline uint32_t wr_step(wr_state *s) {
  uint32_t t = s->x ^ (s->x << 11);
  s->x = s->y;
  s->y = s->z;
  s->z = s->w;
  s->w = (s->w ^ (s->w >> 19)) ^ (t ^ (t >> 8));
  return s->w;
}

/* Fill out[0..n-1] with the first n randn() draws after a fresh reseed. */
void worldrand_fill(double *out, long n) {
  wr_state s = {123456789u, 362436069u, 521288629u, 88675123u};
  for (long i = 0; i < n; ++i) {
    uint32_t tmp = wr_step(&s) >> 4;
    for (int k = 0; k < 11; ++k) tmp += wr_step(&s) >> 4;
    out[i] = tmp / 268435456.0 - 6.0;
  }
}

/* Continue a stream: state in/out explicitly (for chunked generation). */
void worldrand_fill_from(double *out, long n, uint32_t *state4) {
  wr_state s = {state4[0], state4[1], state4[2], state4[3]};
  for (long i = 0; i < n; ++i) {
    uint32_t tmp = wr_step(&s) >> 4;
    for (int k = 0; k < 11; ++k) tmp += wr_step(&s) >> 4;
    out[i] = tmp / 268435456.0 - 6.0;
  }
  state4[0] = s.x; state4[1] = s.y; state4[2] = s.z; state4[3] = s.w;
}
