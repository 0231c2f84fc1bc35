// jax.random.uniform's draw: threefry2x32, bit for bit, one pass.
//
// Replaces what XLA makes of jax.random.uniform(key, shape, float32) in
// the JAX engine's jitted frame (threefry2x32, partitionable counters),
// fused into one elementwise pass there: the hemisphere and Fresnel
// draws of scatter (cuda_raytracer_tpu/ops/shade.py:618, :680), draw_u2's
// shared and per-ray draws (render/bounce.py:54, :69) and the roulette
// draws (render/bounce.py:234, :361).  Raygen's draw (ops/shade.py:181
// and :213) is hashed inside the camera rays' kernel (raygen.cu) on the
// card; this kernel draws it for uniform's other callers.  Not a
// pl.pallas_call: the TPU runs XLA's own lowering.
//
// Element i of the flat shape is element i of jax.random.uniform's draw
// (threefry.cuh: the hash, the map to [0, 1) and the key, by value or
// through a KeyTable entry's two pointers).  The plain PyTorch version is
// uniform_plain in rng.py.
//
// The repeat form (draw_u2's shared draws, cfg.rng_granule g): an output
// of shape (rows * g, inner) whose row r, column c holds draw
// (r / g) * inner + c of the (rows, inner) draw, i.e.
// jnp.repeat(jax.random.uniform(key, (rows, inner)), g, axis=0).  A
// thread keeps the last draw it made and hashes again only when its next
// output reads another one, so a group of g rows costs about one hash per
// thread that writes into it, not one per output.
//
// Bound on the H100: integer operations.  75 u32 operations per draw
// (threefry.cuh counts them) against 4 bytes written is above the card's
// integer issue rate over its memory rate (33.4 T op/s / 3.35 TB/s,
// about 10 per byte), so a per-lane draw
// is compute bound; the design keeps every word in registers, writes each
// output once, coalesced, and in the repeat form (bytes bound) hashes
// once per source draw and thread rather than once per output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define RBLOCK 256
// consecutive outputs a thread writes per chunk, RBLOCK apart
#define RITEMS 16
#define RMAX_BLOCKS 2048

// REPEAT: the repeat form, its index arithmetic in 32 bits (the wrapper
// refuses a repeat form of 2^32 outputs or more)
template <bool REPEAT>
__global__ void __launch_bounds__(RBLOCK)
    rng_uniform_kernel(const long long* kp0, const long long* kp1,
                       uint32_t h0, uint32_t h1, float* __restrict__ out,
                       long long n_out, uint32_t inner, uint32_t repeat) {
  const Key k = load_key(kp0, kp1, h0, h1);
  const long long chunk = (long long)RBLOCK * RITEMS;
  for (long long base = blockIdx.x * chunk; base < n_out;
       base += (long long)gridDim.x * chunk) {
    long long last = -1;
    float u = 0.0f;
#pragma unroll 4
    for (int it = 0; it < RITEMS; ++it) {
      const long long j = base + it * RBLOCK + threadIdx.x;
      if (j >= n_out) break;
      if (REPEAT) {
        const uint32_t jj = (uint32_t)j;
        const uint32_t r = jj / inner;
        const long long i = (r / repeat) * inner + (jj - r * inner);
        if (i != last) {
          u = draw((unsigned long long)i, k);
          last = i;
        }
        out[j] = u;
      } else {
        out[j] = draw((unsigned long long)j, k);
      }
    }
  }
}

// out: n_out float32.  kp0, kp1: the key's two words as int64 on the
// device, or both null and h0, h1 the words.  repeat > 1: the repeat form
// over rows of `inner` draws (n_out a multiple of inner * repeat, below
// 2^32).  Launches nothing for n_out <= 0.
extern "C" int rng_uniform(const void* kp0, const void* kp1, unsigned h0,
                           unsigned h1, void* out, long long n_out,
                           long long inner, long long repeat, void* stream) {
  if (n_out <= 0) return (int)cudaGetLastError();
  const long long chunk = (long long)RBLOCK * RITEMS;
  long long blocks = (n_out + chunk - 1) / chunk;
  if (blocks > RMAX_BLOCKS) blocks = RMAX_BLOCKS;
  const long long* p0 = (const long long*)kp0;
  const long long* p1 = (const long long*)kp1;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (repeat <= 1) {
    rng_uniform_kernel<false>
        <<<(unsigned)blocks, RBLOCK, 0, s>>>(p0, p1, h0, h1, o, n_out, 1, 1);
  } else {
    rng_uniform_kernel<true><<<(unsigned)blocks, RBLOCK, 0, s>>>(
        p0, p1, h0, h1, o, n_out, (uint32_t)inner, (uint32_t)repeat);
  }
  return (int)cudaGetLastError();
}
