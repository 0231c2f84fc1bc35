// jax.random.uniform's draw: threefry2x32, bit for bit, one pass.
//
// Replaces what XLA makes of jax.random.uniform(key, shape, float32) in
// the JAX engine's jitted frame (threefry2x32, partitionable counters),
// fused into one elementwise pass there: raygen
// (cuda_raytracer_tpu/ops/shade.py:181 and :213, the cutracer camera),
// the hemisphere and Fresnel draws of scatter (ops/shade.py:618, :680),
// draw_u2's shared and per-ray draws (render/bounce.py:54, :69) and the
// roulette draws (render/bounce.py:234, :361).  Not a pl.pallas_call: the
// TPU runs XLA's own lowering.
//
// Element i of the flat shape is the u32 word b0 ^ b1 of
// threefry2x32(key, (i >> 32, i & 0xffffffff)); its top 23 bits are the
// mantissa of a float in [1, 2), and the draw is that float minus 1
// (exact).  The plain PyTorch version, uniform_plain in rng.py, does the
// same in int64 tensor ops masked to 32 bits.
//
// The key: two u32 words by value (the caller's host ints), or read from
// device memory through two pointers (a KeyTable entry: 0-d int64 views
// into one [K, 2] buffer, the low word of each int64 is the key word).  A
// captured CUDA graph replays the launch with the same pointers, so it
// draws from whatever key the table holds at the replay; a key passed by
// value would freeze the capturing frame's noise into the graph.
//
// The repeat form (draw_u2's shared draws, cfg.rng_granule g): an output
// of shape (rows * g, inner) whose row r, column c holds draw
// (r / g) * inner + c of the (rows, inner) draw, i.e.
// jnp.repeat(jax.random.uniform(key, (rows, inner)), g, axis=0).  A
// thread keeps the last draw it made and hashes again only when its next
// output reads another one, so a group of g rows costs about one hash per
// thread that writes into it, not one per output.
//
// Bound on the H100: integer operations.  Per draw 75 u32 operations: two
// counter adds, 20 rounds of (add, rotate as one funnel shift, xor), five
// key injections of two adds each, and xor, shift and or of the map (the
// final float subtraction runs on the FP32 pipe).  75 operations against
// 4 bytes written is above the card's integer issue rate over its memory
// rate (33.4 T op/s / 3.35 TB/s, about 10 per byte), so a per-lane draw
// is compute bound; the design keeps every word in registers, writes each
// output once, coalesced, and in the repeat form (bytes bound) hashes
// once per source draw and thread rather than once per output.

#include <cuda_runtime.h>
#include <stdint.h>

#define RBLOCK 256
// consecutive outputs a thread writes per chunk, RBLOCK apart
#define RITEMS 16
#define RMAX_BLOCKS 2048

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ROUND(r) \
  x0 += x1;      \
  x1 = rotl(x1, r) ^ x0;
#define ROT0 ROUND(13) ROUND(15) ROUND(26) ROUND(6)
#define ROT1 ROUND(17) ROUND(29) ROUND(16) ROUND(24)

struct Key {
  uint32_t k0, k1, k2;
};

// threefry2x32 of counter i under the key, mapped to [0, 1)
__device__ __forceinline__ float draw(unsigned long long i, const Key& k) {
  uint32_t x0 = (uint32_t)(i >> 32) + k.k0;
  uint32_t x1 = (uint32_t)i + k.k1;
  // after group g: x0 += ks[(g + 1) % 3], x1 += ks[(g + 2) % 3] + g + 1,
  // ks = (k0, k1, k2); the +g+1 folds into a word of the key per thread
  ROT0 x0 += k.k1; x1 += k.k2 + 1u;
  ROT1 x0 += k.k2; x1 += k.k0 + 2u;
  ROT0 x0 += k.k0; x1 += k.k1 + 3u;
  ROT1 x0 += k.k1; x1 += k.k2 + 4u;
  ROT0 x0 += k.k2; x1 += k.k0 + 5u;
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// REPEAT: the repeat form, its index arithmetic in 32 bits (the wrapper
// refuses a repeat form of 2^32 outputs or more)
template <bool REPEAT>
__global__ void __launch_bounds__(RBLOCK)
    rng_uniform_kernel(const long long* kp0, const long long* kp1,
                       uint32_t h0, uint32_t h1, float* __restrict__ out,
                       long long n_out, uint32_t inner, uint32_t repeat) {
  Key k;
  k.k0 = kp0 ? (uint32_t)*kp0 : h0;
  k.k1 = kp1 ? (uint32_t)*kp1 : h1;
  k.k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
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
