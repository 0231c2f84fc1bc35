// jax.random.uniform's draw, one element: threefry2x32, bit for bit.
//
// Shared by the uniform kernel (rng.cu) and the camera rays' kernel
// (raygen.cu), which hashes its own draws.  Element i of a draw is the
// u32 word b0 ^ b1 of threefry2x32(key, (i >> 32, i & 0xffffffff)); its
// top 23 bits are the mantissa of a float in [1, 2), and the draw is that
// float minus 1 (exact).  The plain PyTorch version, uniform_plain in
// rng.py, does the same in int64 tensor ops masked to 32 bits.
//
// The key: two u32 words by value (the caller's host ints), or read from
// device memory through two pointers (a KeyTable entry: 0-d int64 views
// into one [K, 2] buffer, the low word of each int64 is the key word).  A
// captured CUDA graph replays a launch with the same pointers, so it
// draws from whatever key the table holds at the replay; a key passed by
// value would freeze the capturing frame's noise into the graph.
//
// 75 u32 operations a draw: two counter adds, 20 rounds of (add, rotate
// as one funnel shift, xor), five key injections of two adds each, and
// xor, shift and or of the map (the final float subtraction runs on the
// FP32 pipe).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// the key from two device pointers to int64 words, or (both null) from
// the words h0, h1
__device__ __forceinline__ Key load_key(const long long* kp0,
                                        const long long* kp1, uint32_t h0,
                                        uint32_t h1) {
  Key k;
  k.k0 = kp0 ? (uint32_t)*kp0 : h0;
  k.k1 = kp1 ? (uint32_t)*kp1 : h1;
  k.k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  return k;
}

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
