// The film: reconstruct + accumulate, and the 3x3 median.
//
// Not a pl.pallas_call.  film_kernel replaces XLA's fusion of the JAX
// engine's film program (cuda_raytracer_tpu/render/engine.py:177-187):
// ops/filters.py:13-31 reconstruct (the per-pixel mean of its spp
// samples, pixel-major or sample-major, through inv_order) and :34-39
// accumulate (the running average).  median3x3_kernel replaces its
// :42-65 median_filter_3x3 (engine.py:191).  The plain PyTorch versions
// are ops/filters.py's reconstruct_plain, accumulate_plain and
// median_filter_3x3_plain.
//
// film_kernel, one thread per pixel p (all three channels): the slot s =
// inv_order[p] (or p); the sum of the slot's spp samples in sample order
// (pixel-major [P, spp, 3] or sample-major [spp, P, 3]) from 0, then
// divided by spp, as the plain mean on the CPU does (on the card torch
// reduces in a tree and multiplies by the reciprocal; the two agree
// within rtol 1e-5); then, where it accumulates, (final * old + mean *
// new) times the float32 reciprocal of old + new, as filters.accumulate
// rounds on the card.  old is read on the device (the captured frame's
// sample count, which the engine rewrites before each replay) or passed
// by value.  The sharded renderer's per-shard reconstruct is the kernel
// without the accumulate, its accumulate the kernel over one sample per
// pixel (a mean of one is the sample itself, exactly).
//
// median3x3_kernel, one thread per pixel: per channel the 9 neighbours
// (dy, dx in row order; clamped at the edges, or white outside under
// reference_compat), each as a 64-bit key (the float's order, with -0 ==
// +0 and every NaN equal and last, as torch.sort and jnp.sort compare,
// then the neighbour's index), sorted by a 25-comparator network; the
// unique keys make it the stable sort, so the value at ascending index 4
// (5 under compat) is the plain sort's element, bit for bit, ties of
// +-0 and NaN included.
//
// Bound on the H100: bytes.  film: each sample read once (12 B a sample),
// inv_order (8 B a pixel), the old image where it accumulates and the
// new one written (12 B a pixel each); median: the image read once and
// written once.

#include <cuda_runtime.h>
#include <stdint.h>

#define FBLOCK 256

struct FilmArgs {
  long long n_pix;  // H * W
  long long spp;
  const float* samples;        // [P * spp, 3]
  const long long* inv_order;  // [P] pixel -> slot, or null
  const float* final_in;       // [P, 3], where it accumulates
  const float* old_ptr;        // 0-d old weight on the device, or null
  float* out;                  // [P, 3]
  int sample_major, accumulate;
  float old_weight, new_weight;
};

__global__ void __launch_bounds__(FBLOCK) film_kernel(const FilmArgs a) {
  const long long p = (long long)blockIdx.x * FBLOCK + threadIdx.x;
  if (p >= a.n_pix) return;
  const long long slot = a.inv_order ? a.inv_order[p] : p;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (long long s = 0; s < a.spp; ++s) {
    const long long row = a.sample_major ? s * a.n_pix + slot
                                         : slot * a.spp + s;
    const float* q = a.samples + 3 * row;
    s0 = s0 + q[0];
    s1 = s1 + q[1];
    s2 = s2 + q[2];
  }
  const float n = (float)a.spp;
  float m0 = s0 / n, m1 = s1 / n, m2 = s2 / n;
  if (a.accumulate) {
    const float old = a.old_ptr ? *a.old_ptr : a.old_weight;
    const float nw = a.new_weight;
    const float r = 1.0f / (old + nw);
    const float* f = a.final_in + 3 * p;
    m0 = (f[0] * old + m0 * nw) * r;
    m1 = (f[1] * old + m1 * nw) * r;
    m2 = (f[2] * old + m2 * nw) * r;
  }
  float* o = a.out + 3 * p;
  o[0] = m0;
  o[1] = m1;
  o[2] = m2;
}

// the sort key of a neighbour: its float's order in the high word (-0 as
// +0, every NaN above +inf), its index below, so no two keys tie
__device__ __forceinline__ unsigned long long median_key(float v, int idx) {
  uint32_t b = __float_as_uint(v);
  if (v == 0.0f) b = 0u;
  uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (v != v) ord = 0xFFFFFFFFu;
  return ((unsigned long long)ord << 4) | (unsigned long long)idx;
}

#define CE(i, j)                                             \
  {                                                          \
    const unsigned long long lo = k[i] < k[j] ? k[i] : k[j]; \
    k[j] = k[i] < k[j] ? k[j] : k[i];                        \
    k[i] = lo;                                               \
  }

// the element at ascending index K of the 9 values: the values' keys
// sorted (25 comparators; what does not reach index K is left out by the
// compiler), then the value whose index the K-th key holds
template <int K>
__device__ __forceinline__ float select9(const float* v) {
  unsigned long long k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = median_key(v[i], i);
  CE(0, 3) CE(1, 7) CE(2, 5) CE(4, 8)
  CE(0, 7) CE(2, 4) CE(3, 8) CE(5, 6)
  CE(0, 2) CE(1, 3) CE(4, 5) CE(7, 8)
  CE(1, 4) CE(3, 6) CE(5, 7)
  CE(0, 1) CE(2, 4) CE(3, 5) CE(6, 8)
  CE(2, 3) CE(4, 5) CE(6, 7)
  CE(1, 2) CE(3, 4) CE(5, 6)
  const int idx = (int)(k[K] & 15ull);
  float r = v[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) r = idx == i ? v[i] : r;
  return r;
}

struct MedianArgs {
  const float* img;  // [H, W, 3]
  float* out;        // [H, W, 3]
  int h, w, compat;
};

// COMPAT: white outside the image and index 5; else edge clamp, index 4
template <bool COMPAT>
__global__ void __launch_bounds__(FBLOCK)
    median3x3_kernel(const MedianArgs a) {
  const int h = a.h, w = a.w;
  const float* __restrict__ img = a.img;
  const long long p = (long long)blockIdx.x * FBLOCK + threadIdx.x;
  if (p >= (long long)h * w) return;
  const int y = (int)(p / w), x = (int)(p % w);
  float v[3][9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int yy = y + dy - 1, xx = x + dx - 1;
      const bool outside = yy < 0 || yy >= h || xx < 0 || xx >= w;
      yy = yy < 0 ? 0 : (yy >= h ? h - 1 : yy);
      xx = xx < 0 ? 0 : (xx >= w ? w - 1 : xx);
      const float* q = img + 3 * ((long long)yy * w + xx);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c][dy * 3 + dx] = COMPAT && outside ? 1.0f : q[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.out[3 * p + c] = select9<COMPAT ? 5 : 4>(v[c]);
}

// ---------------------------------------------------------------------------
// C interface: one launch each on the caller's stream; nothing for no
// pixels
// ---------------------------------------------------------------------------

static unsigned blocks_for(long long n) {
  return (unsigned)((n + FBLOCK - 1) / FBLOCK);
}

extern "C" int film(const FilmArgs* a, void* stream) {
  if (a->n_pix > 0)
    film_kernel<<<blocks_for(a->n_pix), FBLOCK, 0, (cudaStream_t)stream>>>(
        *a);
  return (int)cudaGetLastError();
}

extern "C" int median3x3(const MedianArgs* a, void* stream) {
  const long long n = (long long)a->h * a->w;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (a->compat)
      median3x3_kernel<true><<<blocks_for(n), FBLOCK, 0, s>>>(*a);
    else
      median3x3_kernel<false><<<blocks_for(n), FBLOCK, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

// sizeof each argument block, for the wrapper's layout check
extern "C" long long film_args_size(int which) {
  return which == 0 ? (long long)sizeof(FilmArgs)
                    : (long long)sizeof(MedianArgs);
}
