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
// median3x3_kernel, a block of 32 x 8 threads, one pixel each: the
// block's tile and its one-pixel halo loaded once into shared memory
// (each row a coalesced run of the image; the edge clamp, or the white
// pad under reference_compat, applied at the load), each value beside
// its 32-bit key (the float's order, with -0 == +0 and every NaN equal
// and last, as torch.sort and jnp.sort compare).  Per channel the 9
// neighbours' keys (dy, dx in row order) go through a min/max network:
// the median-of-9 network for index 4, the sorting network pruned to
// index 5 under compat.  The stable sort's pick follows from the key m
// so selected and the neighbours' indices: of the neighbours whose key
// is m, the (K - c)-th in index order, c being those below m.  Its value
// is read back from the tile, so the result is the plain sort's element
// bit for bit, ties of +-0 and NaN payloads included.
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

// the float's order as an unsigned key: -0 as +0, every NaN above +inf, so
// that unsigned order is the order torch.sort and jnp.sort compare by
__device__ __forceinline__ uint32_t float_order(float v) {
  uint32_t b = __float_as_uint(v);
  if (v == 0.0f) b = 0u;
  uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (v != v) ord = 0xFFFFFFFFu;
  return ord;
}

// compare-exchange of two keys: k[i] the smaller, k[j] the larger
#define CE(i, j)                         \
  {                                      \
    const uint32_t lo = min(k[i], k[j]); \
    k[j] = max(k[i], k[j]);              \
    k[i] = lo;                           \
  }

// the key at ascending index K of 9 keys (k is overwritten): for K = 4 the
// 19-comparator median-of-9 network (Paeth's), else a 25-comparator
// sorting network; what does not reach index K is left out by the
// compiler
template <int K>
__device__ __forceinline__ uint32_t select9(uint32_t* k) {
  if (K == 4) {
    CE(1, 2) CE(4, 5) CE(7, 8) CE(0, 1) CE(3, 4) CE(6, 7)
    CE(1, 2) CE(4, 5) CE(7, 8) CE(0, 3) CE(5, 8) CE(4, 7)
    CE(3, 6) CE(1, 4) CE(2, 5) CE(4, 7) CE(4, 2) CE(6, 4)
    CE(4, 2)
    return k[4];
  }
  CE(0, 3) CE(1, 7) CE(2, 5) CE(4, 8)
  CE(0, 7) CE(2, 4) CE(3, 8) CE(5, 6)
  CE(0, 2) CE(1, 3) CE(4, 5) CE(7, 8)
  CE(1, 4) CE(3, 6) CE(5, 7)
  CE(0, 1) CE(2, 4) CE(3, 5) CE(6, 8)
  CE(2, 3) CE(4, 5) CE(6, 7)
  CE(1, 2) CE(3, 4) CE(5, 6)
  return k[K];
}

// The stable sort's element at index K of 9 keys, as the neighbour's
// number: m = the K-th smallest key; c = the neighbours below m; of the
// neighbours equal to m, the (K - c)-th in index order.  Equal keys keep
// their index order in a stable sort, so this is the neighbour whose
// value torch.sort and jnp.sort put at index K, bit for bit (+-0 and NaN
// payloads included).
template <int K>
__device__ __forceinline__ int stable_pick9(const uint32_t* key) {
  uint32_t k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = key[i];
  const uint32_t m = select9<K>(k);
  int j = K;
#pragma unroll
  for (int i = 0; i < 9; ++i) j -= key[i] < m ? 1 : 0;
  int pick = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const bool eq = key[i] == m;
    pick = eq && j == 0 ? i : pick;
    j -= eq ? 1 : 0;
  }
  return pick;
}

struct MedianArgs {
  const float* img;  // [H, W, 3]
  float* out;        // [H, W, 3]
  int h, w, compat;
};

// a block: MW x MH threads, one pixel each; its tile with a one-pixel
// halo, (MH + 2) rows of MP pixels of 3 channels, values and keys (two
// pixels a thread, MH rows apart, took 3% longer on the H100 at 800x600)
#define MW 32
#define MH 8
#define MP (MW + 2)
#define MTILE ((MH + 2) * MP * 3)

struct MedianTile {
  float v[MTILE];
  uint32_t key[MTILE];
};

// The kernel's two phases around its barrier (the host build of the tests
// runs them as two loops over a block's threads).  Phase 1: the block's
// tile and halo, each row a run of (MW + 2) * 3 floats of the image (a
// warp's loads coalesce), edge-clamped, or white outside under COMPAT.
#define MLOADS ((MTILE + MW * MH - 1) / (MW * MH))  // loads a thread

template <bool COMPAT>
__device__ __forceinline__ void median_load(const MedianArgs& a,
                                            MedianTile& t) {
  const int x0 = (int)blockIdx.x * MW - 1, y0 = (int)blockIdx.y * MH - 1;
  const int first = threadIdx.y * MW + threadIdx.x;
  float v[MLOADS];
  // every load issued before the first is used
#pragma unroll
  for (int k = 0; k < MLOADS; ++k) {
    const int e = first + k * MW * MH;
    const int row = e / (MP * 3), col = e - row * (MP * 3);
    const int cx = col / 3, c = col - cx * 3;
    int y = y0 + row, x = x0 + cx;
    const bool outside = y < 0 || y >= a.h || x < 0 || x >= a.w;
    y = y < 0 ? 0 : (y >= a.h ? a.h - 1 : y);
    x = x < 0 ? 0 : (x >= a.w ? a.w - 1 : x);
    v[k] = (COMPAT && outside) || e >= MTILE
               ? 1.0f
               : a.img[3 * ((long long)y * a.w + x) + c];
  }
#pragma unroll
  for (int k = 0; k < MLOADS; ++k) {
    const int e = first + k * MW * MH;
    if (e < MTILE) {
      t.v[e] = v[k];
      t.key[e] = float_order(v[k]);
    }
  }
}

// Phase 2: the thread's pixel, per channel the neighbour (dy, dx in row
// order) at ascending index 4 (5 under COMPAT)
template <bool COMPAT>
__device__ __forceinline__ void median_pixel(const MedianArgs& a,
                                             const MedianTile& t) {
  const int x = (int)blockIdx.x * MW + threadIdx.x;
  const int y = (int)blockIdx.y * MH + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const int at = 3 * (threadIdx.y * MP + threadIdx.x);
  float* out = a.out + 3 * ((long long)y * a.w + x);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint32_t key[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      key[i] = t.key[at + 3 * ((i / 3) * MP + i % 3) + c];
    const int i = stable_pick9<COMPAT ? 5 : 4>(key);
    out[c] = t.v[at + 3 * ((i / 3) * MP + i % 3) + c];
  }
}

template <bool COMPAT>
__global__ void __launch_bounds__(MW * MH)
    median3x3_kernel(const MedianArgs a) {
  __shared__ MedianTile t;
  median_load<COMPAT>(a, t);
  __syncthreads();
  median_pixel<COMPAT>(a, t);
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
  if ((long long)a->h * a->w > 0) {
    const dim3 grid((a->w + MW - 1) / MW, (a->h + MH - 1) / MH);
    const dim3 block(MW, MH);
    cudaStream_t s = (cudaStream_t)stream;
    if (a->compat)
      median3x3_kernel<true><<<grid, block, 0, s>>>(*a);
    else
      median3x3_kernel<false><<<grid, block, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

// sizeof each argument block, for the wrapper's layout check
extern "C" long long film_args_size(int which) {
  return which == 0 ? (long long)sizeof(FilmArgs)
                    : (long long)sizeof(MedianArgs);
}
