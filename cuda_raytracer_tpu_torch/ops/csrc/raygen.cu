// Camera rays: jittered pinhole or cutracer rays, their draws hashed in
// place, one pass.
//
// Not a pl.pallas_call.  Replaces XLA's fusion of the JAX engine's raygen
// program (cuda_raytracer_tpu/ops/shade.py:139-189 generate_camera_rays
// and :192-227 generate_camera_rays_cutracer, through _pix_from_slot
// :63-104), into which XLA fuses the program's jax.random.uniform(key,
// (n, 2)) draw (:181, :213).  The plain PyTorch versions are ops/shade.py's
// generate_camera_rays_plain and generate_camera_rays_cutracer_plain.
//
// One thread per lane i (fewer than 2^31 lanes, so every index is a u32):
//   * the pixel (px, py): slot i / spp (pixel-major), or i % (W * H)
//     under tiles32s (sample-major), mapped to its pixel in raster order,
//     through the tiles8 or tiles32s closed form (a partial last tile row,
//     height % 32, packed densely), or through an index table.  No
//     runtime division: each divisor of the order is a launch constant
//     with its magic pair (Div, made by the wrapper from the static shape
//     alone, so a captured graph replays them as it replays tan_h), and a
//     quotient is one high product and a shift; tile sizes are shifts
//     and masks.  px < W in every order the wrapper takes (tiles32s needs
//     W % 32 == 0, tiles8 W % 8 == 0), so px and py are the plain
//     version's pix % W and pix / W;
//   * the draw: elements 2i and 2i + 1 of jax.random.uniform(key, (n, 2)),
//     threefry.cuh's hash, bit for bit; the key by value or read on the
//     device (a KeyTable entry), so a captured graph draws the next
//     frame's key;
//   * the direction: the plain version's ops one rounding at a time
//     (built with -fmad=false, no fast math): (p + u) / W divided (torch
//     on the CPU divides; on the card it multiplies by the float32
//     reciprocal), the pinhole's (2x - 1) tan and (1 - 2y) tan, the c2w
//     products summed in order, or the cutracer's normalised (x - 0.5,
//     y - 0.5, 1) over (left, up, look_at); _norm's sum of squares in
//     order, its clamp at 1e-20 (NaN through), the sqrt and three
//     divisions.  The camera's c2w (or the cutracer's vectors) is read
//     through device pointers, so a captured graph sees a moved camera;
//     tan_half_h / tan_half_v are launch parameters (a new field of view
//     captures anew).
//   * d [N, 3] written once, three floats a thread (a block's d staged
//     in shared memory and written as 16-byte vectors took 6% longer on
//     the H100, 800x600 at 32 spp).  o is the camera position's stride-0
//     expand, which no kernel writes.
//
// Bound on the H100: integer operations.  Per lane two draws of 75 u32
// operations (150) against 12 bytes of d written, above the card's
// integer issue rate over its memory rate (about 10 per byte).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

#define GBLOCK 256

// sample orders (ops/shade.py _pix_from_slot)
#define ORDER_RASTER 0
#define ORDER_TILES8 1
#define ORDER_TILES32S 2
#define ORDER_TABLE 3

// a divisor d with its magic pair: n / d == __umulhi(2n, m) >> s for every
// 0 <= n < 2^31 (s = ceil(log2 d), m = ceil(2^(31 + s) / d); the wrapper's
// _div, checked against // in the tests)
struct Div {
  unsigned d, m, s;
};

struct RaygenArgs {
  long long n;  // lanes: width * height * spp, below 2^31
  // the key's words as int64 on the device, or both null: h0, h1
  const long long* kp0;
  const long long* kp1;
  // pinhole: cam0 = c2w [3, 3] row-major; cutracer: cam0, cam1, cam2 =
  // left, up, look_at [3]
  const float* cam0;
  const float* cam1;
  const float* cam2;
  const long long* table;  // ORDER_TABLE: slot -> pixel
  float* d;                // out [n, 3]
  unsigned h0, h1;
  int width, height, spp;
  int full_height, row_offset;  // the pinhole's slab of a taller sensor
  int order, cutracer;
  float tan_h, tan_v;
  // the order's divisors: lane -> slot by spp (W * H under tiles32s);
  // slot -> pixel by W (raster, table), W / 8 tiles (tiles8) or the
  // W / 32 * 1024 slots of a full tile row (tiles32s); the partial tile
  // row's 32 * (H % 32) slots a tile (tiles32s, else 0)
  Div lane_div, pix_div, part_div;
  // tiles32s: the slots of the full tile rows, and the partial row's
  // first pixel row
  unsigned q_full_end, part_y0;
};

__device__ __forceinline__ unsigned quot(unsigned n, const Div& v) {
  return __umulhi(n + n, v.m) >> v.s;
}

// lane i's pixel, column and row
__device__ __forceinline__ void pixel_of(unsigned i, const RaygenArgs& a,
                                         unsigned& px, unsigned& py) {
  if (a.order == ORDER_TILES32S) {
    const unsigned slot = i - quot(i, a.lane_div) * a.lane_div.d;
    if (slot < a.q_full_end) {
      const unsigned tr = quot(slot, a.pix_div);
      const unsigned w = slot - tr * a.pix_div.d;  // tile w >> 10, cell
      py = tr * 32u + ((w & 1023u) >> 5);
      px = (w >> 10) * 32u + (w & 31u);
    } else {
      const unsigned q2 = slot - a.q_full_end;
      const unsigned tx = quot(q2, a.part_div);
      const unsigned v = q2 - tx * a.part_div.d;
      py = a.part_y0 + (v >> 5);
      px = tx * 32u + (v & 31u);
    }
    return;
  }
  const unsigned slot = quot(i, a.lane_div);
  if (a.order == ORDER_TILES8) {
    const unsigned tile = slot >> 6, within = slot & 63u;
    const unsigned ty = quot(tile, a.pix_div);
    py = ty * 8u + (within >> 3);
    px = (tile - ty * a.pix_div.d) * 8u + (within & 7u);
    return;
  }
  const unsigned pix =
      a.order == ORDER_TABLE ? (unsigned)a.table[slot] : slot;
  py = quot(pix, a.pix_div);
  px = pix - py * a.pix_div.d;
}

// torch.clamp_min(s, 1e-20): NaN stays NaN
__device__ __forceinline__ float clamp_eps(float s) {
  return s < 1e-20f ? 1e-20f : s;
}

// lane i's direction into out[0..2]
__device__ __forceinline__ void ray_of(unsigned i, const RaygenArgs& a,
                                       float* out) {
  unsigned ipx, ipy;
  pixel_of(i, a, ipx, ipy);
  const float px = (float)ipx, py = (float)ipy;
  const Key k = load_key(a.kp0, a.kp1, a.h0, a.h1);
  // 2i + 1 < 2^32: the counters' high words are 0
  const float u0 = draw((unsigned long long)(2u * i), k);
  const float u1 = draw((unsigned long long)(2u * i + 1u), k);
  const float x = (px + u0) / (float)a.width;
  float dx, dy, dz;
  if (a.cutracer) {
    const float y = (py + u1) / (float)a.height;
    const float kx = x - 0.5f, ky = y - 0.5f;
    const float s = sqrtf(clamp_eps(kx * kx + ky * ky + 1.0f * 1.0f));
    const float k0 = kx / s, k1 = ky / s, k2 = 1.0f / s;
    const float* l = a.cam0;
    const float* u = a.cam1;
    const float* f = a.cam2;
    dx = k0 * l[0] + k1 * u[0] + k2 * f[0];
    dy = k0 * l[1] + k1 * u[1] + k2 * f[1];
    dz = k0 * l[2] + k1 * u[2] + k2 * f[2];
  } else {
    const float y = ((py + (float)a.row_offset) + u1) / (float)a.full_height;
    const float sx = (2.0f * x - 1.0f) * a.tan_h;
    const float sy = (1.0f - 2.0f * y) * a.tan_v;
    const float* c = a.cam0;
    const float vx = sx * c[0] + sy * c[1] - c[2];
    const float vy = sx * c[3] + sy * c[4] - c[5];
    const float vz = sx * c[6] + sy * c[7] - c[8];
    const float s = sqrtf(clamp_eps(vx * vx + vy * vy + vz * vz));
    dx = vx / s;
    dy = vy / s;
    dz = vz / s;
  }
  out[0] = dx;
  out[1] = dy;
  out[2] = dz;
}

__global__ void __launch_bounds__(GBLOCK) raygen_kernel(const RaygenArgs a) {
  const unsigned i = blockIdx.x * GBLOCK + threadIdx.x;
  if (i < (unsigned)a.n) ray_of(i, a, a.d + 3ull * i);
}

// ---------------------------------------------------------------------------
// C interface: one launch on the caller's stream; nothing for n <= 0
// ---------------------------------------------------------------------------

extern "C" int raygen(const RaygenArgs* a, void* stream) {
  if (a->n > 0)
    raygen_kernel<<<(unsigned)((a->n + GBLOCK - 1) / GBLOCK), GBLOCK, 0,
                    (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// sizeof the argument block, for the wrapper's layout check
extern "C" long long raygen_args_size(void) {
  return (long long)sizeof(RaygenArgs);
}
