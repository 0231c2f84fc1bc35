// What every traversal kernel of the port shares: the NaN-propagating
// min/max of jnp.minimum / torch.minimum and the leaf test.  Sources
// that include this are built with -fmad=false and without fast math,
// so they round as the plain PyTorch versions do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define T_NO_LIMIT 1e30f

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The bf16 slab test (config slab_bf16; the TPU source's bf16 box test):
// one product (bound - o) * (1/d) with both factors rounded to bf16 and
// the product rounded to bf16.  The f32 product of two bf16 values is
// exact (8-bit significands), so one rounding gives the round-to-nearest
// bf16 product, as torch and XLA compute a bf16 multiply.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float slab_bf16(float bound, float o, float inv) {
  return bf16r(bf16r(bound - o) * bf16r(inv));
}
// ... then tnear and tfar (and the DFS's bound) widened in f32 by a few
// 2^-8 roundings of their magnitude and an absolute floor near 0, so the
// test only gains false positives: more visits, the same hits
#define SLAB_EPS 0.02f
#define SLAB_PAD 1e-3f
__device__ __forceinline__ float widen_down(float t) {
  return t - fabsf(t) * SLAB_EPS - SLAB_PAD;
}
__device__ __forceinline__ float widen_up(float t) {
  return t + fabsf(t) * SLAB_EPS + SLAB_PAD;
}

// The two halves of ops/intersect.py packed_prim_test, each in its own
// op order: a prim's result does not depend on which half is computed
// for it alone or on whether the other half is computed at all.
// Triangle: g = plane normal, g.w = plane offset, T1/T2 the barycentric
// rows, g_s = ops/intersect.prim_scale(g), stored per triangle by
// render/flatscene.py: parallel where |g.d| <= g_s, a cut on |cos| for
// unit d that does not depend on the triangle's size (a degenerate
// triangle, g = 0 and g_s = 0, is always parallel).
__device__ __forceinline__ bool tri_test(float o_x, float o_y, float o_z,
                                         float d_x, float d_y, float d_z,
                                         float4 g, float4 T1, float4 T2,
                                         float g_s, float* t_out) {
  float denom = g.x * d_x + g.y * d_y + g.z * d_z;
  bool parallel = fabsf(denom) <= g_s;
  float t_tri = (g.w - (g.x * o_x + g.y * o_y + g.z * o_z)) /
                (parallel ? 1.0f : denom);
  float hx = o_x + t_tri * d_x;
  float hy = o_y + t_tri * d_y;
  float hz = o_z + t_tri * d_z;
  float u = T1.x * hx + T1.y * hy + T1.z * hz + T1.w;
  float v = T2.x * hx + T2.y * hy + T2.z * hz + T2.w;
  *t_out = t_tri;
  return (!parallel) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t_tri >= 0.0f);
}

// Sphere: g = center, g.w = radius; a_q = d.d, computed by the caller as
// d_x * d_x + d_y * d_y + d_z * d_z (the same for every prim of a ray).
__device__ __forceinline__ bool sph_test(float o_x, float o_y, float o_z,
                                         float d_x, float d_y, float d_z,
                                         float a_q, float4 g, float* t_out) {
  float ocx = o_x - g.x, ocy = o_y - g.y, ocz = o_z - g.z;
  float b_q = 2.0f * (ocx * d_x + ocy * d_y + ocz * d_z);
  float c_q = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
  float disc = b_q * b_q - 4.0f * a_q * c_q;
  float sq = sqrtf(nan_max(disc, 0.0f));
  float ts1 = (-b_q - sq) / (2.0f * a_q);
  float ts2 = (-b_q + sq) / (2.0f * a_q);
  float t_sph = ts1 > 0.0f ? ts1 : ts2;
  *t_out = t_sph;
  return (disc >= 0.0f) && (t_sph > 0.0f);
}
