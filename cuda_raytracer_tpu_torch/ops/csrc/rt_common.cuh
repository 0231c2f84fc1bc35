// What every traversal kernel of the port shares: the NaN-propagating
// min/max of jnp.minimum / torch.minimum and the leaf test.  Sources
// that include this are built with -fmad=false and without fast math,
// so they round as the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>

#define T_NO_LIMIT 1e30f
#define PRIM_EPS 1e-6f

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/intersect.py packed_prim_test for one prim: g = plane normal |
// sphere center, g.w = plane offset | radius, T1/T2 the barycentric rows
__device__ __forceinline__ bool packed_prim_test(
    float o_x, float o_y, float o_z, float d_x, float d_y, float d_z,
    float4 g, float4 T1, float4 T2, float ptype, float* t_out) {
  float denom = g.x * d_x + g.y * d_y + g.z * d_z;
  bool parallel = fabsf(denom) < PRIM_EPS;
  float t_tri = (g.w - (g.x * o_x + g.y * o_y + g.z * o_z)) /
                (parallel ? 1.0f : denom);
  float hx = o_x + t_tri * d_x;
  float hy = o_y + t_tri * d_y;
  float hz = o_z + t_tri * d_z;
  float u = T1.x * hx + T1.y * hy + T1.z * hz + T1.w;
  float v = T2.x * hx + T2.y * hy + T2.z * hz + T2.w;
  bool ok_tri = (!parallel) && (u >= 0.0f) && (v >= 0.0f) &&
                (u + v <= 1.0f) && (t_tri >= 0.0f);
  float ocx = o_x - g.x, ocy = o_y - g.y, ocz = o_z - g.z;
  float a_q = d_x * d_x + d_y * d_y + d_z * d_z;
  float b_q = 2.0f * (ocx * d_x + ocy * d_y + ocz * d_z);
  float c_q = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
  float disc = b_q * b_q - 4.0f * a_q * c_q;
  float sq = sqrtf(nan_max(disc, 0.0f));
  float ts1 = (-b_q - sq) / (2.0f * a_q);
  float ts2 = (-b_q + sq) / (2.0f * a_q);
  float t_sph = ts1 > 0.0f ? ts1 : ts2;
  bool ok_sph = (disc >= 0.0f) && (t_sph > 0.0f);
  bool is_sph = ptype > 0.5f;
  bool not_pad = ptype > -0.5f;
  *t_out = is_sph ? t_sph : t_tri;
  return ((is_sph && ok_sph) || ((!is_sph) && ok_tri)) && not_pad;
}
