// Closest-hit / shadow traversal of the <=8-wide BVH: one thread per ray,
// depth-first with a per-thread node stack.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/packet_dfs.py
// (_dfs_kernel, launched by trace_closest_packets).  That kernel walks one
// DFS per packet of 1024 rays with union descent; this one walks one DFS
// per ray.  Both return the same thing: the closest hit (t, prim) and, for
// shadow rays, the same pass/fail decision.  The semantics kept from the
// TPU kernel, in order of a visit:
//   * pop a node; slab-test all W child boxes against the ray's current
//     bound tub: (tn <= tf) & (tf >= 0) & (tn <= tub), with NaN-propagating
//     min/max (a 0*inf slab is a miss, as in jnp.minimum/torch.minimum);
//   * push the hit inner children (slots 0..icnt-1, ids ibase+w) in
//     reverse slot order, so slot 0 pops first;
//   * intersect the hit leaf children (slots icnt..W-1) inline, in slot
//     order.  A leaf job folds its 8-prim groups: per group the min t over
//     the hit prims, the max orig_id among the slots at that min; strict <
//     against the job's best, then strict < against tub to update;
//   * shadow mode (do_kill): tub starts at min(t_limit, 1e30); after a leaf
//     job the ray stops once prim >= 0 and best_t < tub0 - kill_eps.
// Invalid lanes never traverse.  A ray cut off by MAX_VISITS or by an
// overflow of its stack (never written past) adds one to *dropped.
//
// The leaf test is packed_prim_test of ops/intersect.py line for line.
// Build with -fmad=false and without --use_fast_math: IEEE division and
// sqrt, no FMA contraction, so it rounds as the plain PyTorch version.
//
// Bound on the H100: per ray it reads o, d (24 B), valid (1 B) and, for
// shadow rays, t_limit (4 B), and writes t and prim (8 B); the node rows
// (32 B per child) and prim groups (512 B per group) are re-read per visit
// from L2/L1, where the tables of a bunny-class scene (a few MB) stay
// resident.  So the work is ALU and latency: a box test is 25 flops per
// child, a prim test 37-38 per prim, with divergent control flow between the
// threads of a warp.  The design keeps the tables in compact rows (one
// 32-byte sector per child, 64-byte prim records read as float4) and
// everything per ray in registers and local memory; warp-coherent packets
// in shared memory are later work.

#include <cuda_runtime.h>

#ifndef STACK_CAP
#define STACK_CAP 64
#endif

#define T_NO_LIMIT 1e30f
#define MAX_VISITS (1 << 20)
#define PRIM_EPS 1e-6f

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/intersect.py packed_prim_test for one prim record
// [g.xyz g.w | T1.xyzw | T2.xyzw | type id pad pad]
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

// o, d [n, 3]; valid [n]; t_limit [n] or null (closest-hit mode).  nodes
// [8*Nd, 8] as float4 pairs: (mnx mny mnz mxx) (mxy mxz grp0 ngroups).
// prims [8*G, 16] as float4 quads.  meta [4*Nd].  t [n] (inf on a miss),
// prim [n] (-1 on a miss), dropped: one counter.
__global__ void __launch_bounds__(128)
dfs_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const bool* __restrict__ valid, const float* __restrict__ t_limit,
           const float4* __restrict__ nodes,
           const float4* __restrict__ prims,
           const int* __restrict__ meta, float* __restrict__ t_out,
           int* __restrict__ prim_out,
           unsigned long long* __restrict__ dropped, int n, int width,
           float kill_eps) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float o_x = o[3 * i], o_y = o[3 * i + 1], o_z = o[3 * i + 2];
  const float d_x = d[3 * i], d_y = d[3 * i + 1], d_z = d[3 * i + 2];
  const bool do_kill = t_limit != nullptr;
  const float tub0 =
      !valid[i] ? -1.0f : (do_kill ? nan_min(t_limit[i], T_NO_LIMIT)
                                   : T_NO_LIMIT);
  const float inv_x = 1.0f / d_x, inv_y = 1.0f / d_y, inv_z = 1.0f / d_z;
  const float kill_lim = tub0 - kill_eps;

  float tub = tub0, best_t = T_NO_LIMIT, prim = -1.0f;
  int stack[STACK_CAP];
  int sp = 0, visits = 0;
  bool overflow = false;
  if (tub0 >= 0.0f) stack[sp++] = 0;

  while (sp > 0 && tub >= 0.0f && visits < MAX_VISITS) {
    const int node = stack[--sp];
    const int ibase = meta[4 * node], icnt = meta[4 * node + 1];
    const float4* row = nodes + 2 * (8 * node);
    unsigned mask = 0;
    for (int w = 0; w < width; ++w) {
      const float4 a = row[2 * w], b = row[2 * w + 1];
      const float t0x = (a.x - o_x) * inv_x, t1x = (a.w - o_x) * inv_x;
      const float t0y = (a.y - o_y) * inv_y, t1y = (b.x - o_y) * inv_y;
      const float t0z = (a.z - o_z) * inv_z, t1z = (b.y - o_z) * inv_z;
      const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
      const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      if ((tn <= tf) && (tf >= 0.0f) && (tn <= tub)) mask |= 1u << w;
    }
    // inner children, reverse slot order so slot 0 pops first
    for (int w = width - 1; w >= 0; --w) {
      if (w < icnt && ((mask >> w) & 1u)) {
        if (sp < STACK_CAP) {
          stack[sp++] = ibase + w;
        } else {
          overflow = true;
        }
      }
    }
    // leaf children, inline in slot order
    for (int w = icnt; w < width; ++w) {
      if (!((mask >> w) & 1u)) continue;
      const float4 b = row[2 * w + 1];
      const int grp0 = (int)b.z, ngroups = (int)b.w;
      float job_t = T_NO_LIMIT, job_p = -1.0f;
      for (int g = 0; g < ngroups; ++g) {
        const float4* rec = prims + 4 * 8 * (grp0 + g);
        float tbest = 0.0f, pbest = -1.0f;
        for (int s = 0; s < 8; ++s) {
          const float4 G = rec[4 * s], T1 = rec[4 * s + 1],
                       T2 = rec[4 * s + 2], TI = rec[4 * s + 3];
          float t;
          const bool ok =
              packed_prim_test(o_x, o_y, o_z, d_x, d_y, d_z, G, T1, T2,
                               TI.x, &t);
          const float tm = ok ? t : T_NO_LIMIT;
          if (s == 0 || tm < tbest) {
            tbest = tm;
            pbest = TI.y;
          } else if (tm == tbest) {
            pbest = fmaxf(pbest, TI.y);
          }
        }
        if (tbest < job_t) {
          job_t = tbest;
          job_p = pbest;
        }
      }
      if (job_t < tub) {
        prim = job_p;
        best_t = job_t;
        tub = job_t;
      }
      if (do_kill && prim >= 0.0f && best_t < kill_lim) {
        tub = -1.0f;
        break;
      }
    }
    ++visits;
  }

  t_out[i] = prim >= 0.0f ? best_t : __int_as_float(0x7f800000);
  prim_out[i] = (int)prim;
  if ((overflow || (sp > 0 && visits >= MAX_VISITS)) && tub >= 0.0f)
    atomicAdd(dropped, 1ull);
}

extern "C" int packet_dfs_trace(const void* o, const void* d,
                                const void* valid, const void* t_limit,
                                const void* nodes, const void* prims,
                                const void* meta, void* t_out,
                                void* prim_out, void* dropped, int n,
                                int width, float kill_eps, void* stream) {
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    dfs_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const bool*)valid,
        (const float*)t_limit, (const float4*)nodes, (const float4*)prims,
        (const int*)meta, (float*)t_out, (int*)prim_out,
        (unsigned long long*)dropped, n, width, kill_eps);
  }
  return (int)cudaGetLastError();
}
