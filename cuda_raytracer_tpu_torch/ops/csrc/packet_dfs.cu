// Closest-hit / shadow traversal of the <=8-wide BVH: one thread per ray,
// depth-first with a per-thread node stack.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/packet_dfs.py
// (_dfs_kernel, launched by trace_closest_packets).  That kernel walks one
// DFS per packet of 1024 rays with union descent; this one walks one DFS
// per ray, children in the same slot order.  Both return the same closest
// hit (and, for shadow rays, the same pass/fail decision).  The
// semantics, in order of a visit:
//   * pop a node; slab-test all W child boxes against the ray's bound
//     tub: (tn <= tf) & (tf >= 0) & (tn <= tub), with NaN-propagating
//     min/max (a 0*inf slab is a miss, as in jnp.minimum/torch.minimum);
//   * push the hit inner children (slots 0..icnt-1, ids ibase+w) in
//     reverse slot order, so slot 0 pops first;
//   * intersect the hit leaf children (slots icnt..W-1) inline, in slot
//     order.  A leaf job folds its 8-prim groups: per group the min t over
//     the hit prims, the max orig_id among the hits at that min; strict <
//     against the job's best, then strict < against tub to update;
//   * tub starts at min(t_start, 1e30), or 1e30 without t_start (the
//     wrapper passes a shadow ray's t_limit, or the bound seeded from
//     ops/seeds.py, which the TPU kernel reads from its payload row 7);
//   * shadow mode (do_kill): after a leaf job the ray stops once prim >= 0
//     and best_t < tub0 - kill_eps, tub0 being that start bound;
//   * slab_bf16 (the TPU kernel's bf16 slab test, a separate
//     instantiation): the per-axis differences in f32, rounded to bf16,
//     times 1/d rounded to bf16, each product rounded to bf16; min/max of
//     those; then tn, tf and tub widened in f32 by 2% of their magnitude
//     and 1e-3, so the test only gains false positives (more visits, the
//     same hits); the compares in f32.
// Invalid lanes never traverse.  A ray cut off by MAX_VISITS or by an
// overflow of its stack (never written past) adds one to *dropped.
//
// Bound on the H100: per ray it reads o, d (24 B), valid (1 B) and, with
// one, the start bound (4 B), and writes t and prim (8 B); the node rows
// (32 B per child) and prim records (64 B per prim) are re-read per visit
// from L1/L2, where the tables of these scenes stay resident.  So the work
// is ALU and latency: a box test is 25 flops per child, a prim test 38
// (triangle) or 37 (sphere), with divergent control flow between the
// threads of a warp.  What the design does about it:
//   * the leaf loop tests each prim by its own type only and skips pad
//     slots (the shared packed_prim_test computes both halves, three IEEE
//     divisions and a square root per slot); tri_test and sph_test keep
//     its op order, so every result rounds as before;
//   * each thread loops over node visits until one hits a leaf child, then
//     runs that node's leaf jobs ("while-while", Aila & Laine,
//     "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009):
//     the threads of a warp that wait do so in the cheap loop, and the
//     leaf jobs, the costly part, run with the warp's lanes together.  A
//     thread's own order of visits and leaf jobs is the one above;
//   * the stack is a per-thread array of STACK_CAP entries, of which the
//     caller uses what the tree can need ((W - 1) * D + 1 for depth D);
//   * trees of width <= 4 and <= 8, and the f32 and bf16 box tests, are
//     separate instantiations, so the per-child loops unroll to the width
//     and the f32 test carries no bf16 code.  The bf16 test rounds as the
//     TPU's does: f32 products rounded to bf16, plus the widening, so it
//     does more arithmetic per box than the f32 test and may visit more
//     nodes; it returns the same hits.
// Built with -fmad=false and without --use_fast_math: IEEE division and
// sqrt, no FMA contraction, so it rounds as the plain PyTorch version.

#include "rt_common.cuh"

#ifndef STACK_CAP
#define STACK_CAP 64
#endif

#define MAX_VISITS (1 << 20)
#define DFS_BLOCK 128

// the BVH as the kernel reads it: nodes [8*Nd, 8] as float4 pairs (mnx mny
// mnz mxx)(mxy mxz grp0 ngroups); prims [8*G, 16] as float4 quads (g.xyz
// g.w)(T1)(T2)(type orig_id pad pad); meta [4*Nd] (ibase icnt . .)
struct Tables {
  const float4* __restrict__ nodes;
  const float4* __restrict__ prims;
  const int* __restrict__ meta;
  int width;
};

template <int WMAX, bool BF16>
struct DfsRay {
  float o_x, o_y, o_z, d_x, d_y, d_z, inv_x, inv_y, inv_z, a_q, kill_lim;
  float tub, best_t, prim;
  int sp, visits, cap;
  bool kill, overflow;
  int* stack;  // the kernel's local array: a member array would put the
               // whole struct in local memory
  // the last visited node's child rows, and its hit leaf children whose
  // jobs are still to run
  const float4* row;
  unsigned lmask;

  __device__ __forceinline__ void start(int i, const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const bool* __restrict__ valid,
                                        const float* __restrict__ t_start,
                                        bool do_kill, float kill_eps,
                                        int* stack_mem, int stack_cap) {
    o_x = o[3 * i];
    o_y = o[3 * i + 1];
    o_z = o[3 * i + 2];
    d_x = d[3 * i];
    d_y = d[3 * i + 1];
    d_z = d[3 * i + 2];
    kill = do_kill;
    const float tub0 =
        !valid[i] ? -1.0f
                  : (t_start ? nan_min(t_start[i], T_NO_LIMIT) : T_NO_LIMIT);
    inv_x = 1.0f / d_x;
    inv_y = 1.0f / d_y;
    inv_z = 1.0f / d_z;
    a_q = d_x * d_x + d_y * d_y + d_z * d_z;
    kill_lim = tub0 - kill_eps;
    tub = tub0;
    best_t = T_NO_LIMIT;
    prim = -1.0f;
    sp = 0;
    visits = 0;
    stack = stack_mem;
    cap = stack_cap;
    overflow = false;
    lmask = 0;
    if (tub0 >= 0.0f) stack[sp++] = 0;
  }

  __device__ __forceinline__ bool traversing() const {
    return sp > 0 && tub >= 0.0f && visits < MAX_VISITS;
  }

  // one leaf job: the prims of leaf child w of the node at `row`
  __device__ __forceinline__ void leaf_job(const Tables& tb, int w) {
    const float4 b = row[2 * w + 1];
    const int grp0 = (int)b.z, ngroups = (int)b.w;
    float job_t = T_NO_LIMIT, job_p = -1.0f;
    for (int g = 0; g < ngroups; ++g) {
      const float4* rec = tb.prims + 4 * 8 * (grp0 + g);
      // min t over the group's hits, max orig_id among the hits at it
      // (a group with no hit below T_NO_LIMIT changes nothing)
      float tbest = T_NO_LIMIT, pbest = -1.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float4 TI = rec[4 * s + 3];
        if (TI.x < -0.5f) continue;  // pad slot: no test
        const float4 G = rec[4 * s];
        float t;
        const bool ok =
            TI.x > 0.5f
                ? sph_test(o_x, o_y, o_z, d_x, d_y, d_z, a_q, G, &t)
                : tri_test(o_x, o_y, o_z, d_x, d_y, d_z, G, rec[4 * s + 1],
                           rec[4 * s + 2], &t);
        if (!ok) continue;
        if (t < tbest) {
          tbest = t;
          pbest = TI.y;
        } else if (t == tbest) {
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
    if (kill && prim >= 0.0f && best_t < kill_lim) tub = -1.0f;
  }

  // pop one node and visit it: box tests and pushes; the hit leaf children
  // are left in lmask
  __device__ __forceinline__ void visit(const Tables& tb) {
    const int node = stack[--sp];
    const int2 m = reinterpret_cast<const int2*>(tb.meta)[2 * node];
    const int ibase = m.x, icnt = m.y;
    row = tb.nodes + 2 * (8 * node);
    unsigned mask = 0;
    // the bound a child is entered under: tub, or in bf16 mode tub widened
    const float tub_c = BF16 ? widen_up(tub) : tub;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < tb.width) {
        const float4 a = row[2 * w], b = row[2 * w + 1];
        float t0x, t1x, t0y, t1y, t0z, t1z;
        if (BF16) {
          t0x = slab_bf16(a.x, o_x, inv_x);
          t1x = slab_bf16(a.w, o_x, inv_x);
          t0y = slab_bf16(a.y, o_y, inv_y);
          t1y = slab_bf16(b.x, o_y, inv_y);
          t0z = slab_bf16(a.z, o_z, inv_z);
          t1z = slab_bf16(b.y, o_z, inv_z);
        } else {
          t0x = (a.x - o_x) * inv_x;
          t1x = (a.w - o_x) * inv_x;
          t0y = (a.y - o_y) * inv_y;
          t1y = (b.x - o_y) * inv_y;
          t0z = (a.z - o_z) * inv_z;
          t1z = (b.y - o_z) * inv_z;
        }
        float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                           nan_min(t0z, t1z));
        float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                           nan_max(t0z, t1z));
        if (BF16) {
          tn = widen_down(tn);
          tf = widen_up(tf);
        }
        if ((tn <= tf) && (tf >= 0.0f) && (tn <= tub_c)) mask |= 1u << w;
      }
    }
    // inner children, reverse slot order: a child's place is the number of
    // hit inner children in later slots
    const unsigned below = (1u << icnt) - 1u;
    const unsigned imask = mask & below;
#pragma unroll
    for (int w = WMAX - 1; w >= 0; --w) {
      if (!((imask >> w) & 1u)) continue;
      if (sp < cap) {
        stack[sp++] = ibase + w;
      } else {
        overflow = true;
      }
    }
    lmask = mask & ~below;
    ++visits;
  }

  // the leaf jobs of the last visit, in slot order.  leaf_job is inlined
  // at this one place only: its code is most of the kernel's
  __device__ __forceinline__ void leaves(const Tables& tb) {
    while (lmask && tub >= 0.0f) {
      const int w = __ffs(lmask) - 1;
      lmask &= lmask - 1u;
      leaf_job(tb, w);
    }
    lmask = 0;
  }

  __device__ __forceinline__ void finish(int i, float* __restrict__ t_out,
                                         int* __restrict__ prim_out,
                                         unsigned long long* dropped) const {
    t_out[i] = prim >= 0.0f ? best_t : __int_as_float(0x7f800000);
    prim_out[i] = (int)prim;
    if ((overflow || (sp > 0 && visits >= MAX_VISITS)) && tub >= 0.0f)
      atomicAdd(dropped, 1ull);
  }
};

// o, d [n, 3]; valid [n]; t_start [n] (each ray's start bound) or null
// (1e30).  t [n] (inf on a miss), prim [n] (-1 on a miss), dropped: one
// counter.  Each ray's stack holds stack_cap entries.
template <int WMAX, bool BF16>
__global__ void __launch_bounds__(DFS_BLOCK)
dfs_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const bool* __restrict__ valid, const float* __restrict__ t_start,
           Tables tb, float* __restrict__ t_out, int* __restrict__ prim_out,
           unsigned long long* __restrict__ dropped, int n, int stack_cap,
           float kill_eps, bool do_kill) {
  const int i = blockIdx.x * DFS_BLOCK + threadIdx.x;
  if (i >= n) return;
  int stack[STACK_CAP];
  DfsRay<WMAX, BF16> r;
  r.start(i, o, d, valid, t_start, do_kill, kill_eps, stack, stack_cap);
  while (r.traversing()) {
    do {
      r.visit(tb);
    } while (!r.lmask && r.traversing());
    r.leaves(tb);
  }
  r.finish(i, t_out, prim_out, dropped);
}

// stack_cap: entries of each ray's stack, 1..STACK_CAP.  dropped: one
// int64, zeroed by the caller.  do_kill: shadow mode; bf16: the slab_bf16
// box test.
extern "C" int packet_dfs_trace(const void* o, const void* d,
                                const void* valid, const void* t_start,
                                const void* nodes, const void* prims,
                                const void* meta, void* t_out,
                                void* prim_out, void* dropped, int n,
                                int width, int stack_cap, float kill_eps,
                                int do_kill, int bf16, void* stream) {
  if (width < 1 || width > 8 || stack_cap < 1 || stack_cap > STACK_CAP)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tables tb{(const float4*)nodes, (const float4*)prims,
                    (const int*)meta, width};
    const int grid = (n + DFS_BLOCK - 1) / DFS_BLOCK;
    cudaStream_t s = (cudaStream_t)stream;
#define DFS_ARGS (const float*)o, (const float*)d, (const bool*)valid, \
                 (const float*)t_start, tb, (float*)t_out, (int*)prim_out, \
                 (unsigned long long*)dropped, n, stack_cap, kill_eps, \
                 do_kill != 0
    if (width <= 4) {
      if (bf16)
        dfs_kernel<4, true><<<grid, DFS_BLOCK, 0, s>>>(DFS_ARGS);
      else
        dfs_kernel<4, false><<<grid, DFS_BLOCK, 0, s>>>(DFS_ARGS);
    } else {
      if (bf16)
        dfs_kernel<8, true><<<grid, DFS_BLOCK, 0, s>>>(DFS_ARGS);
      else
        dfs_kernel<8, false><<<grid, DFS_BLOCK, 0, s>>>(DFS_ARGS);
    }
#undef DFS_ARGS
  }
  return (int)cudaGetLastError();
}
