// The per-level kernels of the wavefront BVH traversal: count and pack.
//
// Replace the TPU kernels cuda_raytracer_tpu/ops/pallas/wavefront2.py
// _count_kernel (launched by _run_count) and _pack_kernel (_run_pack).
// A level's queue holds one entry per (ray, inner node of the level) that
// the ray entered: 8 floats, o.xyz d.xyz rayid tub, stored entry-major
// as two float4 (o.x o.y o.z d.x) (d.y d.z rayid tub); rayid
// is an int32 bit pattern, tub the entry's carried upper bound on t (the
// shadow limit and the lineage's best hit so far; -1 = terminated).  The
// entries of one node (a "segment") are contiguous: segment s holds
// [seg_base[s], seg_base[s+1]), and seg_base[S] is the level's total.
// All of that lives on the device, so no count returns to the host: both
// kernels run a fixed grid whose threads stride over the total they read.
//
//   count: for every entry and every inner child w of its node, does the
//     entry enter the child:  ((slab_ok & tnear <= tub) | inside) &
//     tub >= 0 & outlet >= 0.  counts[s*W + w] is the number that do.  The
//     caller turns the counts into the next level's segment regions.
//   pack: for every entry, (1) leaf children in slot order: the same box
//     test against the running bound (or forced, for a root that is a
//     leaf), then packed_prim_test over the leaf's prims, first prim at
//     the minimum, strict < against the running bound to tighten it;
//     (2) an improving hit goes to the ray's 64-bit key with atomicMin:
//     high word the t bits, low word ~prim, so the least t wins and among
//     bit-equal t the largest prim (the TPU path logs hits and merges them
//     afterwards by exactly that rule; here no log and no merge pass);
//     (3) shadow kill: a hit more than kill_eps short of the entry's
//     incoming bound ends the lineage (tub = -1); (4) inner children: the
//     count kernel's test against the INCOMING bound, so the two kernels
//     agree entry for entry, and each survivor is appended to its child's
//     region of the next queue with the tightened bound.
//
// What the TPU kernels do that is not carried over: the lane shift
// network, the staging tails and their DMA semaphores (a thread stores
// where it likes), chunk-aligned regions and dead-lane padding, the
// cursor carried from chunk to chunk (blocks run in no order: a survivor's
// position is its region's base plus a rank from an atomic cursor, one
// atomicAdd per warp and child when the warp's entries share a node).
// The order of the entries inside a region therefore differs from run to
// run.  Nothing downstream depends on it: an entry's computation reads
// its own fields only, and hits merge by a min over (t bits, ~prim).
//
// Bound on the H100: count reads 32 B per entry and does one 25-flop box
// test per inner child; pack reads 32 B per entry, writes 32 B per
// survivor and 8 B per hit, and does a box test per non-empty child and a
// 37/38-flop prim test per leaf prim.  Node rows and prim rows are shared
// by the entries of a segment and come from L1/L2.  Built with
// -fmad=false, no fast math: rounds as the plain PyTorch versions.

#include "rt_common.cuh"

#define WF_BLOCK 256
#define WF_MAX_W 8
#define INF_F __int_as_float(0x7f800000)

// _box_terms of the TPU source: slab test of one child box.  Shared by
// count and pack, so their masks are the same to the bit.
struct BoxTerms {
  bool slab_ok;
  float tnear;
  bool inside;
};

__device__ __forceinline__ BoxTerms box_terms(
    const float* __restrict__ row, int W, int w, float o_x, float o_y,
    float o_z, float inv_x, float inv_y, float inv_z) {
  const float mnx = row[3 * w], mny = row[3 * w + 1], mnz = row[3 * w + 2];
  const float mxx = row[3 * W + 3 * w], mxy = row[3 * W + 3 * w + 1],
              mxz = row[3 * W + 3 * w + 2];
  const float t0x = (mnx - o_x) * inv_x, t1x = (mxx - o_x) * inv_x;
  const float t0y = (mny - o_y) * inv_y, t1y = (mxy - o_y) * inv_y;
  const float t0z = (mnz - o_z) * inv_z, t1z = (mxz - o_z) * inv_z;
  BoxTerms b;
  b.tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                    nan_min(t0z, t1z));
  const float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
  b.inside = (o_x >= mnx) && (o_x <= mxx) && (o_y >= mny) && (o_y <= mxy) &&
             (o_z >= mnz) && (o_z <= mxz);
  b.slab_ok = (b.tnear <= tfar) && (tfar >= 0.0f);
  return b;
}

// the entry enters child w under bound tub
__device__ __forceinline__ bool enters(const BoxTerms& b, float tub,
                                       float outlet) {
  return ((b.slab_ok && (b.tnear <= tub)) || b.inside) && (tub >= 0.0f) &&
         (outlet >= 0.0f);
}

// the segment of entry i: the s with seg_base[s] <= i < seg_base[s + 1]
// (seg_base is non-decreasing, i < seg_base[S])
__device__ __forceinline__ int find_segment(const int* __restrict__ seg_base,
                                            int S, int i) {
  int lo = 0, hi = S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_base[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// queue [total, 8] as float4 pairs; seg_base [S + 1]; seg_node [S]; child
// [S*W] (kind, leaf start, leaf count, forced), kind 0 none / 1 inner /
// 2 leaf; node_rows [Nn, node_stride]: child mins [3W], maxes [3W],
// outlets [W]; counts [S*W], zeroed by the caller.
__global__ void __launch_bounds__(WF_BLOCK)
wf_count_kernel(const float4* __restrict__ queue,
                const int* __restrict__ seg_base,
                const int* __restrict__ seg_node,
                const int4* __restrict__ child,
                const float* __restrict__ node_rows, int node_stride, int S,
                int W, int* __restrict__ counts) {
  const int total = seg_base[S];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WF_BLOCK;
  // the loop bound is the same for every thread of a block, so the warp
  // votes below always see whole warps
  for (long long base = (long long)blockIdx.x * WF_BLOCK; base < total;
       base += stride) {
    const long long i = base + threadIdx.x;
    int s = -1;
    unsigned enter_bits = 0;
    if (i < total) {
      s = find_segment(seg_base, S, (int)i);
      const float4 a = queue[2 * i], b = queue[2 * i + 1];
      const float tub = b.w;
      if (tub >= 0.0f) {
        const float* row = node_rows + (size_t)seg_node[s] * node_stride;
        const float inv_x = 1.0f / a.w, inv_y = 1.0f / b.x,
                    inv_z = 1.0f / b.y;
        for (int w = 0; w < W; ++w) {
          if (child[s * W + w].x != 1) continue;
          const BoxTerms bt =
              box_terms(row, W, w, a.x, a.y, a.z, inv_x, inv_y, inv_z);
          if (enters(bt, tub, row[6 * W + w])) enter_bits |= 1u << w;
        }
      }
    }
    for (int w = 0; w < W; ++w) {
      const bool m = (enter_bits >> w) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      if (bal == 0u) continue;
      const int leader = __ffs(bal) - 1;
      const int s_lead = __shfl_sync(0xffffffffu, s, leader);
      const bool same = __all_sync(0xffffffffu, !m || s == s_lead);
      if (same) {
        if (lane == leader) atomicAdd(&counts[s * W + w], __popc(bal));
      } else if (m) {
        atomicAdd(&counts[s * W + w], 1);
      }
    }
  }
}

// the key of a hit: high word the bits of t, low word ~prim; compared as
// a signed 64-bit integer, so t orders as int32 bit patterns do
__device__ __forceinline__ long long hit_key(float t, int prim) {
  return (long long)(((unsigned long long)(unsigned)__float_as_int(t) << 32) |
                     (unsigned long long)(unsigned)(~prim));
}

// route [S*W]: the next level's segment of inner child w, or -1 (not
// inner, or its region did not fit: the caller counted it as dropped);
// cursor [S_next]: next free position of each next-level region, absolute;
// queue_out [out_rows, 8]; keys [n_rays]; prim_rows [P, 16] as float4
// quads (type g.xyz)(g.w T1.xyz)(T1.w T2.xyz)(T2.w 0 0 0).
__global__ void __launch_bounds__(WF_BLOCK)
wf_pack_kernel(const float4* __restrict__ queue,
               const int* __restrict__ seg_base,
               const int* __restrict__ seg_node,
               const int4* __restrict__ child, const int* __restrict__ route,
               const float* __restrict__ node_rows, int node_stride,
               const float4* __restrict__ prim_rows, int S, int W,
               int do_kill, float kill_eps, float4* __restrict__ queue_out,
               int out_rows, int* __restrict__ cursor,
               long long* __restrict__ keys,
               unsigned long long* __restrict__ dropped) {
  const int total = seg_base[S];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WF_BLOCK;
  for (long long base = (long long)blockIdx.x * WF_BLOCK; base < total;
       base += stride) {
    const long long i = base + threadIdx.x;
    int s = -1;
    unsigned inner_bits = 0;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    float tub_out = -1.0f;
    if (i < total) {
      s = find_segment(seg_base, S, (int)i);
      a = queue[2 * i];
      b = queue[2 * i + 1];
      const float tub0 = b.w;
      if (tub0 >= 0.0f) {
        const float o_x = a.x, o_y = a.y, o_z = a.z;
        const float d_x = a.w, d_y = b.x, d_z = b.y;
        const float* row = node_rows + (size_t)seg_node[s] * node_stride;
        const float inv_x = 1.0f / d_x, inv_y = 1.0f / d_y,
                    inv_z = 1.0f / d_z;
        float tub = tub0;
        int p_run = -1;
        for (int w = 0; w < W; ++w) {
          const int4 c = child[s * W + w];
          if (c.x == 0) continue;
          const BoxTerms bt =
              box_terms(row, W, w, o_x, o_y, o_z, inv_x, inv_y, inv_z);
          const float outlet = row[6 * W + w];
          if (c.x == 1) {
            // inner child: the incoming bound decides, as in count
            if (enters(bt, tub0, outlet)) inner_bits |= 1u << w;
            continue;
          }
          // leaf child: the running bound decides; tub stays >= 0 here
          const bool m = (((bt.slab_ok && (bt.tnear <= tub)) || bt.inside) &&
                          (outlet >= 0.0f)) || (c.w > 0);
          if (!m) continue;
          float tbest = INF_F;
          int kmin = 0;
          for (int k = 0; k < c.z; ++k) {
            const float4* rec = prim_rows + 4 * (size_t)(c.y + k);
            const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r3 = rec[3];
            float t;
            const bool ok = packed_prim_test(
                o_x, o_y, o_z, d_x, d_y, d_z,
                make_float4(r0.y, r0.z, r0.w, r1.x),
                make_float4(r1.y, r1.z, r1.w, r2.x),
                make_float4(r2.y, r2.z, r2.w, r3.x), r0.x, &t);
            const float tm = ok ? t : INF_F;
            if (tm < tbest) {  // first prim at the minimum
              tbest = tm;
              kmin = k;
            }
          }
          if (tbest < tub) {
            p_run = c.y + kmin;
            tub = tbest;
          }
        }
        if (p_run >= 0)
          atomicMin(&keys[__float_as_int(b.z)], hit_key(tub, p_run));
        const bool killed =
            do_kill && (p_run >= 0) && (tub < tub0 - kill_eps);
        tub_out = killed ? -1.0f : tub;
      }
    }
    // survivors: position = the region's cursor + rank, one atomicAdd per
    // warp and child where the warp's entries share a node
    for (int w = 0; w < W; ++w) {
      const bool m = (inner_bits >> w) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      if (bal == 0u) continue;
      const int r = m ? route[s * W + w] : -1;
      const int leader = __ffs(bal) - 1;
      const int s_lead = __shfl_sync(0xffffffffu, s, leader);
      const bool same = __all_sync(0xffffffffu, !m || s == s_lead);
      int pos = -1;
      if (same) {
        int pos0 = 0;
        if (lane == leader && r >= 0) pos0 = atomicAdd(&cursor[r], __popc(bal));
        pos0 = __shfl_sync(0xffffffffu, pos0, leader);
        if (m && r >= 0) pos = pos0 + __popc(bal & ((1u << lane) - 1u));
      } else if (m && r >= 0) {
        pos = atomicAdd(&cursor[r], 1);
      }
      if (pos >= 0) {
        if (pos < out_rows) {
          queue_out[2 * (size_t)pos] = a;
          queue_out[2 * (size_t)pos + 1] = make_float4(b.x, b.y, b.z, tub_out);
        } else {
          atomicAdd(dropped, 1ull);  // never, while count and pack agree
        }
      }
    }
  }
}

static int grid_for(int bound) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = ((long long)bound + WF_BLOCK - 1) / WF_BLOCK;
  const long long cap = (long long)sms * 16;
  return (int)(want < cap ? (want < 1 ? 1 : want) : cap);
}

// bound: the most entries the level can hold (sizes the grid; the kernels
// read the real total from seg_base[S] on the device)
extern "C" int wf2_count(const void* queue, const void* seg_base,
                         const void* seg_node, const void* child,
                         const void* node_rows, int node_stride, int S, int W,
                         void* counts, int bound, void* stream) {
  if (W < 1 || W > WF_MAX_W) return (int)cudaErrorInvalidValue;
  if (bound > 0) {
    wf_count_kernel<<<grid_for(bound), WF_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)queue, (const int*)seg_base, (const int*)seg_node,
        (const int4*)child, (const float*)node_rows, node_stride, S, W,
        (int*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int wf2_pack(const void* queue, const void* seg_base,
                        const void* seg_node, const void* child,
                        const void* route, const void* node_rows,
                        int node_stride, const void* prim_rows, int S, int W,
                        int do_kill, float kill_eps, void* queue_out,
                        int out_rows, void* cursor, void* keys, void* dropped,
                        int bound, void* stream) {
  if (W < 1 || W > WF_MAX_W) return (int)cudaErrorInvalidValue;
  if (bound > 0) {
    wf_pack_kernel<<<grid_for(bound), WF_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)queue, (const int*)seg_base, (const int*)seg_node,
        (const int4*)child, (const int*)route, (const float*)node_rows,
        node_stride, (const float4*)prim_rows, S, W, do_kill, kill_eps,
        (float4*)queue_out, out_rows, (int*)cursor, (long long*)keys,
        (unsigned long long*)dropped);
  }
  return (int)cudaGetLastError();
}
