// The per-level kernels of the wavefront BVH traversal (count, pack) and
// the decode of the hit keys.
//
// Replace the TPU kernels cuda_raytracer_tpu/ops/pallas/wavefront2.py
// _count_kernel (launched by _run_count) and _pack_kernel (_run_pack, with
// fused_gc), and the XLA merge_prefix of its hit log.
// A level's queue holds one entry per (ray, inner node of the level) that
// the ray entered: 8 floats, o.xyz d.xyz rayid tub, stored entry-major
// as two float4 (o.x o.y o.z d.x) (d.y d.z rayid tub); rayid is an int32
// bit pattern, tub the entry's carried upper bound on t (the shadow limit
// and the lineage's best hit so far; -1 = terminated).  The entries of one
// node (a "segment") are contiguous: segment s holds [seg_base[s],
// seg_base[s+1]).  A tile is up to WF_TILE entries of one segment, and
// tile_base[s] counts the tiles of the segments before s, so tiles never
// straddle a segment and tile_base[S] is the level's tile count.  All of
// that lives on the device, so no count returns to the host: both kernels
// run a fixed grid (sized from the most entries the level can hold), and
// each block walks an even share of the tile count it reads.
//
//   count: for every entry and every inner child w of its node, does the
//     entry enter the child:  ((slab_ok & tnear <= tub) | inside) &
//     tub >= 0 & outlet >= 0.  counts[s*W + w] is the number that do.
//   pack: for every entry, (1) leaf children in slot order: the same box
//     test against the running bound (or forced, for a root that is a
//     leaf), then each of the leaf's prims by its own type (tri_test or
//     sph_test, pads never hit), first prim at the minimum, strict <
//     against the running bound to tighten it; (2) an improving hit goes
//     to the ray's 64-bit key with atomicMin: high word the t bits, low
//     word ~prim, so the least t wins and among bit-equal t the largest
//     prim (the TPU path logs hits and merges them afterwards by exactly
//     that rule; here no log and no merge pass); (3) shadow kill: a hit
//     more than kill_eps short of the entry's incoming bound ends the
//     lineage (tub = -1); (4) inner children: the count's test against
//     the INCOMING bound, and each survivor is appended to its child's
//     region of the next queue with the tightened bound; (5) fused
//     counts (the TPU kernel's fused_gc): each survivor written to inner
//     child c is box-tested against c's own inner children with the bound
//     it carries out, which is the next level's count, test for test.
//   plan: the last block of a count, or of a pack that counted, turns the
//     counts into the next level's regions (plan_regions in
//     ops/wavefront2.py): dense, in segment order; the segments from the
//     first whose cumulative demand exceeds cap on get no region (route
//     -1) and their entries are added to dropped.  It writes seg_base,
//     tile_base and the cursors of the next level and this level's route.
//   decode: (t, prim) of each ray from its key, one read and one write.
//   box_bf16 (the TPU source's _box_terms(bf16=True), a separate
//     instantiation of count and pack): every box test, the fused counts'
//     included, takes the per-axis differences in f32, rounds them and 1/d
//     to bf16 and rounds each product to bf16, then widens tnear and tfar
//     in f32 by 2% of their magnitude and 1e-3, so the mask only gains
//     false positives (more entries, the same hits); the inside test and
//     the prim tests stay f32.
//   seeds (ops/seeds.py) need nothing here: the wrapper starts an entry's
//     bound and its ray's key from the seed, and pack records only hits
//     strictly better than an entry's bound.
//   dyn_alloc (the TPU source's dyn_alloc mode of _pack_kernel, a separate
//     instantiation of pack; see DynArgs): no count and no plan.  The
//     survivors of one tile for one inner child are one run, placed at one
//     global bump cursor with one atomicAdd per block, tile and child, and
//     tagged with its next segment in a run table; the entries written per
//     child slot become the next level's segment counts.  The wrapper sorts
//     the run table by tag (a torch op, as the TPU source's argsort of its
//     chunk tags is XLA glue), and the next level reads its entries in
//     segment order through that table.  The cursor hands out no position
//     at or past the queue's capacity: what does not fit is lost and added
//     to dropped, so a level's written + dropped is what count gives for
//     the same queue (which entries are lost depends on the order in which
//     blocks run).
//
// What bounds each on the H100, and what the design does about it.  Count
// and pack read 32 B per entry; pack writes 32 B per survivor and 8 B per
// hit, and tests a box per non-empty child, a prim per leaf slot and, when
// counting, a box per inner grandchild of each survivor.  The data-bound
// time is microseconds at the main path's sizes, so latency and wasted
// arithmetic set the time:
//   * tiles are segment-major, so a block's node row, child slots and leaf
//     prims are uniform: one search of tile_base per block (then a walk),
//     not one per entry; the node row, the leaf prims (64 B each, up to
//     WF_STAGE_PRIMS per segment; a segment with more reads them from
//     global memory) and, when counting, the node rows of the inner
//     children are staged in shared memory with cp.async while the tile's
//     entries load, and only when the segment changes from the block's
//     previous tile; every thread reads the same prim at the same step,
//     so the reads are broadcasts;
//   * each prim is tested by its own type (the shared packed_prim_test
//     pays three IEEE divisions and a square root per slot); tri_test and
//     sph_test keep its op order, so every t rounds as before;
//   * survivors are ranked per block: ballots within warps, a scan across
//     warps, one atomicAdd per block and child on the region cursor, so a
//     child's survivors of a tile are one contiguous run; counts are kept
//     per block in shared memory and added once per segment run;
//   * the next level's counts come out of pack, so count runs once per
//     trace (the level-0 queue), and the region plan runs in the kernels'
//     last block instead of about 8 torch launches per level.
// The order of the entries inside a region differs from run to run
// (blocks take cursor ranges in no order).  Nothing downstream depends on
// it: an entry's computation reads its own fields only, and hits merge by
// a min over (t bits, ~prim).  Built with -fmad=false, no fast math:
// rounds as the plain PyTorch versions.

#include <climits>

#include "rt_common.cuh"

#define WF_TILE 128               // entries per tile = threads per block
#define WF_WARPS (WF_TILE / 32)
#define WF_MAX_W 8
#define WF_STAGE_PRIMS 128        // leaf prims a segment stages (8 KB)
#define WF_ROW_F4 (7 * WF_MAX_W / 4)  // float4s of the widest node row
#define WF_BLOCKS_PER_SM 16
#define FULL_MASK 0xffffffffu
#define INF_F __int_as_float(0x7f800000)

// One level as both kernels read it.  queue [total, 8] as float4 pairs;
// seg_base, tile_base [S + 1]; seg_node [S]; child [S*W] (kind, leaf
// start, leaf count, forced), kind 0 none / 1 inner / 2 leaf; node_rows
// [nodes, node_stride]: child mins [3W], maxes [3W], outlets [W].
struct LevelArgs {
  const float4* queue;
  const int* seg_base;
  const int* tile_base;
  const int* seg_node;
  const int4* child;
  const float* node_rows;
  int node_stride, S, W;
  int box_bf16;  // read on the host: which instantiation to launch
};

// The region plan of the level whose counts a launch makes: counts
// [n_slots] (zeroed by the caller, accumulated by the launch), parent
// [S_next] (the slot of each next segment), pair [n_slots] (the next
// segment of an inner slot, else -1); out: seg_base_next, tile_base_next
// [S_next + 1], cursor_next [S_next], route [n_slots]; lost entries are
// added to dropped.  ticket is 0 before the launch and after it; a null
// ticket means no plan.
struct PlanArgs {
  int* counts;
  const int* parent;
  const int* pair;
  int* seg_base_next;
  int* tile_base_next;
  int* cursor_next;
  int* route;
  unsigned long long* dropped;
  unsigned int* ticket;
  int n_slots, S_next, cap;
};

// What pack reads and writes beside the level.  route [S*W]: the next
// segment of inner child w, or -1 (not inner, or its region did not fit:
// the plan counted it as dropped); cursor [S_next]: next free position of
// each next-level region, absolute; prim_rows [P, 16] as float4 quads
// (type g.xyz)(g.w T1.xyz)(T1.w T2.xyz)(T2.w scale 0 0); queue_out
// [out_rows, 8]; keys [n_rays].  seg_node_next, child_next: the next
// level's tables, read when the launch counts for it.
struct PackArgs {
  const int* route;
  int* cursor;
  const float4* prim_rows;
  float4* queue_out;
  long long* keys;
  unsigned long long* dropped;
  const int* seg_node_next;
  const int4* child_next;
  int out_rows, do_kill;
  float kill_eps;
};

// What the dyn_alloc form of pack reads and writes beside PackArgs (whose
// route is then the schedule's pair and whose cursor is unused).  Reading
// (virt non-null): the level's entries in dense order (seg_base, tile_base
// made from the written counts) lie in runs of the queue; the n_in runs,
// sorted by segment, start at dense position virt[j] and queue position
// phys[j] (runs past the used ones have virt = the level's total).  virt
// null: the queue is dense itself (level 0).  Writing (runs non-null):
// runs [3, cap_runs] gets each run's next segment, first position and
// length in the order the runs are handed out, written [S*W] the entries
// written per child slot, cursor[0] the entries and cursor[1] the runs
// handed out (all zeroed by the caller).
struct DynArgs {
  const int* virt;
  const int* phys;
  int n_in;
  int* runs;
  int* written;
  unsigned long long* cursor;
  int cap_runs;
};

// _box_terms of the TPU source: slab test of one child box.  Shared by
// count and pack (and pack's fused count), so their masks are the same to
// the bit.
struct BoxTerms {
  bool slab_ok;
  float tnear;
  bool inside;
};

template <bool BF16>
__device__ __forceinline__ BoxTerms box_terms(
    const float* row, int W, int w, float o_x, float o_y, float o_z,
    float inv_x, float inv_y, float inv_z) {
  const float mnx = row[3 * w], mny = row[3 * w + 1], mnz = row[3 * w + 2];
  const float mxx = row[3 * W + 3 * w], mxy = row[3 * W + 3 * w + 1],
              mxz = row[3 * W + 3 * w + 2];
  float t0x, t1x, t0y, t1y, t0z, t1z;
  if (BF16) {
    t0x = slab_bf16(mnx, o_x, inv_x);
    t1x = slab_bf16(mxx, o_x, inv_x);
    t0y = slab_bf16(mny, o_y, inv_y);
    t1y = slab_bf16(mxy, o_y, inv_y);
    t0z = slab_bf16(mnz, o_z, inv_z);
    t1z = slab_bf16(mxz, o_z, inv_z);
  } else {
    t0x = (mnx - o_x) * inv_x;
    t1x = (mxx - o_x) * inv_x;
    t0y = (mny - o_y) * inv_y;
    t1y = (mxy - o_y) * inv_y;
    t0z = (mnz - o_z) * inv_z;
    t1z = (mxz - o_z) * inv_z;
  }
  BoxTerms b;
  b.tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                    nan_min(t0z, t1z));
  float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                       nan_max(t0z, t1z));
  if (BF16) {
    b.tnear = widen_down(b.tnear);
    tfar = widen_up(tfar);
  }
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

// the key of a hit: high word the bits of t, low word ~prim; compared as
// a signed 64-bit integer, so t orders as int32 bit patterns do
__device__ __forceinline__ long long hit_key(float t, int prim) {
  return (long long)(((unsigned long long)(unsigned)__float_as_int(t) << 32) |
                     (unsigned long long)(unsigned)(~prim));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's tiles: an even share [t0, t1) of the level's tile count.
// Thread 0 calls locate() for each of them in order: it finds the tile's
// segment (one search of tile_base for the block's first tile, then a walk
// forward), writes the tile's segment, entry range and whether the
// segment changed to shared memory.
struct TileWalk {
  int seg;  // thread 0's: the segment of the previous tile, -1 before any

  __device__ __forceinline__ void locate(const LevelArgs& L, int t,
                                         int* sh) {
    int s = seg;
    if (s < 0) {  // largest s with tile_base[s] <= t
      int lo = 0, hi = L.S;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (L.tile_base[mid] <= t) lo = mid; else hi = mid;
      }
      s = lo;
    } else {
      while (L.tile_base[s + 1] <= t) ++s;  // skips segments with no tile
    }
    const int lo = L.seg_base[s] + (t - L.tile_base[s]) * WF_TILE;
    sh[0] = s;
    sh[1] = lo;
    sh[2] = min(lo + WF_TILE, L.seg_base[s + 1]);
    sh[3] = s != seg;
    seg = s;
  }
};

__device__ __forceinline__ void block_tiles(const LevelArgs& L, int* t0,
                                            int* t1) {
  const long long n = L.tile_base[L.S];
  *t0 = (int)(n * blockIdx.x / gridDim.x);
  *t1 = (int)(n * (blockIdx.x + 1) / gridDim.x);
}

// copy the node row of `node` (7W floats, whole float4s) into smem
__device__ __forceinline__ void stage_row(const LevelArgs& L, int node,
                                         float* smem, int j) {
  const float4* src =
      reinterpret_cast<const float4*>(L.node_rows + (size_t)node * L.node_stride);
  if (j < (7 * L.W + 3) / 4) cp_async16(reinterpret_cast<float4*>(smem) + j,
                                        src + j);
}

// inclusive scan of x over the block; *total gets the block's sum.  Every
// thread of the block calls it.
__device__ __forceinline__ int block_scan(int x, int* total) {
  __shared__ int s_w[WF_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int k = 1; k < 32; k <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, v, k);
    if (lane >= k) v += u;
  }
  if (lane == 31) s_w[warp] = v;
  __syncthreads();
  int off = 0, tot = 0;
  for (int k = 0; k < WF_WARPS; ++k) {
    const int u = s_w[k];
    if (k < warp) off += u;
    tot += u;
  }
  __syncthreads();  // s_w is free again
  *total = tot;
  return v + off;
}

// The region plan, by one block (see PlanArgs).  The segments that fit
// are a prefix (cumulative demand only grows): the first n_fit.
__device__ void make_plan(const PlanArgs& p) {
  __shared__ int s_nfit;
  const int tid = threadIdx.x;
  if (tid == 0) s_nfit = p.S_next;
  __syncthreads();
  int carry = 0;  // demand of the segments before this round
  for (int c0 = 0; c0 < p.S_next; c0 += WF_TILE) {
    const int c = c0 + tid;
    const int x = c < p.S_next ? __ldcg(p.counts + p.parent[c]) : 0;
    int tot;
    const int cum = carry + block_scan(x, &tot);
    if (c < p.S_next) {
      p.seg_base_next[c + 1] = cum;  // the fitting ones keep it
      if (cum > p.cap) atomicMin(&s_nfit, c);
    }
    carry += tot;
  }
  __syncthreads();
  const int n_fit = s_nfit;
  const int fit_total = n_fit > 0 ? p.seg_base_next[n_fit] : 0;
  if (tid == 0) {
    p.seg_base_next[0] = 0;
    p.tile_base_next[0] = 0;
    if (carry > fit_total)
      atomicAdd(p.dropped, (unsigned long long)(carry - fit_total));
  }
  int tcarry = 0;
  for (int c0 = 0; c0 < p.S_next; c0 += WF_TILE) {
    const int c = c0 + tid;
    int cnt = 0;
    if (c < p.S_next) {
      int start = fit_total;
      if (c < n_fit) {
        cnt = __ldcg(p.counts + p.parent[c]);
        start = p.seg_base_next[c + 1] - cnt;
      } else {
        p.seg_base_next[c + 1] = fit_total;
      }
      p.cursor_next[c] = start;
    }
    int tot;
    const int tiles = tcarry + block_scan((cnt + WF_TILE - 1) / WF_TILE, &tot);
    if (c < p.S_next) p.tile_base_next[c + 1] = tiles;
    tcarry += tot;
  }
  for (int j = tid; j < p.n_slots; j += WF_TILE) {
    const int q = p.pair[j];
    p.route[j] = (q >= 0 && q < n_fit) ? q : -1;
  }
}

// Every block takes a ticket once its atomics are done; the last one
// makes the plan and resets the ticket for the next launch.
__device__ __forceinline__ void plan_if_last(const PlanArgs& p) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  make_plan(p);
  if (threadIdx.x == 0) *p.ticket = 0u;
}

// pack's next-level counts of one segment run (s_gc[w*W + w2]: its
// survivors into child w that enter w's child w2) into the counts, by the
// children's next segments; s_gc is zeroed for the next run
__device__ __forceinline__ void flush_counts(int* counts, int* s_gc,
                                            const int* s_route, int W) {
  const int j = threadIdx.x;
  if (j < W * W && s_gc[j]) {
    atomicAdd(&counts[s_route[j / W] * W + j % W], s_gc[j]);
    s_gc[j] = 0;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(WF_TILE)
wf_count_kernel(const LevelArgs L, const PlanArgs plan) {
  __shared__ __align__(16) float s_row[4 * WF_ROW_F4];
  __shared__ int s_kind[WF_MAX_W];
  __shared__ int s_cnt[WF_MAX_W];
  __shared__ int s_tile[4];  // segment, first entry, end, new segment
  const int W = L.W, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < WF_MAX_W) s_cnt[tid] = 0;
  int t0, t1;
  block_tiles(L, &t0, &t1);
  TileWalk walk{-1};
  int prev = -1;  // the segment whose counts s_cnt holds
  for (int t = t0; t < t1; ++t) {
    if (tid == 0) walk.locate(L, t, s_tile);
    __syncthreads();
    const int s = s_tile[0], i = s_tile[1] + tid;
    if (s_tile[3]) {
      if (prev >= 0 && tid < W && s_cnt[tid]) {
        atomicAdd(&plan.counts[prev * W + tid], s_cnt[tid]);
        s_cnt[tid] = 0;
      }
      prev = s;
      if (warp == 0 && lane < W) s_kind[lane] = L.child[s * W + lane].x;
      if (warp == 1) stage_row(L, L.seg_node[s], s_row, lane);
      cp_async_commit();
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (i < s_tile[2]) {
      a = L.queue[2 * (size_t)i];
      b = L.queue[2 * (size_t)i + 1];
    } else {
      b.w = -1.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    const float tub = b.w;
    const float inv_x = 1.0f / a.w, inv_y = 1.0f / b.x, inv_z = 1.0f / b.y;
    for (int w = 0; w < W; ++w) {
      if (s_kind[w] != 1) continue;  // the same for the whole block
      bool m = false;
      if (tub >= 0.0f) {
        const BoxTerms bt = box_terms<BF16>(s_row, W, w, a.x, a.y, a.z,
                                            inv_x, inv_y, inv_z);
        m = enters(bt, tub, s_row[6 * W + w]);
      }
      const unsigned bal = __ballot_sync(FULL_MASK, m);
      if (lane == 0 && bal) atomicAdd(&s_cnt[w], __popc(bal));
    }
  }
  // the last segment run's counts (the others went when it changed)
  __syncthreads();
  if (prev >= 0 && tid < W && s_cnt[tid])
    atomicAdd(&plan.counts[prev * W + tid], s_cnt[tid]);
  plan_if_last(plan);
}

// dyn_alloc reading: the last run of the table that starts at or before
// dense position v (virt[0] = 0 <= v)
__device__ __forceinline__ int first_run(const DynArgs& D, int v) {
  int lo = 0, hi = D.n_in - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (D.virt[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// dyn_alloc writing: n survivors of child slot `slot` bound for next
// segment `seg` take positions at the bump cursor as one run.  Returns the
// run's first position, or out_rows when none of it is written; what does
// not fit the queue (or the run table) is added to dropped.
__device__ __forceinline__ int alloc_run(const DynArgs& D, const PackArgs& P,
                                         int seg, int slot, int n) {
  if (n == 0) return P.out_rows;
  const unsigned long long cap = (unsigned long long)P.out_rows;
  const unsigned long long at = atomicAdd(&D.cursor[0], (unsigned long long)n);
  int fit = at >= cap ? 0 : (int)min((unsigned long long)n, cap - at);
  if (fit) {
    const unsigned long long j = atomicAdd(&D.cursor[1], 1ull);
    if (j < (unsigned long long)D.cap_runs) {
      D.runs[j] = seg;
      D.runs[(size_t)D.cap_runs + j] = (int)at;
      D.runs[2 * (size_t)D.cap_runs + j] = fit;
      atomicAdd(&D.written[slot], fit);
    } else {
      fit = 0;  // never, while cap_runs bounds the level's runs
    }
  }
  if (n > fit) atomicAdd(P.dropped, (unsigned long long)(n - fit));
  return fit ? (int)at : P.out_rows;
}

template <bool BF16, bool DYN>
__global__ void __launch_bounds__(WF_TILE)
wf_pack_kernel(const LevelArgs L, const PackArgs P, const PlanArgs plan,
               const DynArgs D) {
  __shared__ __align__(16) float s_row[4 * WF_ROW_F4];
  __shared__ __align__(16) float s_crow[WF_MAX_W][4 * WF_ROW_F4];
  __shared__ __align__(16) float4 s_prim[4 * WF_STAGE_PRIMS];
  __shared__ __align__(16) int4 s_cchild[WF_MAX_W][WF_MAX_W];
  __shared__ int4 s_child[WF_MAX_W];
  __shared__ int s_route[WF_MAX_W];
  __shared__ int s_rnode[WF_MAX_W];  // node of the child's next segment
  __shared__ int s_poff[WF_MAX_W];   // leaf child's first staged prim, -1
  __shared__ int s_nstaged;
  __shared__ int s_wcnt[WF_MAX_W][WF_WARPS];
  __shared__ int s_gc[WF_MAX_W * WF_MAX_W];
  __shared__ int s_tile[4];
  // dyn_alloc reading: the table rows from the tile's first run on (a tile
  // spans at most WF_TILE runs, each of one entry or more), the tile's
  // first run and the next tile's
  __shared__ int s_virt[DYN ? WF_TILE + 1 : 1], s_phys[DYN ? WF_TILE + 1 : 1];
  __shared__ int s_run[2];
  const int W = L.W, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool fuse = !DYN && plan.ticket != nullptr;
  const bool dense = !DYN || D.virt == nullptr;
  const int row_f4 = (7 * W + 3) / 4;
  if (tid < WF_MAX_W * WF_MAX_W) s_gc[tid] = 0;
  int t0, t1;
  block_tiles(L, &t0, &t1);
  TileWalk walk{-1};
  for (int t = t0; t < t1; ++t) {
    if (tid == 0) {
      walk.locate(L, t, s_tile);
      if (!dense) s_run[0] = t == t0 ? first_run(D, s_tile[1]) : s_run[1];
    }
    __syncthreads();
    const int s = s_tile[0], i = s_tile[1] + tid;
    int src = i;  // the entry's position in the queue
    if constexpr (DYN) {
      if (!dense) {
        for (int k = tid; k <= WF_TILE; k += WF_TILE) {
          const int j = s_run[0] + k;
          s_virt[k] = j < D.n_in ? D.virt[j] : INT_MAX;
          s_phys[k] = j < D.n_in ? D.phys[j] : 0;
        }
        __syncthreads();
        if (i < s_tile[2]) {
          int lo = 0, hi = WF_TILE - 1;  // the last run starting <= i
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_virt[mid] <= i) lo = mid; else hi = mid - 1;
          }
          src = s_phys[lo] + (i - s_virt[lo]);
          // the next tile starts at s_tile[2]: in this run, or the next
          if (i == s_tile[2] - 1)
            s_run[1] = s_run[0] + lo + (s_virt[lo + 1] <= s_tile[2]);
        }
      }
    }
    if (s_tile[3]) {
      if (fuse && t > t0) {  // the previous segment run's next counts
        flush_counts(plan.counts, s_gc, s_route, W);
        __syncthreads();
      }
      // warp 0: the child slots, their routes and where the leaf prims
      // go; warp 1: the node row
      if (warp == 0) {
        int4 c = make_int4(0, 0, 0, 0);
        int r = -1, rnode = -1;
        if (lane < W) {
          c = L.child[s * W + lane];
          if (c.x == 1) {
            r = P.route[s * W + lane];
            if (fuse && r >= 0) rnode = P.seg_node_next[r];
          }
        }
        const int n = c.x == 2 ? c.z : 0;
        int incl = n;
        for (int k = 1; k < 32; k <<= 1) {
          const int u = __shfl_up_sync(FULL_MASK, incl, k);
          if (lane >= k) incl += u;
        }
        const bool staged = c.x == 2 && incl <= WF_STAGE_PRIMS;
        const int nst = __reduce_max_sync(FULL_MASK, staged ? incl : 0);
        if (lane < W) {
          s_child[lane] = c;
          s_route[lane] = r;
          s_rnode[lane] = rnode;
          s_poff[lane] = staged ? incl - n : -1;
        }
        if (lane == 0) s_nstaged = nst;
      } else if (warp == 1) {
        stage_row(L, L.seg_node[s], s_row, lane);
      }
      __syncthreads();
      // every thread: the staged leaf prims (4 float4 each) and, when
      // counting, the node rows and child slots of the next segments
      for (int j = tid; j < 4 * s_nstaged; j += WF_TILE) {
        const int p = j >> 2;
        int w = 0;
        for (int v = 0; v < W; ++v)
          if (s_poff[v] >= 0 && s_poff[v] <= p) w = v;
        cp_async16(&s_prim[j], P.prim_rows + 4 * (size_t)(s_child[w].y + p -
                                                        s_poff[w]) + (j & 3));
      }
      if (fuse) {
        for (int j = tid; j < W * row_f4; j += WF_TILE) {
          const int w = j / row_f4;
          if (s_rnode[w] >= 0) stage_row(L, s_rnode[w], s_crow[w], j % row_f4);
        }
        for (int j = tid; j < W * W; j += WF_TILE) {
          const int w = j / W;
          if (s_rnode[w] >= 0)
            cp_async16(&s_cchild[w][j % W], P.child_next + s_route[w] * W + j % W);
        }
      }
      cp_async_commit();
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (i < s_tile[2]) {
      a = L.queue[2 * (size_t)src];
      b = L.queue[2 * (size_t)src + 1];
    } else {
      b.w = -1.0f;
    }
    cp_async_wait_all();
    __syncthreads();

    const float o_x = a.x, o_y = a.y, o_z = a.z;
    const float d_x = a.w, d_y = b.x, d_z = b.y;
    const float tub0 = b.w;
    const float inv_x = 1.0f / d_x, inv_y = 1.0f / d_y, inv_z = 1.0f / d_z;
    unsigned inner_bits = 0;
    float tub_out = -1.0f;
    if (tub0 >= 0.0f) {
      const float a_q = d_x * d_x + d_y * d_y + d_z * d_z;
      float tub = tub0;
      int p_run = -1;
      for (int w = 0; w < W; ++w) {
        const int4 c = s_child[w];
        if (c.x == 0) continue;
        const BoxTerms bt = box_terms<BF16>(s_row, W, w, o_x, o_y, o_z,
                                            inv_x, inv_y, inv_z);
        const float outlet = s_row[6 * W + w];
        if (c.x == 1) {
          // inner child: the incoming bound decides, as in count
          if (enters(bt, tub0, outlet)) inner_bits |= 1u << w;
          continue;
        }
        // leaf child: the running bound decides; tub stays >= 0 here
        const bool m = (((bt.slab_ok && (bt.tnear <= tub)) || bt.inside) &&
                        (outlet >= 0.0f)) || (c.w > 0);
        if (!m) continue;
        const float4* rec = s_poff[w] >= 0 ? s_prim + 4 * s_poff[w]
                                           : P.prim_rows + 4 * (size_t)c.y;
        float tbest = INF_F;
        int kmin = 0;
        for (int k = 0; k < c.z; ++k, rec += 4) {
          const float4 r0 = rec[0];
          float tk;
          bool ok;
          if (r0.x > 0.5f) {
            ok = sph_test(o_x, o_y, o_z, d_x, d_y, d_z, a_q,
                          make_float4(r0.y, r0.z, r0.w, rec[1].x), &tk);
          } else if (r0.x > -0.5f) {
            const float4 r1 = rec[1], r2 = rec[2], r3 = rec[3];
            ok = tri_test(o_x, o_y, o_z, d_x, d_y, d_z,
                          make_float4(r0.y, r0.z, r0.w, r1.x),
                          make_float4(r1.y, r1.z, r1.w, r2.x),
                          make_float4(r2.y, r2.z, r2.w, r3.x), r3.y, &tk);
          } else {
            continue;  // pad: never a hit
          }
          if (ok && tk < tbest) {  // first prim at the minimum
            tbest = tk;
            kmin = k;
          }
        }
        if (tbest < tub) {
          p_run = c.y + kmin;
          tub = tbest;
        }
      }
      if (p_run >= 0)
        atomicMin(&P.keys[__float_as_int(b.z)], hit_key(tub, p_run));
      const bool killed =
          P.do_kill && (p_run >= 0) && (tub < tub0 - P.kill_eps);
      tub_out = killed ? -1.0f : tub;
    }

    // survivors: rank per block and child, one cursor atomic per child
    for (int w = 0; w < W; ++w) {
      if (s_child[w].x != 1 || s_route[w] < 0) continue;  // block-uniform
      const unsigned bal = __ballot_sync(FULL_MASK, (inner_bits >> w) & 1u);
      if (lane == 0) s_wcnt[w][warp] = __popc(bal);
    }
    __syncthreads();
    if (tid < W && s_child[tid].x == 1 && s_route[tid] >= 0) {
      int tot = 0;
      for (int k = 0; k < WF_WARPS; ++k) {
        const int v = s_wcnt[tid][k];
        s_wcnt[tid][k] = tot;
        tot += v;
      }
      int base;
      if constexpr (DYN)
        base = alloc_run(D, P, s_route[tid], s * W + tid, tot);
      else
        base = tot ? atomicAdd(&P.cursor[s_route[tid]], tot) : 0;
      for (int k = 0; k < WF_WARPS; ++k) s_wcnt[tid][k] += base;
    }
    __syncthreads();
    for (int w = 0; w < W; ++w) {
      if (s_child[w].x != 1 || s_route[w] < 0) continue;  // block-uniform
      const bool m = (inner_bits >> w) & 1u;
      const unsigned bal = __ballot_sync(FULL_MASK, m);
      if (!m) continue;
      const int pos = s_wcnt[w][warp] + __popc(bal & ((1u << lane) - 1u));
      const bool fits = pos < P.out_rows;
      if (fits) {
        P.queue_out[2 * (size_t)pos] = a;
        P.queue_out[2 * (size_t)pos + 1] = make_float4(b.x, b.y, b.z, tub_out);
      } else if (!DYN) {
        atomicAdd(P.dropped, 1ull);  // never, while the plan fits the queue
      }
      if (!fuse) continue;
      // the next level's count of this survivor (written, not killed)
      const bool counted = fits && tub_out >= 0.0f;
      const float* crow = s_crow[w];
      for (int w2 = 0; w2 < W; ++w2) {
        if (s_cchild[w][w2].x != 1) continue;  // the same for these lanes
        bool e = false;
        if (counted) {
          const BoxTerms bt = box_terms<BF16>(crow, W, w2, o_x, o_y, o_z,
                                              inv_x, inv_y, inv_z);
          e = enters(bt, tub_out, crow[6 * W + w2]);
        }
        const unsigned be = __ballot_sync(bal, e);
        if (be && lane == __ffs(bal) - 1) atomicAdd(&s_gc[w * W + w2], __popc(be));
      }
    }
  }
  if (fuse) {
    __syncthreads();
    if (t1 > t0) flush_counts(plan.counts, s_gc, s_route, W);
    plan_if_last(plan);
  }
}

__global__ void wf_decode_kernel(const long long* __restrict__ keys, int n,
                                 int want_prim, float* __restrict__ t,
                                 int* __restrict__ prim) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const long long k = keys[i];
    const int tb = (int)(k >> 32);
    const bool hit = tb < 0x7f800000;
    t[i] = hit ? __int_as_float(tb) : INF_F;
    prim[i] = hit ? (want_prim ? (int)~(unsigned)k : -2) : -1;
  }
}

static int grid_for(long long tiles) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)sms * WF_BLOCKS_PER_SM;
  return (int)(tiles < 1 ? 1 : (tiles < cap ? tiles : cap));
}

// bound: the most entries the level can hold; its tiles, and so the grid,
// are at most ceil(bound / WF_TILE) + S (the kernels read the real tile
// count from tile_base[S] on the device)
static long long tile_bound(const LevelArgs& L, int bound) {
  return ((long long)bound + WF_TILE - 1) / WF_TILE + L.S;
}

static bool level_ok(const LevelArgs& L) {
  return L.W >= 1 && L.W <= WF_MAX_W && L.node_stride % 4 == 0 &&
         L.node_stride >= 4 * ((7 * L.W + 3) / 4);
}

extern "C" int wf2_tile() { return WF_TILE; }

extern "C" int wf2_count(const LevelArgs* L, const PlanArgs* plan, int bound,
                         void* stream) {
  if (!level_ok(*L) || plan->ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(tile_bound(*L, bound));
  if (L->box_bf16)
    wf_count_kernel<true><<<grid, WF_TILE, 0, (cudaStream_t)stream>>>(*L,
                                                                      *plan);
  else
    wf_count_kernel<false><<<grid, WF_TILE, 0, (cudaStream_t)stream>>>(*L,
                                                                       *plan);
  return (int)cudaGetLastError();
}

template <bool BF16, bool DYN>
static void launch_pack(int grid, void* stream, const LevelArgs& L,
                        const PackArgs& P, const PlanArgs& plan,
                        const DynArgs& D) {
  wf_pack_kernel<BF16, DYN><<<grid, WF_TILE, 0, (cudaStream_t)stream>>>(
      L, P, plan, D);
}

// plan->ticket null: the launch does not count for the next level; dyn
// null: the shipped form, else the dyn_alloc form (which counts nothing)
extern "C" int wf2_pack(const LevelArgs* L, const PackArgs* P,
                        const PlanArgs* plan, const DynArgs* dyn, int bound,
                        void* stream) {
  if (!level_ok(*L)) return (int)cudaErrorInvalidValue;
  if (dyn && (plan->ticket != nullptr || (dyn->virt && dyn->n_in < 1) ||
              (dyn->runs && dyn->cap_runs < 1)))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(tile_bound(*L, bound));
  const DynArgs D = dyn ? *dyn : DynArgs{};
  if (dyn && L->box_bf16)
    launch_pack<true, true>(grid, stream, *L, *P, *plan, D);
  else if (dyn)
    launch_pack<false, true>(grid, stream, *L, *P, *plan, D);
  else if (L->box_bf16)
    launch_pack<true, false>(grid, stream, *L, *P, *plan, D);
  else
    launch_pack<false, false>(grid, stream, *L, *P, *plan, D);
  return (int)cudaGetLastError();
}

extern "C" int wf2_decode(const void* keys, int n, int want_prim, void* t,
                          void* prim, void* stream) {
  const int block = 256;
  const long long want = ((long long)n + block - 1) / block;
  const int grid = (int)(want < 1 ? 1 : (want < 132 * 32 ? want : 132 * 32));
  wf_decode_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n, want_prim, (float*)t, (int*)prim);
  return (int)cudaGetLastError();
}
