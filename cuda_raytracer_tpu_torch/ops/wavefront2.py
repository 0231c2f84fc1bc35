"""Wavefront BVH traversal: per-level count and pack kernels and their
plain versions.

The port of ``cuda_raytracer_tpu/ops/pallas/wavefront2.py``.  Rays walk
the wide BVH level by level.  A level's queue holds one 8-float entry
per (ray, inner node of the level) the ray entered — ``o.xyz d.xyz
rayid tub``, entry-major [rows, 8] float32, ``rayid`` an int32 bit
pattern in field 6, ``tub`` the entry's carried upper bound on t (the
shadow limit and its lineage's best hit; -1 = terminated) — with the
entries of one node (a *segment*) contiguous.  Per level:

* **count** (``count_level``): for every segment s and inner child w,
  how many entries enter the child;
* the counts become the next level's segment regions
  (``plan_regions``: plain torch ops on S-sized tensors, on the device,
  so no count returns to the host);
* **pack** (``pack_level``): per entry, intersect the node's leaf
  children in slot order (tightening ``tub``, first prim at the minimum
  within a leaf, strict ``<`` between leaves), record an improving hit
  in the ray's 64-bit key (``min`` over [t bits | ~prim]: least t, and
  among bit-equal t the largest prim), apply the shadow kill, and route
  the entry, with its new bound, to each inner child it enters *under
  its incoming bound* (the count kernel's test, so the two agree).

``trace_closest_wavefront`` builds the level-0 queue — every lane
(``make_payload``), or with ``compact=True`` the live lanes only
(``compact_live_rays``, ops/partition.py) — runs the level loop over the
scene's static schedule ``bvh.wf_sched`` and decodes the keys.  It runs
unchanged on the CPU and on the card: only ``count_level``,
``pack_level`` and ``compact_live_rays`` choose between a kernel
(ops/csrc/wavefront2.cu, ops/csrc/partition.cu) for CUDA tensors and a
plain version (``count_plain``, ``pack_plain``) for CPU tensors.

Against the TPU source, the hit log and its merge passes are gone (the
pack kernel resolves hits with ``atomicMin``), regions are not
chunk-aligned, and entries inside a region come in an order that may
differ from run to run on the card (atomic cursors); results do not
depend on it.  Capacity keeps its meaning: a level's queue holds at most
``queue_capacity`` entries, a segment whose cumulative demand does not
fit loses its entries, and they are counted in ``dropped``.  Not carried
over: ``seed_t``/``seed_prim``, ``box_bf16``, ``fused_counts``,
``dyn_alloc`` and the ``debug_*`` switches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ._build import load_library
from .intersect import packed_prim_test
from .packet_dfs import WaveTraceResult
from .partition import compact_live_rays

#: finite "no limit" initial bound (must not be inf: inf*0 = nan)
T_NO_LIMIT = 1e30
#: granule of the capacity rule (the JAX package's chunk size)
CHUNK = 1024
#: floats per queue entry
ROWS = 8
#: ray ids must fit the JAX package's biased-bitcast range
RID_LIMIT = 1 << 30
#: widest tree the kernels take
MAX_WIDTH = 8

_INF_BITS = 0x7F800000
_LOW = 0xFFFFFFFF
#: a ray's key before any hit: t = inf, prim = -1
KEY_MISS = (_INF_BITS << 32) | _LOW

#: launches of the count and of the pack kernel since last set to 0
count_launches = 0
pack_launches = 0

_lib = None


class LevelTables(NamedTuple):
    """One level of ``bvh.wf_sched`` as device tensors."""

    num_segs: int
    num_next: int  # segments of the next level
    has_inner: bool
    seg_node: torch.Tensor  # [S] int32: node of segment s
    #: [S*W, 4] int32 per child slot: kind (0 none / 1 inner / 2 leaf),
    #: leaf start, leaf count, forced
    child: torch.Tensor
    parent: torch.Tensor  # [S_next] int64: slot s*W+w of each next segment
    pair: torch.Tensor  # [S*W] int64: next segment of an inner slot, else 0
    inner: torch.Tensor  # [S*W] bool: kind == 1


def level_tables(sched, width: int, device) -> Tuple[LevelTables, ...]:
    """The static schedule as tensors on ``device``."""
    out = []
    for lvl, (seg_nodes, kind, pair, lstart, lcnt, forced) in enumerate(sched):
        has_inner = any(k == 1 for k in kind)
        num_next = len(sched[lvl + 1][0]) if has_inner else 0
        parent = [0] * num_next
        for slot, (k, p) in enumerate(zip(kind, pair)):
            if k == 1:
                parent[p] = slot
        i32 = dict(dtype=torch.int32, device=device)
        out.append(LevelTables(
            num_segs=len(seg_nodes),
            num_next=num_next,
            has_inner=has_inner,
            seg_node=torch.tensor(seg_nodes, **i32),
            child=torch.tensor(
                list(zip(kind, lstart, lcnt, forced)), **i32
            ).reshape(-1, 4),
            parent=torch.tensor(parent, dtype=torch.int64, device=device),
            pair=torch.tensor([max(p, 0) for p in pair], dtype=torch.int64,
                              device=device),
            inner=torch.tensor([k == 1 for k in kind], dtype=torch.bool,
                               device=device),
        ))
    return tuple(out)


def queue_capacity(n_padded: int, queue_multiplier, sched) -> int:
    """Entries a level's queue may hold: the JAX package's
    ``cap_chunks * CHUNK`` from the ray count padded to CHUNK."""
    max_next_segs = max((len(lv[0]) for lv in sched[1:]), default=1)
    cap_chunks = -(-int(queue_multiplier * n_padded) // CHUNK) \
        + max_next_segs + 2
    return cap_chunks * CHUNK


def _load_library():
    global _lib
    if _lib is None:
        lib = load_library("wavefront2")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wf2_count.argtypes = [p, p, p, p, p, i, i, i, p, i, p]
        lib.wf2_count.restype = i
        lib.wf2_pack.argtypes = [p, p, p, p, p, p, i, p, i, i, i,
                                 ctypes.c_float, p, i, p, p, p, i, p]
        lib.wf2_pack.restype = i
        _lib = lib
    return _lib


def _check(width, device, **tensors):
    """name=(tensor, dtype, shape or None): what the kernels take."""
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"wavefront supports tree_width <= {MAX_WIDTH}, "
                         f"got {width}")
    for name, (x, dt, shape) in tensors.items():
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype}, want {dt}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, queue on {device}")


def _check_level(queue, seg_base, lv, node_rows, width):
    s = lv.num_segs
    _check(
        width, queue.device,
        queue=(queue, torch.float32, (queue.shape[0], ROWS)),
        seg_base=(seg_base, torch.int32, (s + 1,)),
        seg_node=(lv.seg_node, torch.int32, (s,)),
        child=(lv.child, torch.int32, (s * width, 4)),
        node_rows=(node_rows, torch.float32, None),
    )
    if node_rows.dim() != 2 or node_rows.shape[1] < 7 * width:
        raise ValueError("node_rows: want [nodes, >= 7 * width]")
    if queue.shape[0] >= 1 << 31:
        raise ValueError("queue too long for int32 positions")


# ---------------------------------------------------------------------------
# count
# ---------------------------------------------------------------------------


def count_cuda(queue, seg_base, lv: LevelTables, node_rows, width: int,
               bound: int):
    """Launch the count kernel on the current stream: counts [S*W]
    int32.  ``bound`` is the most entries the level can hold (it sizes
    the grid; the kernel reads the real total from seg_base[S])."""
    global count_launches
    _check_level(queue, seg_base, lv, node_rows, width)
    if queue.device.type != "cuda":
        raise ValueError("count_cuda needs CUDA tensors")
    lib = _load_library()
    counts = torch.zeros((lv.num_segs * width,), dtype=torch.int32,
                         device=queue.device)
    bound = min(int(bound), queue.shape[0])
    err = lib.wf2_count(
        queue.data_ptr(), seg_base.data_ptr(), lv.seg_node.data_ptr(),
        lv.child.data_ptr(), node_rows.data_ptr(), node_rows.shape[1],
        lv.num_segs, width, counts.data_ptr(), bound,
        torch.cuda.current_stream(queue.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"count kernel launch failed: cuda error {err}")
    if bound > 0:  # the C side launches nothing for an empty queue
        count_launches += 1
    return counts


def _segments(seg_base, lo: int, hi: int):
    """Segment of each entry position in [lo, hi)."""
    pos = torch.arange(lo, hi, dtype=torch.int32, device=seg_base.device)
    return torch.searchsorted(seg_base[1:].contiguous(), pos, right=True)


def _box_terms(rows, width: int, o, inv):
    """The slab test of every child box of ``rows`` [E, >= 7W] against
    rays o, inv = 1/d [E, 3]: (slab_ok, tnear, inside, outlet), each
    [E, W]; the op order of the kernels' ``box_terms``."""
    w3 = 3 * width
    mn = rows[:, :w3].reshape(-1, width, 3)
    mx = rows[:, w3:2 * w3].reshape(-1, width, 3)
    outlet = rows[:, 2 * w3:2 * w3 + width]
    o_, inv_ = o[:, None, :], inv[:, None, :]
    t0 = (mn - o_) * inv_
    t1 = (mx - o_) * inv_
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tfar = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    inside = ((o_ >= mn) & (o_ <= mx)).all(-1)
    slab_ok = (tnear <= tfar) & (tfar >= 0.0)
    return slab_ok, tnear, inside, outlet


def _count(stats, key, k):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(k)


def count_plain(queue, seg_base, lv: LevelTables, node_rows, width: int,
                bound: int = 0, stats: dict = None, chunk: int = 1 << 20):
    """The count kernel's function in plain torch ops (any device; reads
    the level's total on the host).  ``stats``, if given, gets the work
    this data needs: ``entries`` and ``boxes`` (box tests of inner
    children of live entries)."""
    del bound
    _check_level(queue, seg_base, lv, node_rows, width)
    W = width
    total = int(seg_base[-1])
    counts = torch.zeros((lv.num_segs * W,), dtype=torch.int64,
                         device=queue.device)
    kind = lv.child[:, 0].view(-1, W)
    slot = torch.arange(W, device=queue.device)
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        q = queue[lo:hi]
        seg = _segments(seg_base, lo, hi)
        rows = node_rows[lv.seg_node[seg].long()]
        tub = q[:, 7:8]
        slab_ok, tnear, inside, outlet = _box_terms(
            rows, W, q[:, 0:3], 1.0 / q[:, 3:6])
        inner = kind[seg] == 1
        m = (((slab_ok & (tnear <= tub)) | inside) & (tub >= 0.0)
             & (outlet >= 0.0) & inner)
        counts += torch.bincount((seg[:, None] * W + slot)[m],
                                 minlength=counts.shape[0])
        _count(stats, "entries", hi - lo)
        _count(stats, "boxes", (inner & (tub >= 0.0)).sum())
    return counts.to(torch.int32)


def count_level(queue, seg_base, lv: LevelTables, node_rows, width: int,
                bound: int):
    """counts[s*W + w]: the entries of segment s that enter inner child
    w.  CUDA tensors go through the kernel (or raise); CPU tensors
    through the plain version."""
    if queue.device.type == "cuda":
        return count_cuda(queue, seg_base, lv, node_rows, width, bound)
    if queue.device.type == "cpu":
        return count_plain(queue, seg_base, lv, node_rows, width, bound)
    raise ValueError(f"no wavefront path for device {queue.device}")


def plan_regions(counts, lv: LevelTables, cap: int):
    """The next level's regions from this level's counts, on the device:
    (seg_base_next [S_next + 1] int32, route [S*W] int32, cursor
    [S_next] int32, lost).  Regions are dense, in segment order; a
    segment whose cumulative demand exceeds ``cap`` gets no region
    (route -1) and its entries are ``lost``."""
    count_next = counts[lv.parent].long()
    fits = torch.cumsum(count_next, 0) <= cap
    lost = (count_next * ~fits).sum()
    base = torch.cumsum(count_next * fits, 0)
    seg_base_next = torch.cat([base.new_zeros(1), base]).to(torch.int32)
    route = torch.where(lv.inner & fits[lv.pair], lv.pair, -1).to(torch.int32)
    return seg_base_next, route, seg_base_next[:-1].clone(), lost


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------


def _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped):
    _check_level(queue, seg_base, lv, node_rows, width)
    _check(
        width, queue.device,
        route=(route, torch.int32, (lv.num_segs * width,)),
        cursor=(cursor, torch.int32, (max(lv.num_next, 1),)),
        prim_rows=(prim_rows, torch.float32, (prim_rows.shape[0], 16)),
        queue_out=(queue_out, torch.float32, (queue_out.shape[0], ROWS)),
        keys=(keys, torch.int64, (keys.shape[0],)),
        dropped=(dropped, torch.int64, ()),
    )


def pack_cuda(queue, seg_base, lv: LevelTables, route, cursor, node_rows,
              prim_rows, width: int, do_kill: bool, kill_eps: float,
              queue_out, keys, dropped, bound: int):
    """Launch the pack kernel on the current stream.  Updates
    ``queue_out``, ``cursor``, ``keys`` and ``dropped`` in place."""
    global pack_launches
    _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped)
    if queue.device.type != "cuda":
        raise ValueError("pack_cuda needs CUDA tensors")
    lib = _load_library()
    bound = min(int(bound), queue.shape[0])
    err = lib.wf2_pack(
        queue.data_ptr(), seg_base.data_ptr(), lv.seg_node.data_ptr(),
        lv.child.data_ptr(), route.data_ptr(), node_rows.data_ptr(),
        node_rows.shape[1], prim_rows.data_ptr(), lv.num_segs, width,
        int(do_kill), float(kill_eps), queue_out.data_ptr(),
        queue_out.shape[0], cursor.data_ptr(), keys.data_ptr(),
        dropped.data_ptr(), bound,
        torch.cuda.current_stream(queue.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pack kernel launch failed: cuda error {err}")
    if bound > 0:
        pack_launches += 1


def hit_keys(t, prim):
    """[t bits | ~prim] as int64: ordered by t's int32 bit pattern, then
    by descending prim."""
    return t.view(torch.int32).long() * (1 << 32) + (_LOW - prim.long())


def pack_plain(queue, seg_base, lv: LevelTables, route, cursor, node_rows,
               prim_rows, width: int, do_kill: bool, kill_eps: float,
               queue_out, keys, dropped, bound: int = 0, stats: dict = None,
               chunk: int = 1 << 18):
    """The pack kernel's function in plain torch ops (any device; reads
    the level's total on the host).  Updates ``queue_out``, ``cursor``,
    ``keys`` and ``dropped`` in place like the kernel; survivors land in
    their regions in queue order.  ``stats``, if given, gets the work
    this data needs: ``entries``, ``boxes`` (non-empty child boxes of
    live entries), ``tris``/``spheres`` (prim tests by type), ``hits``
    (key updates) and ``survivors`` (entries written)."""
    del bound
    _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped)
    W = width
    dev = queue.device
    total = int(seg_base[-1])
    child = lv.child.view(-1, W, 4)
    route2 = route.view(-1, W)
    rid_all = queue.view(torch.int32)[:, 6]
    inf = float("inf")
    src, dst_seg, new_tub = [], [], []
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        q = queue[lo:hi]
        seg = _segments(seg_base, lo, hi)
        rows = node_rows[lv.seg_node[seg].long()]
        o, d = q[:, 0:3], q[:, 3:6]
        tub0 = q[:, 7]
        slab_ok, tnear, inside, outlet = _box_terms(rows, W, o, 1.0 / d)
        ch = child[seg]  # [E, W, 4]
        kind = ch[..., 0]
        live = tub0 >= 0.0
        _count(stats, "entries", hi - lo)
        _count(stats, "boxes", ((kind != 0) & live[:, None]).sum())

        # leaf children in slot order, tightening the running bound
        tub = tub0.clone()
        p_run = torch.full((hi - lo,), -1, dtype=torch.int64, device=dev)
        for w in range(W):
            m = (((((slab_ok[:, w] & (tnear[:, w] <= tub)) | inside[:, w])
                   & (outlet[:, w] >= 0.0)) | (ch[:, w, 3] > 0))
                 & (tub >= 0.0) & (kind[:, w] == 2))
            idx = m.nonzero()[:, 0]
            if idx.numel() == 0:
                continue
            ls, lc = ch[idx, w, 1].long(), ch[idx, w, 2].long()
            k = torch.arange(int(lc.max()), device=dev)
            kv = k[None, :] < lc[:, None]  # [J, K]
            rec = prim_rows[torch.where(kv, ls[:, None] + k, 0)]
            ptype = torch.where(kv, rec[..., 0], -1.0)
            _count(stats, "tris", ((ptype > -0.5) & (ptype <= 0.5)).sum())
            _count(stats, "spheres", (ptype > 0.5).sum())
            oj, dj = o[idx, None, :], d[idx, None, :]
            ok, t = packed_prim_test(
                oj[..., 0], oj[..., 1], oj[..., 2],
                dj[..., 0], dj[..., 1], dj[..., 2],
                *(rec[..., c] for c in range(1, 13)), rec[..., 0],
            )
            tm = torch.where(ok & kv, t, inf)
            tbest = tm.amin(1)
            kmin = torch.where(tm == tbest[:, None], k, k.numel()).amin(1)
            better = tbest < tub[idx]
            p_run[idx] = torch.where(better, ls + kmin, p_run[idx])
            tub[idx] = torch.where(better, tbest, tub[idx])

        hit = p_run >= 0
        _count(stats, "hits", hit.sum())
        keys.scatter_reduce_(
            0, rid_all[lo:hi][hit].long(), hit_keys(tub[hit], p_run[hit]),
            "amin",
        )
        if do_kill:
            tub = torch.where(hit & (tub < tub0 - kill_eps), -1.0, tub)

        # inner children: the count kernel's test, on the incoming bound
        m_in = (((slab_ok & (tnear <= tub0[:, None])) | inside)
                & live[:, None] & (outlet >= 0.0) & (kind == 1))
        r = route2[seg]
        e, w = (m_in & (r >= 0)).nonzero(as_tuple=True)
        src.append(e + lo)
        dst_seg.append(r[e, w].long())
        new_tub.append(tub[e])

    if src:
        src, dst_seg, new_tub = (torch.cat(x) for x in (src, dst_seg, new_tub))
        order = torch.argsort(dst_seg, stable=True)
        seg_sorted = dst_seg[order]
        rank = torch.arange(order.numel(), device=dev) - torch.searchsorted(
            seg_sorted, seg_sorted)
        pos = cursor[seg_sorted].long() + rank
        fit = pos < queue_out.shape[0]
        rows_out = queue[src[order]]
        rows_out[:, 7] = new_tub[order]
        queue_out[pos[fit]] = rows_out[fit]
        dropped += (~fit).sum()
        cursor += torch.bincount(dst_seg, minlength=cursor.shape[0]).to(
            torch.int32)
        _count(stats, "survivors", fit.sum())


def pack_level(queue, seg_base, lv: LevelTables, route, cursor, node_rows,
               prim_rows, width: int, do_kill: bool, kill_eps: float,
               queue_out, keys, dropped, bound: int):
    """Leaf intersection, hit keys, shadow kill and survivor routing of
    one level, in place on ``queue_out``, ``cursor``, ``keys`` and
    ``dropped``.  CUDA tensors go through the kernel (or raise); CPU
    tensors through the plain version."""
    args = (queue, seg_base, lv, route, cursor, node_rows, prim_rows, width,
            do_kill, kill_eps, queue_out, keys, dropped, bound)
    if queue.device.type == "cuda":
        return pack_cuda(*args)
    if queue.device.type == "cpu":
        return pack_plain(*args)
    raise ValueError(f"no wavefront path for device {queue.device}")


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def make_payload(o, d, valid, t_limit=None):
    """The level-0 queue [N, 8]: one entry per ray, ray ids 0..N-1.
    Invalid lanes are dead (tub = -1) with o = 2e30, d = 0."""
    n = o.shape[0]
    payload = torch.empty((n, ROWS), dtype=torch.float32, device=o.device)
    vmask = valid[:, None]
    sane = torch.tensor([2e30, 0.0, T_NO_LIMIT, -1.0], device=o.device)
    # each select writes straight into its fields of the entries
    torch.where(vmask, o.float(), sane[0], out=payload[:, 0:3])
    torch.where(vmask, d.float(), sane[1], out=payload[:, 3:6])
    payload.view(torch.int32)[:, 6] = torch.arange(
        n, dtype=torch.int32, device=o.device)
    tub = sane[2] if t_limit is None else torch.clamp_max(
        t_limit.float(), T_NO_LIMIT)
    torch.where(valid, tub, sane[3], out=payload[:, 7])
    return payload


def decode_keys(keys, want_prim: bool = True):
    """(t, prim) of each ray from its key: t = inf, prim = -1 on a miss;
    with ``want_prim=False`` prim is -2 on a hit."""
    t_bits = (keys >> 32).to(torch.int32)
    hit = t_bits < _INF_BITS
    t = torch.where(hit, t_bits.view(torch.float32), float("inf"))
    if want_prim:
        prim = torch.where(hit, _LOW - (keys & _LOW), -1)
    else:
        prim = torch.where(hit, -2, -1)
    return t, prim.to(torch.int32)


def trace_closest_wavefront(
    scene,
    o: torch.Tensor,
    d: torch.Tensor,
    valid: torch.Tensor,
    t_limit: torch.Tensor = None,
    queue_multiplier: int = 2,
    kill_eps: float = 1e-3,
    compact: bool = False,
    want_prim: bool = True,
) -> WaveTraceResult:
    """Closest-hit / shadow traversal of N rays (o, d: [N, 3] f32;
    valid: [N] bool) by the wavefront level loop.

    Returns t (inf on a miss), prim (-1 on a miss; the row of the prim
    in the BVH-sorted tables) and dropped (queue entries lost to the
    capacity rule — such rays may have lost hits; 0 when all is well).
    Shadow passes (t_limit given) never record hits beyond the limit
    and end a lineage once a hit lands kill_eps short of it, so the
    pass condition ``t > maxT - eps`` decides as a full closest-hit
    trace would.  ``compact=True`` queues the live lanes only
    (ops/partition.py), so every level sweeps live entries only; the
    result is the same to the bit.  ``want_prim=False`` (shadow
    passes) reports prim -2 on a hit.
    """
    bvh = scene.bvh
    if not bvh.wf_sched:
        raise ValueError("scene was flattened without a wavefront schedule")
    W = bvh.width
    dev = o.device
    n_in = o.shape[0]
    n_pad = n_in + (-n_in) % CHUNK
    if n_pad >= RID_LIMIT:
        raise ValueError(f"{n_pad} rays exceed the ray-id range (2^30)")
    node_rows, prim_rows = bvh.wf_node_rows, scene.wf_prim_rows
    cap = queue_capacity(n_pad, queue_multiplier, bvh.wf_sched)

    valid = valid.bool()
    if compact:
        queue, n_live = compact_live_rays(
            o.float().contiguous(), d.float().contiguous(),
            valid.contiguous(),
            None if t_limit is None else t_limit.float().contiguous())
        total0 = n_live.reshape(1)
    else:
        queue = make_payload(o, d, valid, t_limit)
        total0 = torch.full((1,), n_in, dtype=torch.int32, device=dev)
    seg_base = torch.cat([torch.zeros_like(total0), total0])
    keys = torch.full((n_in,), KEY_MISS, dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    bound = n_in

    for lv in bvh.wf_levels:
        if lv.has_inner:
            counts = count_level(queue, seg_base, lv, node_rows, W, bound)
            seg_base_next, route, cursor, lost = plan_regions(counts, lv, cap)
            dropped += lost
            queue_out = torch.empty((cap, ROWS), dtype=torch.float32,
                                    device=dev)
        else:  # leaves only: nothing is routed
            seg_base_next = None
            route = torch.full((lv.num_segs * W,), -1, dtype=torch.int32,
                               device=dev)
            cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
            queue_out = torch.empty((1, ROWS), dtype=torch.float32,
                                    device=dev)
        pack_level(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                   W, t_limit is not None, kill_eps, queue_out, keys, dropped,
                   bound)
        if not lv.has_inner:
            break
        queue, seg_base, bound = queue_out, seg_base_next, cap

    t, prim = decode_keys(keys, want_prim)
    return WaveTraceResult(t, prim, dropped)
