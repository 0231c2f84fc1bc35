"""Wavefront BVH traversal: per-level count and pack kernels, the key
decode, and their plain versions.

The port of ``cuda_raytracer_tpu/ops/pallas/wavefront2.py``.  Rays walk
the wide BVH level by level.  A level's queue holds one 8-float entry
per (ray, inner node of the level) the ray entered — ``o.xyz d.xyz
rayid tub``, entry-major [rows, 8] float32, ``rayid`` an int32 bit
pattern in field 6, ``tub`` the entry's carried upper bound on t (the
shadow limit and its lineage's best hit; -1 = terminated) — with the
entries of one node (a *segment*) contiguous.  A *tile* is up to
``TILE`` entries of one segment; ``tile_base[s]`` counts the tiles of
the segments before s.  Per level:

* **count** (``count_level``): for every segment s and inner child w,
  how many entries enter the child;
* the **plan** (``plan_regions``; on the card the last block of the
  kernel that counted): the counts become the next level's segment
  regions (``Plan``: ``seg_base``, ``tile_base``, the region cursors,
  and this level's ``route``), on the device, so no count returns to
  the host;
* **pack** (``pack_level``): per entry, intersect the node's leaf
  children in slot order (tightening ``tub``, first prim at the minimum
  within a leaf, strict ``<`` between leaves), record an improving hit
  in the ray's 64-bit key (``min`` over [t bits | ~prim]: least t, and
  among bit-equal t the largest prim), apply the shadow kill, and route
  the entry, with its new bound, to each inner child it enters *under
  its incoming bound* (the count's test, so the two agree).  With
  ``fused`` it also counts, for the next level, the children of each
  child that the survivor it writes enters under the bound it carries
  out — the count kernel's test on the next queue — and makes the next
  level's plan, so count runs only where no pack has counted.

``trace_closest_wavefront`` builds the level-0 queue — every lane
(``make_payload``), or with ``compact=True`` the live lanes only
(``compact_live_rays``, ops/partition.py) — runs the level loop over the
scene's static schedule ``bvh.wf_sched`` and decodes the keys
(``decode_keys``).  It runs unchanged on the CPU and on the card: only
``count_level``, ``pack_level``, ``decode_keys`` and
``compact_live_rays`` choose between a kernel (ops/csrc/wavefront2.cu,
ops/csrc/partition.cu) for CUDA tensors and a plain version
(``count_plain`` + ``plan_plain``, ``pack_plain`` + ``plan_plain``,
``decode_plain``) for CPU tensors.

Two options of the JAX function carry over.  ``box_bf16`` (config
``slab_bf16``) runs every box test of count and pack, the fused counts
included, with bf16 products widened so that it only gains false
positives: more entries, the same hits (the inside test and the prim
tests stay f32).  ``seed_t`` / ``seed_prim`` (ops/seeds.py) seed a
trace: each ray's level-0 bound starts at min(bound, seed_t), a shadow
ray whose seed lands kill_eps short of its limit starts dead, and each
ray's key starts from its seed hit (t bits, prim) instead of a miss.
Pack records only hits strictly better than an entry's bound, so a
recorded hit beats the seed, and a ray with none keeps it: the JAX
package's merge initialised from the seed, to the bit.

Against the TPU source, the hit log and its merge passes are gone (the
pack kernel resolves hits with ``atomicMin``, one decode pass reads the
keys), regions are not chunk-aligned, and entries inside a region come
in an order that may differ from run to run on the card (atomic
cursors); results do not depend on it.  Capacity keeps its meaning: a
level's queue holds at most ``queue_capacity`` entries, a segment whose
cumulative demand does not fit loses its entries, and they are counted
in ``dropped``.

``dyn_alloc`` (the JAX parameter; off by default, no config reaches it
in either package) replaces count and plan by allocation inside pack
(``Dyn``): the survivors of one tile for one inner child are one *run*
of the next queue, placed at one bump cursor and tagged with its next
segment in a run table (``Runs``), and the entries written per child
slot become the next level's segment counts.  ``dyn_next_level`` sorts
the run table by tag (stable, as the JAX package's argsort of its chunk
tags) into the next level's ``ReadTable``, through which its pack reads
its entries in segment order.  With nothing dropped the trace equals
the shipped one to the bit.  Its drops follow another rule: the cursor
hands out no position at or past ``queue_capacity``, and what does not
fit is lost and counted, run by run in allocation order (tiles, then
child slots, in queue order in the plain version; in the order the
blocks run on the card).  So at the first level that drops, written +
dropped is what count gives for that level's queue; which entries are
lost is not the shipped rule's (whole segments from the first that does
not fit) nor the JAX package's (whole chunks, sticky per child).  Not
carried over: the ``debug_*`` switches (timing diagnostics that give
wrong results by design; the port has no hit log to merge).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ._build import load_library
from .intersect import packed_prim_test
from .packet_dfs import WaveTraceResult, bf16_slab, bf16_widen
from .partition import compact_live_rays
from .seeds import seeded_bound

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
#: entries per tile (WF_TILE of the kernels)
TILE = 128

_INF_BITS = 0x7F800000
_LOW = 0xFFFFFFFF
#: a ray's key before any hit: t = inf, prim = -1
KEY_MISS = (_INF_BITS << 32) | _LOW

#: launches of the count, pack and decode kernels since last set to 0
#: (f32 box tests), and of count and pack with box_bf16
count_launches = 0
pack_launches = 0
decode_launches = 0
count_bf16_launches = 0
pack_bf16_launches = 0
#: launches of pack's dyn_alloc form, f32 and box_bf16
pack_dyn_launches = 0
pack_dyn_bf16_launches = 0

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
    parent: torch.Tensor  # [S_next] int32: slot s*W+w of each next segment
    pair: torch.Tensor  # [S*W] int32: next segment of an inner slot, else -1


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
            parent=torch.tensor(parent, **i32),
            pair=torch.tensor([p if k == 1 else -1
                               for k, p in zip(kind, pair)], **i32),
        ))
    return tuple(out)


class Plan(NamedTuple):
    """The next level's regions, made from one level's counts (int32):
    ``seg_base`` and ``tile_base`` [S_next + 1], ``cursor`` [S_next]
    (the next free position of each region, absolute) and ``route``
    [S*W] (the next segment of each inner slot of the counted level, or
    -1: not inner, or its region did not fit)."""

    seg_base: torch.Tensor
    tile_base: torch.Tensor
    route: torch.Tensor
    cursor: torch.Tensor


class Fused(NamedTuple):
    """What a pack needs to count for the next level and plan it:
    ``lv`` the next level's tables, ``counts`` [S_next * W] int32
    (zeroed), ``plan`` the Plan it fills, ``cap`` the queue capacity and
    ``ticket`` a zeroed int32 [1] (the kernel leaves it zeroed)."""

    lv: LevelTables
    counts: torch.Tensor
    plan: Plan
    cap: int
    ticket: torch.Tensor


class Runs(NamedTuple):
    """What a dyn_alloc pack writes beside the next queue, all zeroed
    by the caller: ``table`` [3, R] int32, per run in the order the runs
    were handed out its next segment, its first position in the queue
    and its length; ``written`` [S*W] int32, the entries written per
    child slot; ``cursor`` [2] int64, the entries and the runs handed
    out."""

    table: torch.Tensor
    written: torch.Tensor
    cursor: torch.Tensor


class ReadTable(NamedTuple):
    """How a level that a dyn_alloc pack wrote is read: its runs sorted
    by segment, ``virt`` [R] int32 the position in the level's dense
    order (``seg_base``) of each run's first entry, ``phys`` [R] int32
    its position in the queue; the unused slots last, at the level's
    total."""

    virt: torch.Tensor
    phys: torch.Tensor


class Dyn(NamedTuple):
    """A pack in the dyn_alloc form: ``read``, the level's ReadTable
    (None: the queue is dense, level 0), and ``runs``, where the next
    level goes (None: the level routes nothing)."""

    read: Optional[ReadTable]
    runs: Optional[Runs]


def queue_capacity(n_padded: int, queue_multiplier, sched) -> int:
    """Entries a level's queue may hold: the JAX package's
    ``cap_chunks * CHUNK`` from the ray count padded to CHUNK."""
    max_next_segs = max((len(lv[0]) for lv in sched[1:]), default=1)
    cap_chunks = -(-int(queue_multiplier * n_padded) // CHUNK) \
        + max_next_segs + 2
    return cap_chunks * CHUNK


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


class _LevelArgs(ctypes.Structure):
    _fields_ = [("queue", _P), ("seg_base", _P), ("tile_base", _P),
                ("seg_node", _P), ("child", _P), ("node_rows", _P),
                ("node_stride", _I), ("S", _I), ("W", _I),
                ("box_bf16", _I)]


class _PlanArgs(ctypes.Structure):
    _fields_ = [("counts", _P), ("parent", _P), ("pair", _P),
                ("seg_base_next", _P), ("tile_base_next", _P),
                ("cursor_next", _P), ("route", _P), ("dropped", _P),
                ("ticket", _P), ("n_slots", _I), ("S_next", _I),
                ("cap", _I)]


class _PackArgs(ctypes.Structure):
    _fields_ = [("route", _P), ("cursor", _P), ("prim_rows", _P),
                ("queue_out", _P), ("keys", _P), ("dropped", _P),
                ("seg_node_next", _P), ("child_next", _P),
                ("out_rows", _I), ("do_kill", _I),
                ("kill_eps", ctypes.c_float)]


class _DynArgs(ctypes.Structure):
    _fields_ = [("virt", _P), ("phys", _P), ("n_in", _I), ("runs", _P),
                ("written", _P), ("cursor", _P), ("cap_runs", _I)]


def _load_library():
    global _lib
    if _lib is None:
        lib = load_library("wavefront2")
        ref = ctypes.c_void_p
        lib.wf2_tile.argtypes = []
        lib.wf2_tile.restype = _I
        lib.wf2_count.argtypes = [ref, ref, _I, _P]
        lib.wf2_count.restype = _I
        lib.wf2_pack.argtypes = [ref, ref, ref, ref, _I, _P]
        lib.wf2_pack.restype = _I
        lib.wf2_decode.argtypes = [_P, _I, _I, _P, _P, _P]
        lib.wf2_decode.restype = _I
        if lib.wf2_tile() != TILE:
            raise RuntimeError(f"wavefront2.cu tiles {lib.wf2_tile()} "
                               f"entries, the wrapper {TILE}")
        _lib = lib
    return _lib


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _level_args(queue, seg_base, tile_base, lv, node_rows, width, bf16):
    return _LevelArgs(queue.data_ptr(), seg_base.data_ptr(),
                      tile_base.data_ptr(), lv.seg_node.data_ptr(),
                      lv.child.data_ptr(), node_rows.data_ptr(),
                      node_rows.shape[1], lv.num_segs, width, int(bool(bf16)))


def _plan_args(counts, lv, plan, cap, dropped, ticket):
    return _PlanArgs(counts.data_ptr(), lv.parent.data_ptr(),
                     lv.pair.data_ptr(), plan.seg_base.data_ptr(),
                     plan.tile_base.data_ptr(), plan.cursor.data_ptr(),
                     plan.route.data_ptr(), dropped.data_ptr(),
                     ticket.data_ptr(), lv.child.shape[0], lv.num_next,
                     int(cap))


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


def _check_level(queue, seg_base, lv, node_rows, width, tile_base=None):
    s = lv.num_segs
    _check(
        width, queue.device,
        queue=(queue, torch.float32, (queue.shape[0], ROWS)),
        seg_base=(seg_base, torch.int32, (s + 1,)),
        seg_node=(lv.seg_node, torch.int32, (s,)),
        child=(lv.child, torch.int32, (s * width, 4)),
        node_rows=(node_rows, torch.float32, None),
    )
    if tile_base is not None:
        _check(width, queue.device,
               tile_base=(tile_base, torch.int32, (s + 1,)))
    stride = node_rows.shape[1] if node_rows.dim() == 2 else 0
    if node_rows.dim() != 2 or stride < 7 * width or stride % 4:
        raise ValueError("node_rows: want [nodes, >= 7 * width], the row a "
                         "whole number of float4")
    if queue.shape[0] >= 1 << 31:
        raise ValueError("queue too long for int32 positions")


def _check_plan(counts, lv, plan, width, dropped, ticket, device):
    s, n = lv.num_segs, lv.num_next
    _check(
        width, device,
        counts=(counts, torch.int32, (s * width,)),
        parent=(lv.parent, torch.int32, (n,)),
        pair=(lv.pair, torch.int32, (s * width,)),
        plan_seg_base=(plan.seg_base, torch.int32, (n + 1,)),
        plan_tile_base=(plan.tile_base, torch.int32, (n + 1,)),
        plan_cursor=(plan.cursor, torch.int32, (n,)),
        plan_route=(plan.route, torch.int32, (s * width,)),
        dropped=(dropped, torch.int64, ()),
        ticket=(ticket, torch.int32, (1,)),
    )


def _not_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")


# ---------------------------------------------------------------------------
# count and the region plan
# ---------------------------------------------------------------------------


def count_cuda(queue, seg_base, tile_base, lv: LevelTables, node_rows,
               width: int, bound: int, counts, plan: Plan, cap: int,
               dropped, ticket, bf16: bool = False):
    """Launch the count kernel on the current stream: accumulates the
    level's counts [S*W] into ``counts`` (zeroed by the caller), and its
    last block fills ``plan`` (the next level's regions) and adds the
    entries that do not fit ``cap`` to ``dropped``.  ``bound`` is the
    most entries the level can hold (it sizes the grid; the kernel reads
    the real tile count from tile_base[S]).  ``bf16``: the box_bf16
    test."""
    global count_launches, count_bf16_launches
    _check_level(queue, seg_base, lv, node_rows, width, tile_base)
    _check_plan(counts, lv, plan, width, dropped, ticket, queue.device)
    _not_cuda("count_cuda", queue)
    lib = _load_library()
    bound = min(int(bound), queue.shape[0])
    la = _level_args(queue, seg_base, tile_base, lv, node_rows, width, bf16)
    pa = _plan_args(counts, lv, plan, cap, dropped, ticket)
    err = lib.wf2_count(ctypes.byref(la), ctypes.byref(pa), bound,
                        _stream(queue))
    if err != 0:
        raise RuntimeError(f"count kernel launch failed: cuda error {err}")
    if bf16:
        count_bf16_launches += 1
    else:
        count_launches += 1


def _segments(seg_base, lo: int, hi: int):
    """Segment of each entry position in [lo, hi)."""
    pos = torch.arange(lo, hi, dtype=torch.int32, device=seg_base.device)
    return torch.searchsorted(seg_base[1:].contiguous(), pos, right=True)


def _box_terms(rows, width: int, o, inv, bf16: bool = False):
    """The slab test of every child box of ``rows`` [E, >= 7W] against
    rays o, inv = 1/d [E, 3]: (slab_ok, tnear, inside, outlet), each
    [E, W]; the op order of the kernels' ``box_terms``.  ``bf16``: the
    TPU source's ``_box_terms(bf16=True)``: bf16 products, tnear and tfar
    widened in f32 (the inside test stays f32)."""
    w3 = 3 * width
    mn = rows[:, :w3].reshape(-1, width, 3)
    mx = rows[:, w3:2 * w3].reshape(-1, width, 3)
    outlet = rows[:, 2 * w3:2 * w3 + width]
    o_, inv_ = o[:, None, :], inv[:, None, :]
    if bf16:
        t0, t1 = bf16_slab(mn, mx, o_, inv_)
    else:
        t0 = (mn - o_) * inv_
        t1 = (mx - o_) * inv_
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tfar = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    if bf16:
        tnear, tfar = bf16_widen(tnear, tfar)
    inside = ((o_ >= mn) & (o_ <= mx)).all(-1)
    slab_ok = (tnear <= tfar) & (tfar >= 0.0)
    return slab_ok, tnear, inside, outlet


def _enters(rows, width, o, d, tub, bf16: bool = False):
    """[E, W]: the entry enters child w of its node row under bound tub
    [E] (the count's test, without the kind)."""
    slab_ok, tnear, inside, outlet = _box_terms(rows, width, o, 1.0 / d,
                                                bf16)
    tub = tub[:, None]
    return (((slab_ok & (tnear <= tub)) | inside) & (tub >= 0.0)
            & (outlet >= 0.0))


def _count(stats, key, k):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(k)


def count_plain(queue, seg_base, lv: LevelTables, node_rows, width: int,
                bound: int = 0, stats: dict = None, chunk: int = 1 << 20,
                bf16: bool = False):
    """The count kernel's counts [S*W] int32 in plain torch ops (any
    device; reads the level's total on the host).  ``stats``, if given,
    gets the work this data needs: ``entries`` and ``boxes`` (box tests
    of inner children of live entries).  ``bf16``: the box_bf16 test."""
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
        tub = q[:, 7]
        inner = kind[seg] == 1
        m = _enters(rows, W, q[:, 0:3], q[:, 3:6], tub, bf16) & inner
        counts += torch.bincount((seg[:, None] * W + slot)[m],
                                 minlength=counts.shape[0])
        _count(stats, "entries", hi - lo)
        _count(stats, "boxes", (inner & (tub >= 0.0)[:, None]).sum())
    return counts.to(torch.int32)


def plan_regions(counts, lv: LevelTables, cap: int):
    """The next level's regions from this level's counts, in torch ops
    on the device: (seg_base_next [S_next + 1] int32, route [S*W]
    int32, cursor [S_next] int32, lost).  Regions are dense, in segment
    order; a segment whose cumulative demand exceeds ``cap`` gets no
    region (route -1) and its entries are ``lost``."""
    count_next = counts[lv.parent.long()].long()
    fits = torch.cumsum(count_next, 0) <= cap
    lost = (count_next * ~fits).sum()
    base = torch.cumsum(count_next * fits, 0)
    seg_base_next = torch.cat([base.new_zeros(1), base]).to(torch.int32)
    inner = lv.pair >= 0
    pair = lv.pair.long().clamp_min(0)
    route = torch.where(inner & fits[pair], pair, -1).to(torch.int32)
    return seg_base_next, route, seg_base_next[:-1].clone(), lost


def tile_prefix(seg_base):
    """tile_base [S + 1] int32 of a level: tiles of TILE entries that
    never straddle a segment, counted over the segments before each."""
    n = torch.diff(seg_base.long())
    tiles = torch.div(n + TILE - 1, TILE, rounding_mode="floor")
    return torch.cat([tiles.new_zeros(1), torch.cumsum(tiles, 0)]).to(
        torch.int32)


def plan_plain(counts, lv: LevelTables, cap: int, plan: Plan, dropped):
    """The region plan the kernels' last block makes, in plain torch ops
    (any device): ``plan_regions`` and ``tile_prefix`` of the level's
    ``counts`` into ``plan``, the entries that do not fit ``cap`` added
    to ``dropped``."""
    seg_base, route, cursor, lost = plan_regions(counts, lv, cap)
    for dst, src in zip(plan, (seg_base, tile_prefix(seg_base), route,
                               cursor)):
        dst.copy_(src)
    dropped += lost


def count_level(queue, seg_base, tile_base, lv: LevelTables, node_rows,
                width: int, bound: int, counts, plan: Plan, cap: int,
                dropped, ticket, bf16: bool = False):
    """The level's counts into ``counts`` and the next level's regions
    into ``plan`` (lost entries into ``dropped``).  CUDA tensors go
    through the kernel (or raise); CPU tensors through the plain
    versions."""
    if queue.device.type == "cuda":
        return count_cuda(queue, seg_base, tile_base, lv, node_rows, width,
                          bound, counts, plan, cap, dropped, ticket, bf16)
    if queue.device.type == "cpu":
        counts.copy_(count_plain(queue, seg_base, lv, node_rows, width,
                                 bf16=bf16))
        return plan_plain(counts, lv, cap, plan, dropped)
    raise ValueError(f"no wavefront path for device {queue.device}")


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------


def _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped, tile_base=None, dyn=None):
    _check_level(queue, seg_base, lv, node_rows, width, tile_base)
    _check(
        width, queue.device,
        route=(route, torch.int32, (lv.num_segs * width,)),
        prim_rows=(prim_rows, torch.float32, (prim_rows.shape[0], 16)),
        queue_out=(queue_out, torch.float32, (queue_out.shape[0], ROWS)),
        keys=(keys, torch.int64, (keys.shape[0],)),
        dropped=(dropped, torch.int64, ()),
    )
    if dyn is None:
        _check(width, queue.device,
               cursor=(cursor, torch.int32, (max(lv.num_next, 1),)))
        return
    if dyn.read is not None:
        n = dyn.read.virt.shape[0]
        _check(width, queue.device,
               virt=(dyn.read.virt, torch.int32, (n,)),
               phys=(dyn.read.phys, torch.int32, (n,)))
        if n < 1:
            raise ValueError("empty read table")
    if dyn.runs is not None:
        table, written, cursor = dyn.runs
        _check(width, queue.device,
               runs=(table, torch.int32, (3, max(table.shape[1], 1))),
               written=(written, torch.int32, (lv.num_segs * width,)),
               run_cursor=(cursor, torch.int64, (2,)))
        if queue_out.shape[0] + TILE >= 1 << 31:
            raise ValueError("queue too long for int32 positions")
    elif lv.has_inner:
        raise ValueError("a level with inner children needs dyn.runs")


def _dyn_args(dyn: Dyn) -> _DynArgs:
    a = _DynArgs()
    if dyn.read is not None:
        a.virt, a.phys = dyn.read.virt.data_ptr(), dyn.read.phys.data_ptr()
        a.n_in = dyn.read.virt.shape[0]
    if dyn.runs is not None:
        table, written, cursor = dyn.runs
        a.runs, a.written = table.data_ptr(), written.data_ptr()
        a.cursor, a.cap_runs = cursor.data_ptr(), table.shape[1]
    return a


def pack_cuda(queue, seg_base, tile_base, lv: LevelTables, route, cursor,
              node_rows, prim_rows, width: int, do_kill: bool,
              kill_eps: float, queue_out, keys, dropped, bound: int,
              fused: Optional[Fused] = None, bf16: bool = False,
              dyn: Optional[Dyn] = None):
    """Launch the pack kernel on the current stream.  Updates
    ``queue_out``, ``cursor``, ``keys`` and ``dropped`` in place; with
    ``fused``, also counts for the next level into ``fused.counts`` and
    its last block fills ``fused.plan``.  ``bf16``: the box_bf16 test.
    ``dyn``: the dyn_alloc form (``route`` the level's ``pair``,
    ``cursor`` unused, no ``fused``): reads through ``dyn.read``, writes
    runs into ``dyn.runs``."""
    global pack_launches, pack_bf16_launches
    global pack_dyn_launches, pack_dyn_bf16_launches
    _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped, tile_base, dyn)
    _not_cuda("pack_cuda", queue)
    if dyn is not None and fused is not None:
        raise ValueError("the dyn_alloc form counts nothing: no fused")
    pa = _PlanArgs()  # no ticket: the launch counts nothing
    seg_node_next = child_next = 0
    if fused is not None:
        if fused.lv.num_segs != lv.num_next:
            raise ValueError("fused.lv is not the next level")
        _check_plan(fused.counts, fused.lv, fused.plan, width, dropped,
                    fused.ticket, queue.device)
        pa = _plan_args(fused.counts, fused.lv, fused.plan, fused.cap,
                          dropped, fused.ticket)
        seg_node_next = fused.lv.seg_node.data_ptr()
        child_next = fused.lv.child.data_ptr()
    lib = _load_library()
    bound = min(int(bound), queue.shape[0])
    la = _level_args(queue, seg_base, tile_base, lv, node_rows, width, bf16)
    cursor_p = 0 if cursor is None else cursor.data_ptr()  # dyn: unused
    pk = _PackArgs(route.data_ptr(), cursor_p, prim_rows.data_ptr(),
                   queue_out.data_ptr(), keys.data_ptr(), dropped.data_ptr(),
                   seg_node_next, child_next, queue_out.shape[0],
                   int(do_kill), float(kill_eps))
    da = None if dyn is None else ctypes.byref(_dyn_args(dyn))
    err = lib.wf2_pack(ctypes.byref(la), ctypes.byref(pk), ctypes.byref(pa),
                       da, bound, _stream(queue))
    if err != 0:
        raise RuntimeError(f"pack kernel launch failed: cuda error {err}")
    if dyn is not None and bf16:
        pack_dyn_bf16_launches += 1
    elif dyn is not None:
        pack_dyn_launches += 1
    elif bf16:
        pack_bf16_launches += 1
    else:
        pack_launches += 1


def hit_keys(t, prim):
    """[t bits | ~prim] as int64: ordered by t's int32 bit pattern, then
    by descending prim."""
    return t.view(torch.int32).long() * (1 << 32) + (_LOW - prim.long())


def pack_plain(queue, seg_base, lv: LevelTables, route, cursor, node_rows,
               prim_rows, width: int, do_kill: bool, kill_eps: float,
               queue_out, keys, dropped, bound: int = 0, stats: dict = None,
               chunk: int = 1 << 18, counts_next=None,
               lv_next: LevelTables = None, bf16: bool = False,
               dyn: Optional[Dyn] = None):
    """The pack kernel's function in plain torch ops (any device; reads
    the level's total on the host).  Updates ``queue_out``, ``cursor``,
    ``keys`` and ``dropped`` in place like the kernel; survivors land in
    their regions in queue order.  With ``counts_next`` (and the next
    level's tables ``lv_next``), adds to it the next level's counts of
    the survivors written: each against its child's inner children,
    under the bound it carries out.  With ``dyn``, the dyn_alloc form
    (see ``pack_cuda``): the level read through ``dyn.read``, and the
    survivors placed as runs into ``dyn.runs`` (``_place_runs``).
    ``stats``, if given, gets the work this data needs: ``entries``,
    ``boxes`` (non-empty child boxes of live entries), ``tris``/
    ``spheres`` (prim tests by type), ``hits`` (key updates),
    ``survivors`` (entries written), ``fused_boxes`` (the fused count's
    box tests) and, in the dyn_alloc form, ``runs`` (runs written).
    ``bf16``: the box_bf16 test."""
    del bound
    _check_pack(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                width, queue_out, keys, dropped, dyn=dyn)
    W = width
    dev = queue.device
    total = int(seg_base[-1])
    child = lv.child.view(-1, W, 4)
    route2 = route.view(-1, W)
    read = None if dyn is None else dyn.read
    tile_base = None if dyn is None else tile_prefix(seg_base).long()
    inf = float("inf")
    src, dst_seg, new_tub, akey = [], [], [], []
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        seg = _segments(seg_base, lo, hi)
        at = None if read is None else queue_positions(read, lo, hi)
        q = queue[lo:hi] if at is None else queue[at]
        rows = node_rows[lv.seg_node[seg].long()]
        o, d = q[:, 0:3], q[:, 3:6]
        tub0 = q[:, 7]
        slab_ok, tnear, inside, outlet = _box_terms(rows, W, o, 1.0 / d,
                                                    bf16)
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
                rec[..., 13],
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
            0, q.view(torch.int32)[:, 6][hit].long(),
            hit_keys(tub[hit], p_run[hit]), "amin",
        )
        if do_kill:
            tub = torch.where(hit & (tub < tub0 - kill_eps), -1.0, tub)

        # inner children: the count's test, on the incoming bound
        m_in = (((slab_ok & (tnear <= tub0[:, None])) | inside)
                & live[:, None] & (outlet >= 0.0) & (kind == 1))
        r = route2[seg]
        e, w = (m_in & (r >= 0)).nonzero(as_tuple=True)
        src.append(e + lo if at is None else at[e])
        dst_seg.append(r[e, w].long())
        new_tub.append(tub[e])
        if dyn is not None:  # allocation order: tile, child slot, entry
            s_e = seg[e].long()
            tile = tile_base[s_e] + torch.div(
                e + lo - seg_base[s_e].long(), TILE, rounding_mode="floor")
            akey.append(tile * W + w)

    if dyn is not None:
        if dyn.runs is not None and src:
            _place_runs(queue, *(torch.cat(x) for x in (src, dst_seg,
                                                        new_tub, akey)),
                        lv, dyn.runs, queue_out, dropped, stats)
        return
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
        if counts_next is not None:
            # the next level's count of the survivors written
            out, c = rows_out[fit], seg_sorted[fit]
            kind_next = lv_next.child[:, 0].view(-1, W)[c] == 1
            m = _enters(node_rows[lv_next.seg_node[c].long()], W,
                        out[:, 0:3], out[:, 3:6], out[:, 7], bf16) & kind_next
            slot = c[:, None] * W + torch.arange(W, device=dev)
            counts_next += torch.bincount(
                slot[m], minlength=counts_next.shape[0]).to(torch.int32)
            _count(stats, "fused_boxes",
                   (kind_next & (out[:, 7] >= 0.0)[:, None]).sum())


def queue_positions(read: ReadTable, lo: int, hi: int):
    """The queue positions (int64) of a level's dense positions [lo, hi),
    through its read table: the last run starting at or before each."""
    pos = torch.arange(lo, hi, dtype=torch.int32, device=read.virt.device)
    j = torch.searchsorted(read.virt, pos, right=True) - 1
    return read.phys[j].long() + (pos - read.virt[j]).long()


def _place_runs(queue, src, dst_seg, new_tub, akey, lv: LevelTables,
                runs: Runs, queue_out, dropped, stats):
    """The dyn_alloc form's placement (``alloc_run`` of the kernel) in
    plain torch ops: the survivors (queue position ``src``, next segment
    ``dst_seg``, bound out ``new_tub``) grouped into runs by ``akey``
    (tile * W + child slot), taken in that order, each run's entries in
    queue order.  A run takes the next positions of the entry cursor;
    the part that fits the queue is written, and the run, if any of it
    is, takes the next slot of the run table (past the table: lost).
    The rest is added to ``dropped``."""
    table, written, cursor = runs
    dev = queue.device
    n = akey.numel()
    if n == 0:
        return
    order = torch.argsort(akey, stable=True)
    k = akey[order]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = k[1:] != k[:-1]
    run = torch.cumsum(head, 0) - 1
    first = head.nonzero()[:, 0]  # each run's first survivor, sorted
    length = torch.diff(torch.cat([first, first.new_full((1,), n)]))
    at = cursor[0] + torch.cumsum(length, 0) - length
    fit = torch.minimum(torch.clamp_min(queue_out.shape[0] - at, 0), length)
    taken = fit > 0
    slot = cursor[1] + torch.cumsum(taken, 0) - 1
    ok = taken & (slot < table.shape[1])
    fit = torch.where(ok, fit, 0)
    rank = torch.arange(n, device=dev) - first[run]
    write = rank < fit[run]
    rows = queue[src[order]]
    rows[:, 7] = new_tub[order]
    queue_out[(at[run] + rank)[write]] = rows[write]
    seg = dst_seg[order][first]
    j = slot[ok]
    table[0, j] = seg[ok].to(torch.int32)
    table[1, j] = at[ok].to(torch.int32)
    table[2, j] = fit[ok].to(torch.int32)
    written.index_add_(0, lv.parent[seg[ok]].long(), fit[ok].to(torch.int32))
    dropped += (length - fit).sum()
    cursor[0] += n
    cursor[1] += taken.sum()
    _count(stats, "survivors", write.sum())
    _count(stats, "runs", ok.sum())


def pack_level(queue, seg_base, tile_base, lv: LevelTables, route, cursor,
               node_rows, prim_rows, width: int, do_kill: bool,
               kill_eps: float, queue_out, keys, dropped, bound: int,
               fused: Optional[Fused] = None, bf16: bool = False,
               dyn: Optional[Dyn] = None):
    """Leaf intersection, hit keys, shadow kill and survivor routing of
    one level, in place on ``queue_out``, ``cursor``, ``keys`` and
    ``dropped``; with ``fused``, the next level's counts and plan too;
    with ``dyn``, the dyn_alloc form (``pack_cuda``).  CUDA tensors go
    through the kernel (or raise); CPU tensors through the plain
    versions."""
    if queue.device.type == "cuda":
        return pack_cuda(queue, seg_base, tile_base, lv, route, cursor,
                         node_rows, prim_rows, width, do_kill, kill_eps,
                         queue_out, keys, dropped, bound, fused, bf16, dyn)
    if queue.device.type == "cpu":
        if dyn is not None and fused is not None:
            raise ValueError("the dyn_alloc form counts nothing: no fused")
        pack_plain(queue, seg_base, lv, route, cursor, node_rows, prim_rows,
                   width, do_kill, kill_eps, queue_out, keys, dropped,
                   counts_next=None if fused is None else fused.counts,
                   lv_next=None if fused is None else fused.lv, bf16=bf16,
                   dyn=dyn)
        if fused is not None:
            plan_plain(fused.counts, fused.lv, fused.cap, fused.plan,
                       dropped)
        return None
    raise ValueError(f"no wavefront path for device {queue.device}")


# ---------------------------------------------------------------------------
# the key decode
# ---------------------------------------------------------------------------


def decode_cuda(keys, want_prim: bool = True):
    """Launch the decode kernel on the current stream: (t [N] float32,
    prim [N] int32), as ``decode_plain``."""
    global decode_launches
    _check(1, keys.device, keys=(keys, torch.int64, (keys.shape[0],)))
    _not_cuda("decode_cuda", keys)
    if keys.shape[0] >= 1 << 31:
        raise ValueError("too many keys for int32 positions")
    lib = _load_library()
    t = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
    prim = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    err = lib.wf2_decode(keys.data_ptr(), keys.shape[0], int(want_prim),
                         t.data_ptr(), prim.data_ptr(), _stream(keys))
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: cuda error {err}")
    decode_launches += 1
    return t, prim


def decode_plain(keys, want_prim: bool = True):
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


def decode_keys(keys, want_prim: bool = True):
    """(t, prim) of each ray from its key (``decode_plain``).  CUDA
    tensors go through the kernel (or raise); CPU tensors through the
    plain version."""
    if keys.device.type == "cuda":
        return decode_cuda(keys, want_prim)
    if keys.device.type == "cpu":
        return decode_plain(keys, want_prim)
    raise ValueError(f"no wavefront path for device {keys.device}")


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def make_payload(o, d, valid, t_limit=None):
    """The level-0 queue [N, 8]: one entry per ray, ray ids 0..N-1.
    Invalid lanes are dead (tub = -1) with o = 2e30, d = 0."""
    n = o.shape[0]
    payload = torch.empty((n, ROWS), dtype=torch.float32, device=o.device)
    vmask = valid[:, None]
    # the fill values, filled on the device: no copy from the host, which
    # a frame being captured as a CUDA graph may not make
    far, zero, no_limit, dead = (
        torch.full((), v, dtype=torch.float32, device=o.device)
        for v in (2e30, 0.0, T_NO_LIMIT, -1.0))
    # each select writes straight into its fields of the entries
    torch.where(vmask, o.float(), far, out=payload[:, 0:3])
    torch.where(vmask, d.float(), zero, out=payload[:, 3:6])
    payload.view(torch.int32)[:, 6] = torch.arange(
        n, dtype=torch.int32, device=o.device)
    tub = no_limit if t_limit is None else torch.clamp_max(
        t_limit.float(), T_NO_LIMIT)
    torch.where(valid, tub, dead, out=payload[:, 7])
    return payload


class Workspace(NamedTuple):
    """The tables one trace's level loop fills, in two allocations:
    per level L with inner children ``counts[L]`` [S_L * W] and
    ``plans[L]`` (the regions of level L + 1, made from counts[L]), a
    ``ticket``, the level-0 ``heads`` (seg_base, tile_base), all zeroed
    once; and for the leaf-only level a one-entry ``cursor`` and
    ``queue``."""

    counts: dict
    plans: dict
    ticket: torch.Tensor
    heads: Tuple[torch.Tensor, torch.Tensor]
    cursor: torch.Tensor
    queue: torch.Tensor


def workspace(levels, width: int, device) -> Workspace:
    """One trace's Workspace over the levels it can visit."""
    inner = []
    for L, lv in enumerate(levels):
        if not lv.has_inner:
            break
        inner.append(L)
    n_counts = sum(levels[L].num_segs * width for L in inner)
    zeros = torch.zeros((n_counts + 6,), dtype=torch.int32, device=device)
    sizes = [(levels[L].num_next + 1, levels[L].num_next + 1,
              levels[L].num_segs * width, levels[L].num_next) for L in inner]
    tables = torch.empty((sum(map(sum, sizes)),), dtype=torch.int32,
                         device=device)
    counts, plans, at, at0 = {}, {}, 0, 0
    for L, size in zip(inner, sizes):
        counts[L] = zeros[at0:at0 + levels[L].num_segs * width]
        at0 += counts[L].numel()
        parts = []
        for n in size:
            parts.append(tables[at:at + n])
            at += n
        plans[L] = Plan(*parts)
    rest = zeros[n_counts:]
    return Workspace(counts, plans, rest[0:1], (rest[1:3], rest[3:5]),
                     rest[5:6], torch.empty((1, ROWS), dtype=torch.float32,
                                            device=device))


def run_capacity(bound: int, lv: LevelTables, width: int, cap: int) -> int:
    """Slots of the run table a dyn_alloc pack of ``lv`` needs: one run
    per tile and child slot, tiles as the kernels bound them
    (ceil(bound / TILE) + S for a level of at most ``bound`` entries),
    and no more runs than the ``cap`` entries they are written to."""
    tiles = -(-int(bound) // TILE) + lv.num_segs
    return max(1, min(tiles * width, int(cap)))


def dyn_workspace(levels, width: int, bound: int, cap: int,
                  device) -> dict:
    """The ``Runs`` of every level a dyn_alloc trace routes from, in
    one zeroed allocation: level 0's run table sized from ``bound`` (its
    queue's entries), the others' from ``cap``."""
    sizes = []
    for L, lv in enumerate(levels):
        if not lv.has_inner:
            break
        sizes.append((L, run_capacity(bound if L == 0 else cap, lv, width,
                                      cap), lv.num_segs * width))
    k = len(sizes)
    buf = torch.zeros((4 * k + sum(3 * r + sw for _, r, sw in sizes),),
                      dtype=torch.int32, device=device)
    cursors = buf[:4 * k].view(torch.int64).view(k, 2)
    out, at = {}, 4 * k
    for i, (L, r, sw) in enumerate(sizes):
        table = buf[at:at + 3 * r].view(3, r)
        written = buf[at + 3 * r:at + 3 * r + sw]
        out[L] = Runs(table, written, cursors[i])
        at += 3 * r + sw
    return out


def dyn_next_level(runs: Runs, lv: LevelTables):
    """The next level's layout from what a dyn_alloc pack of ``lv``
    wrote, in torch ops on the runs' device (no host sync): (seg_base,
    tile_base, ReadTable).  Its segment counts are the written counts by
    ``parent``; its read table is the run table sorted by next segment
    (stable: the JAX package's argsort of its chunk tags), the unused
    slots last."""
    table, written, cursor = runs
    n = table.shape[1]
    used = torch.arange(n, device=table.device) < cursor[1]
    order = torch.argsort(torch.where(used, table[0], lv.num_next),
                          stable=True)
    length = table[2][order]  # 0 in the unused slots
    virt = (torch.cumsum(length, 0) - length).to(torch.int32)
    counts = written[lv.parent.long()].long()
    seg_base = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(
        torch.int32)
    return seg_base, tile_prefix(seg_base), ReadTable(virt, table[1][order])


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
    fused_counts: bool = True,
    box_bf16: bool = False,
    seed_t: torch.Tensor = None,
    seed_prim: torch.Tensor = None,
    dyn_alloc: bool = False,
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
    passes) reports prim -2 on a hit.  ``fused_counts=True`` (the JAX
    parameter of that name) counts each level's entries for the next
    level inside the pack that writes them, so the count kernel runs
    once, on the level-0 queue; ``False`` runs a count sweep at every
    level with inner children.  The result is the same to the bit.
    ``box_bf16`` runs the bf16 box tests (the same hits, more entries);
    ``seed_t`` / ``seed_prim`` (ops/seeds.py) seed the trace (see the
    module's docstring).  ``dyn_alloc=True`` (the JAX parameter) runs no
    count at all: each pack places its survivors as runs at a bump
    cursor and reports the entries written per child, and the next
    level reads its entries through the runs sorted by segment
    (``dyn_next_level``); ``fused_counts`` is then ignored.  With
    ``dropped == 0`` the result is the same to the bit; on overflow the
    entries past the capacity are lost run by run (module docstring).
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
    levels = bvh.wf_levels
    cap = queue_capacity(n_pad, queue_multiplier, bvh.wf_sched)
    ws = workspace(levels, W, dev)

    valid = valid.bool()
    do_kill = t_limit is not None
    keys = torch.full((n_in,), KEY_MISS, dtype=torch.int64, device=dev)
    t_start = t_limit
    if seed_t is not None:
        t_start = seeded_bound(seed_t, t_limit, kill_eps)
        seeded = (seed_t < T_NO_LIMIT) & valid & (seed_prim >= 0)
        keys = torch.where(seeded, hit_keys(seed_t.float(), seed_prim),
                           keys)
    seg_base, tile_base = ws.heads
    if compact:
        queue, n_live = compact_live_rays(
            o.float().contiguous(), d.float().contiguous(),
            valid.contiguous(),
            None if t_start is None else t_start.float().contiguous())
        seg_base[1:].copy_(n_live.reshape(1))
        tile_base[1:].copy_(torch.div(n_live.reshape(1) + TILE - 1, TILE,
                                      rounding_mode="floor"))
    else:
        queue = make_payload(o, d, valid, t_start)
        seg_base[1:] = n_in
        tile_base[1:] = -(-n_in // TILE)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    bound = n_in

    if dyn_alloc:
        runs = dyn_workspace(levels, W, bound, cap, dev)
        read = None  # level 0's queue is dense
        for L, lv in enumerate(levels):
            last = not lv.has_inner  # leaves only: nothing is routed
            queue_out = ws.queue if last else torch.empty(
                (cap, ROWS), dtype=torch.float32, device=dev)
            pack_level(queue, seg_base, tile_base, lv, lv.pair, None,
                       node_rows, prim_rows, W, do_kill, kill_eps, queue_out,
                       keys, dropped, bound, bf16=box_bf16,
                       dyn=Dyn(read, runs.get(L)))
            if last:
                break
            seg_base, tile_base, read = dyn_next_level(runs[L], lv)
            queue, bound = queue_out, cap
        t, prim = decode_keys(keys, want_prim)
        return WaveTraceResult(t, prim, dropped)

    plan = None  # the regions of the next level, once a pack counted it
    for L, lv in enumerate(levels):
        if not lv.has_inner:  # leaves only: nothing is routed
            pack_level(queue, seg_base, tile_base, lv, lv.pair, ws.cursor,
                       node_rows, prim_rows, W, do_kill, kill_eps, ws.queue,
                       keys, dropped, bound, bf16=box_bf16)
            break
        if plan is None:
            plan = ws.plans[L]
            count_level(queue, seg_base, tile_base, lv, node_rows, W, bound,
                        ws.counts[L], plan, cap, dropped, ws.ticket,
                        bf16=box_bf16)
        nxt = levels[L + 1]
        fused = None
        if fused_counts and nxt.has_inner:
            fused = Fused(nxt, ws.counts[L + 1], ws.plans[L + 1], cap,
                          ws.ticket)
        queue_out = torch.empty((cap, ROWS), dtype=torch.float32, device=dev)
        pack_level(queue, seg_base, tile_base, lv, plan.route, plan.cursor,
                   node_rows, prim_rows, W, do_kill, kill_eps, queue_out,
                   keys, dropped, bound, fused, bf16=box_bf16)
        queue, seg_base, tile_base = queue_out, plan.seg_base, plan.tile_base
        bound = cap
        plan = None if fused is None else fused.plan

    t, prim = decode_keys(keys, want_prim)
    return WaveTraceResult(t, prim, dropped)
