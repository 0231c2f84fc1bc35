"""Closest-hit / shadow BVH traversal: the DFS kernel and its plain version.

The port of ``cuda_raytracer_tpu/ops/pallas/packet_dfs.py``.  The TPU
kernel (``_dfs_kernel``) walks one depth-first traversal per packet of
1024 rays with union descent, because the TPU's vector unit wants 1024
lanes in lockstep.  Its Hopper counterpart (ops/csrc/packet_dfs.cu)
walks one per ray: one thread per ray, children in slot order, a node
stack per thread, each prim tested by its own type.  Both return
the closest hit and, for shadow rays, the same pass/fail decision; the
.cu file's header lists the semantics.

* ``trace_closest_packets`` — the wrapper (the JAX function's name and
  contract): launches the kernel for CUDA tensors or runs the plain
  version for CPU tensors.
* ``dfs_trace_cuda`` — the kernel's launch; ``launches`` counts it
  (``bf16_launches`` the bf16 instantiation's).  Behind each it launches
  ``dfs_tally_kernel`` (``tally_launches``), which, while the device
  tally ``"dfs"`` counts (its flag: on for the frames after a profiled
  span, utils/timing.py), walks the same rays again and adds their work
  to the tally (``TALLY_KEYS``): the rays that traverse, node visits,
  box tests, triangle and sphere tests, and the launch's lanes, lanes
  with a start bound, launches and table bytes, which a roofline bound
  needs; otherwise it returns at once.  ``launch_trace`` is the library
  call under it, with the tally's tensors given or none.
* ``dfs_trace_plain`` — the same per-ray DFS as vectorized torch ops (an
  [N, stack] stack, one pop per live ray per step), in the kernel's
  visit order and op order, so the two agree bit for bit.  Its
  ``stats`` count what the kernel's tally counts; the wrapper adds them
  to the host tally while it counts.

Both take the rays as they come (o, d [N, 3], valid [N]), each ray's
start bound ``t_start`` [N] (a shadow ray's t_limit, or the bound
seeded from ops/seeds.py; None for 1e30), the stack size
(``stack_entries(bvh)``: what the tree can need, at most
``STACK_CAP``), ``do_kill`` (shadow mode: stop a ray once a hit lands
kill_eps short of its start bound) and ``bf16`` (the ``slab_bf16``
box test: bf16 products, widened so that it only adds visits), and
return (t [N] f32, inf on a miss; prim [N] int32, -1 on a miss;
dropped, a 0-d int64 count).

The kernel builds at first use with nvcc into ``_build/`` beside the
package (ops/_build.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import timing
from ._build import load_library
from .intersect import packed_prim_test
from .seeds import seeded_bound

#: the JAX package's packet size; accepted by the wrapper and ignored
#: (the kernel has no packets)
C = 1024
#: finite "no limit" initial bound (must not be inf: inf*0 = nan)
T_NO_LIMIT = 1e30
#: the most stack entries per ray the kernel takes (each thread's stack
#: array has this many; a trace uses ``stack`` <= STACK_CAP of them); the
#: kernel is built with the same value.  An overflow is counted in
#: ``dropped``, never written past
STACK_CAP = 64
MAX_VISITS = 1 << 20

#: kernel launches since the count was last set to 0: the f32 box test,
#: and the slab_bf16 one
launches = 0
bf16_launches = 0
#: launches of the tally kernel behind them (one per trace)
tally_launches = 0
#: the work tally's counters, in the kernel's order (packet_dfs.cu
#: TallyKey)
TALLY_KEYS = ("rays", "visits", "boxes", "tris", "spheres", "lanes",
              "start_lanes", "launches", "table_bytes")
#: slab_bf16: relative widening (a few 2^-8 roundings) and absolute pad
SLAB_EPS = 0.02
SLAB_PAD = 1e-3

_lib = None


class WaveTraceResult(NamedTuple):
    t: torch.Tensor  # [N] f32, inf on a miss
    prim: torch.Tensor  # [N] int32, -1 on a miss
    dropped: torch.Tensor  # 0-d int64: live rays cut off (visit cap/stack)


def _load_library():
    """Build ops/csrc/packet_dfs.cu at first use and load it.  Raises if
    nvcc fails; there is no fallback."""
    global _lib
    if _lib is None:
        lib = load_library("packet_dfs", build_defines())
        fn = lib.packet_dfs_trace
        fn.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        keys = lib.packet_dfs_tally_keys()
        if keys != len(TALLY_KEYS):
            raise RuntimeError(f"packet_dfs.cu counts {keys} tally keys, "
                               f"TALLY_KEYS names {len(TALLY_KEYS)}")
        _lib = lib
    return _lib


def build_defines():
    """The -D flags this module's kernel is built with."""
    return (f"STACK_CAP={STACK_CAP}",)


def tally_slots() -> int:
    """The slots the tally kernel spreads its atomics over (packet_dfs.cu
    TALLY_SLOTS)."""
    return _load_library().packet_dfs_tally_slots()


def _table_bytes(node_rows, prim_rows, meta) -> int:
    return sum(x.numel() * x.element_size()
               for x in (node_rows, prim_rows, meta))


def launch_counts(n, t_start, node_rows, prim_rows, meta):
    """The tally's per-launch counters of a launch over ``n`` lanes (a
    launch of 0 lanes runs nothing and counts nothing)."""
    if not n:
        return {}
    return {"lanes": n, "start_lanes": 0 if t_start is None else n,
            "launches": 1,
            "table_bytes": _table_bytes(node_rows, prim_rows, meta)}


def stack_entries(bvh) -> int:
    """Stack entries a DFS of ``bvh`` can need: popping a node pushes at
    most W inner children, so a tree whose deepest inner node is at depth
    D needs (W - 1) * D + 1."""
    inner_levels = sum(1 for k in bvh.level_inner if k > 0)
    return (bvh.width - 1) * max(inner_levels - 1, 0) + 1


def check_rays(o, d, valid, t_limit, *tables):
    """What the kernels take of rays: o, d [N, 3] float32, valid [N]
    bool, t_limit (or a start bound) [N] float32 or None, all contiguous
    on o's device;
    ``tables``: more (name, tensor, dtype, shape) to check alike."""
    n = o.shape[0]
    for name, x, dt, shape in (
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("valid", valid, torch.bool, (n,)),
        ("t_limit", t_limit, torch.float32, (n,)),
        *tables,
    ):
        if x is None:
            continue
        if x.dtype != dt:
            raise TypeError(f"{name}: dtype {x.dtype}, want {dt}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != o.device:
            raise ValueError(f"{name} on {x.device}, o on {o.device}")


def _check_inputs(o, d, valid, t_limit, node_rows, prim_rows, meta,
                  width, stack):
    if not 1 <= width <= 8:
        raise ValueError(f"packet-DFS supports tree_width <= 8, got {width}")
    if not 1 <= stack <= STACK_CAP:
        raise ValueError(f"a stack of {stack} entries per ray: the kernel "
                         f"takes 1 to {STACK_CAP}")
    check_rays(
        o, d, valid, t_limit,
        ("node_rows", node_rows, torch.float32, (node_rows.shape[0], 8)),
        ("prim_rows", prim_rows, torch.float32, (prim_rows.shape[0], 16)),
        ("meta", meta, torch.int32, (node_rows.shape[0] // 2,)),
    )
    if node_rows.shape[0] % 8:
        raise ValueError("node_rows must hold whole 8-slot nodes")
    if prim_rows.shape[0] % 8:
        raise ValueError("prim_rows must hold whole 8-prim groups")


def dfs_trace_cuda(o, d, valid, t_start, node_rows, prim_rows, meta,
                   width: int, kill_eps: float, stack: int,
                   do_kill: bool, bf16: bool = False):
    """Launch the kernel, and the tally kernel behind it, on the current
    stream; returns (t, prim, dropped).  ``t_start`` is each ray's start
    bound (None: 1e30); ``stack`` entries per ray; ``do_kill`` the
    shadow mode; ``bf16`` the slab_bf16 box test."""
    _check_inputs(o, d, valid, t_start, node_rows, prim_rows, meta, width,
                  stack)
    if o.device.type != "cuda":
        raise ValueError("dfs_trace_cuda needs CUDA tensors")
    tally = timing.tally("dfs", TALLY_KEYS, o.device, tally_slots())
    return launch_trace(o, d, valid, t_start, node_rows, prim_rows, meta,
                        width, kill_eps, stack, do_kill, bf16, tally.live,
                        tally.on)


def launch_trace(o, d, valid, t_start, node_rows, prim_rows, meta,
                 width: int, kill_eps: float, stack: int, do_kill: bool,
                 bf16: bool, tally=None, tally_on=None):
    """The library call under ``dfs_trace_cuda``, on checked CUDA
    tensors: the trace, and, where ``tally`` ([tally_slots(),
    len(TALLY_KEYS)] int64) is given, the tally kernel, which adds into
    it while the int64 ``tally_on`` is not 0; returns (t, prim,
    dropped)."""
    global launches, bf16_launches, tally_launches
    lib = _load_library()
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    dropped = torch.zeros((), dtype=torch.int64, device=o.device)
    err = lib.packet_dfs_trace(
        o.data_ptr(), d.data_ptr(), valid.data_ptr(),
        None if t_start is None else t_start.data_ptr(),
        node_rows.data_ptr(), prim_rows.data_ptr(), meta.data_ptr(),
        t.data_ptr(), prim.data_ptr(), dropped.data_ptr(),
        None if tally is None else tally.data_ptr(),
        None if tally is None else tally_on.data_ptr(),
        _table_bytes(node_rows, prim_rows, meta), n, width,
        int(stack), float(kill_eps), int(bool(do_kill)), int(bool(bf16)),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"packet_dfs kernel launch failed: cuda error {err}")
    if n:  # the C side launches nothing for an empty batch
        if bf16:
            bf16_launches += 1
        else:
            launches += 1
        tally_launches += tally is not None
    return t, prim, dropped


def bf16_slab(lo, hi, o, inv):
    """One axis of the slab_bf16 test: the differences in f32 rounded
    to bf16, times 1/d rounded to bf16, each product rounded to bf16
    (torch's bf16 multiply); returns (t0, t1) as bf16."""
    ib = inv.to(torch.bfloat16)
    return ((lo - o).to(torch.bfloat16) * ib,
            (hi - o).to(torch.bfloat16) * ib)


def bf16_widen(tn, tf):
    """bf16 tn, tf widened in f32 so the test only gains false
    positives: tn - |tn| eps - pad, tf + |tf| eps + pad."""
    tn, tf = tn.float(), tf.float()
    return (tn - tn.abs() * SLAB_EPS - SLAB_PAD,
            tf + tf.abs() * SLAB_EPS + SLAB_PAD)


def dfs_trace_plain(o, d, valid, t_start, node_rows, prim_rows, meta,
                    width: int, kill_eps: float, stack: int,
                    do_kill: bool, bf16: bool = False,
                    stats: dict = None):
    """The kernel's per-ray DFS in plain torch ops (any device).

    Each step pops one node for every ray still traversing, slab-tests
    its W children, pushes the hit inner children in reverse slot order
    and folds the hit leaf children's prim groups in slot order, exactly
    as the kernel's loop body does.  Returns (t, prim, dropped) like the
    kernel.  ``stats``, if given, gets the work this data needs (the
    counts a roofline bound needs), as the kernel's tally counts it:
    the ``rays`` that traverse (valid, with a start bound >= 0), node
    ``visits``, ``boxes`` (tests of non-empty child slots), and prim
    tests by type, ``tris`` and ``spheres`` (pad slots are no test; a
    leaf job runs only while the ray's bound is >= 0, so a shadow ray's
    kill skips the node's later jobs).
    """
    _check_inputs(o, d, valid, t_start, node_rows, prim_rows, meta, width,
                  stack)
    W = width
    dev = o.device
    n = o.shape[0]
    o_x, o_y, o_z = o.unbind(1)
    d_x, d_y, d_z = d.unbind(1)
    tub0 = (torch.clamp_max(t_start, T_NO_LIMIT) if t_start is not None
            else torch.full((n,), T_NO_LIMIT, dtype=torch.float32,
                            device=dev))
    tub0 = torch.where(valid, tub0, -1.0)
    inv_x, inv_y, inv_z = 1.0 / d_x, 1.0 / d_y, 1.0 / d_z
    kill_lim = tub0 - kill_eps

    tub = tub0.clone()
    best = torch.full((n,), T_NO_LIMIT, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    stk = torch.zeros((n, stack), dtype=torch.int64, device=dev)
    sp = (tub0 >= 0.0).long()  # the root, for live rays
    if stats is not None:
        _count(stats, "rays", sp.sum())
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = node_rows.view(-1, 8, 8)[:, :W]  # [Nd, W, 8]
    groups = prim_rows.view(-1, 8, 16)  # [G, 8, 16]
    meta4 = meta.view(-1, 4).long()
    slot = torch.arange(W, device=dev)

    while True:
        act = ((sp > 0) & (tub >= 0.0) & (visits < MAX_VISITS)).nonzero()
        idx = act[:, 0]
        if idx.numel() == 0:
            break
        spa = sp[idx] - 1
        node = stk[idx, spa]
        blk = rows[node]  # [A, W, 8]
        if stats is not None:
            _count(stats, "visits", idx.numel())
            _count(stats, "boxes", (blk[..., 0] <= blk[..., 3]).sum())
        ox, oy, oz = o_x[idx, None], o_y[idx, None], o_z[idx, None]
        ix, iy, iz = inv_x[idx, None], inv_y[idx, None], inv_z[idx, None]
        if bf16:
            t0x, t1x = bf16_slab(blk[..., 0], blk[..., 3], ox, ix)
            t0y, t1y = bf16_slab(blk[..., 1], blk[..., 4], oy, iy)
            t0z, t1z = bf16_slab(blk[..., 2], blk[..., 5], oz, iz)
        else:
            t0x = (blk[..., 0] - ox) * ix
            t1x = (blk[..., 3] - ox) * ix
            t0y = (blk[..., 1] - oy) * iy
            t1y = (blk[..., 4] - oy) * iy
            t0z = (blk[..., 2] - oz) * iz
            t1z = (blk[..., 5] - oz) * iz
        tn = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.minimum(t0z, t1z),
        )
        tf = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.maximum(t0z, t1z),
        )
        ta = tub[idx]
        tc = ta
        if bf16:
            tn, tf = bf16_widen(tn, tf)
            tc = ta + ta.abs() * SLAB_EPS + SLAB_PAD
        m = (tn <= tf) & (tf >= 0.0) & (tn <= tc[:, None])  # [A, W]
        ibase, icnt = meta4[node, 0], meta4[node, 1]

        # inner children, reverse slot order so slot 0 pops first
        for w in range(W - 1, -1, -1):
            push = (w < icnt) & m[:, w]
            fits = spa < stack
            overflow[idx[push & ~fits]] = True
            do = push & fits
            stk[idx[do], spa[do]] = ibase[do] + w
            spa = spa + do.long()
        sp[idx] = spa

        # leaf children: one job per (ray, slot); fold groups in order
        ja, jw = (m & (slot[None, :] >= icnt[:, None])).nonzero(as_tuple=True)
        grp0 = blk[ja, jw, 6].long()
        ngr = blk[ja, jw, 7].long()
        if ja.numel() and int(ngr.max()) > 0:
            g = torch.arange(int(ngr.max()), device=dev)
            gv = g[None, :] < ngr[:, None]  # [J, Gmax]
            rec = groups[torch.where(gv, grp0[:, None] + g, 0)]  # [J,Gm,8,16]
            if stats is not None:
                # each job's prim tests, by (ray, slot)
                ptype = torch.where(gv[..., None], rec[..., 12], -1.0)
                n_tri = torch.zeros((idx.numel(), W), dtype=torch.int64,
                                    device=dev)
                n_sph = torch.zeros_like(n_tri)
                n_tri[ja, jw] = ((ptype > -0.5) & (ptype <= 0.5)).sum((1, 2))
                n_sph[ja, jw] = (ptype > 0.5).sum((1, 2))
            r = idx[ja]
            ok, t = packed_prim_test(
                o_x[r, None, None], o_y[r, None, None], o_z[r, None, None],
                d_x[r, None, None], d_y[r, None, None], d_z[r, None, None],
                *(rec[..., k] for k in range(13)), rec[..., 14],
            )
            tmat = torch.where(ok, t, T_NO_LIMIT)
            tbest = tmat.amin(-1)  # [J, Gm]
            pbest = torch.where(
                tmat <= tbest[..., None], rec[..., 13], -1.0
            ).amax(-1)
            tb = torch.where(gv, tbest, float("inf"))
            gmin = tb.argmin(1, keepdim=True)  # first group at the min
            jt = tb.gather(1, gmin)[:, 0]
            jp = pbest.gather(1, gmin)[:, 0]
            upd = jt < T_NO_LIMIT
            job_t = torch.full((idx.numel(), W), T_NO_LIMIT,
                               dtype=torch.float32, device=dev)
            job_p = torch.full_like(job_t, -1.0)
            job_t[ja, jw] = torch.where(upd, jt, T_NO_LIMIT)
            job_p[ja, jw] = torch.where(upd, jp, -1.0)
            pa, ba, kl = prim[idx], best[idx], kill_lim[idx]
            for w in range(W):
                if stats is not None:
                    # the kernel runs a job only while the bound is >= 0
                    ran = ta >= 0.0
                    _count(stats, "tris", n_tri[ran, w].sum())
                    _count(stats, "spheres", n_sph[ran, w].sum())
                better = job_t[:, w] < ta
                pa = torch.where(better, job_p[:, w], pa)
                ba = torch.where(better, job_t[:, w], ba)
                ta = torch.where(better, job_t[:, w], ta)
                if do_kill:
                    ta = torch.where((pa >= 0.0) & (ba < kl), -1.0, ta)
            prim[idx], best[idx], tub[idx] = pa, ba, ta
        visits[idx] += 1

    truncated = (overflow | ((sp > 0) & (visits >= MAX_VISITS))) & (tub >= 0.0)
    return (torch.where(prim >= 0.0, best, float("inf")),
            prim.to(torch.int32), truncated.sum())


def _count(stats, key, k):
    stats[key] = stats.get(key, 0) + int(k)


def trace_closest_packets(
    scene,
    o: torch.Tensor,
    d: torch.Tensor,
    valid: torch.Tensor,
    t_limit: torch.Tensor = None,
    kill_eps: float = 1e-3,
    packet_size: int = C,
    slab_bf16: bool = False,
    seed_t: torch.Tensor = None,
    seed_prim: torch.Tensor = None,
) -> WaveTraceResult:
    """Closest-hit / shadow traversal of N rays (o, d: [N, 3] f32;
    valid: [N] bool).

    Returns t (inf on a miss), prim (-1 on a miss) and dropped (live
    rays cut off by the visit cap or a stack overflow — such rays may
    have lost hits; surfaced rather than silent).  Shadow passes
    (t_limit given) never record hits beyond the limit and stop a ray
    once a hit lands kill_eps short of it, so the pass condition
    ``t > maxT - eps`` decides as a full closest-hit trace would.

    ``slab_bf16`` runs the bf16 box test (the same hits, more visits).
    ``seed_t`` / ``seed_prim`` (ops/seeds.py) seed each ray's start
    bound: it starts at min(bound, seed_t); a shadow ray whose seed lands
    more than kill_eps short of its limit is answered without a
    traversal; the kernel reports only hits strictly better than the
    bound, and the seed stands where it reported none.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain version.  ``packet_size`` is accepted for the JAX
    signature and ignored: the kernel traces one ray per thread.
    """
    del packet_size
    bvh = scene.bvh
    stack = stack_entries(bvh)
    if stack > STACK_CAP:
        raise ValueError(f"the tree needs a stack of {stack} entries per "
                         f"ray; the kernel takes at most {STACK_CAP}")
    do_kill = t_limit is not None
    t_start = None if t_limit is None else t_limit.float().contiguous()
    if seed_t is not None:
        t_start = seeded_bound(seed_t, t_limit, kill_eps).contiguous()
    args = (o.float().contiguous(), d.float().contiguous(),
            valid.bool().contiguous(), t_start,
            bvh.dfs_node_rows, bvh.dfs_prim_rows, bvh.node_meta, bvh.width,
            kill_eps, stack, do_kill, slab_bf16)
    if o.device.type == "cuda":
        t, prim, dropped = dfs_trace_cuda(*args)
    elif o.device.type == "cpu":
        if timing.counting():
            stats = launch_counts(o.shape[0], *args[3:7])
            t, prim, dropped = dfs_trace_plain(*args, stats=stats)
            timing.add("dfs", TALLY_KEYS, o.device, stats)
        else:
            t, prim, dropped = dfs_trace_plain(*args)
    else:
        raise ValueError(f"no packet-DFS path for device {o.device}")
    if seed_t is not None:
        # rays whose seed is final came back as misses: fold it back in
        # (seed_prim is -1 where the seed missed or the lane is invalid)
        t = torch.where(prim >= 0, t, seed_t.float())
        prim = torch.where(prim >= 0, prim, seed_prim.to(torch.int32))
        t = torch.where(prim >= 0, t, float("inf"))
    return WaveTraceResult(t, prim, dropped)
