"""Closest-hit / shadow BVH traversal: the DFS kernel and its plain version.

The port of ``cuda_raytracer_tpu/ops/pallas/packet_dfs.py``.  The TPU
kernel (``_dfs_kernel``) walks one depth-first traversal per packet of
1024 rays with union descent, because the TPU's vector unit wants 1024
lanes in lockstep.  Its Hopper counterpart (ops/csrc/packet_dfs.cu) is
the simple right design for a GPU: one thread per ray, each with its own
node stack.  Both return the closest hit and, for shadow rays, the same
pass/fail decision; the .cu file's header lists the semantics kept.

* ``trace_closest_packets`` — the wrapper (the JAX function's name and
  contract): launches the kernel for CUDA tensors or runs the plain
  version for CPU tensors.
* ``dfs_trace_cuda`` — the kernel's launch; ``launches`` counts it.
* ``dfs_trace_plain`` — the same per-ray DFS as vectorized torch ops (a
  [N, STACK_CAP] stack, one pop per live ray per step), in the kernel's
  visit order and op order, so the two agree bit for bit.

Both take the rays as they come (o, d [N, 3], valid [N], t_limit [N] or
None) and return (t [N] f32, inf on a miss; prim [N] int32, -1 on a
miss; dropped, a 0-d int64 count).

The kernel builds at first use with nvcc into ``_build/`` beside the
package (see ``_load_library``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

from .intersect import packed_prim_test

#: the JAX package's packet size; accepted by the wrapper and ignored
#: (the kernel has no packets)
C = 1024
#: finite "no limit" initial bound (must not be inf: inf*0 = nan)
T_NO_LIMIT = 1e30
#: per-ray stack depth (a W-wide tree of depth D needs D*(W-1)+1); the
#: kernel is built with the same value, and an overflow is counted in
#: ``dropped``, never written past
STACK_CAP = 64
MAX_VISITS = 1 << 20

#: kernel launches since the count was last set to 0
launches = 0

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_lib = None


class WaveTraceResult(NamedTuple):
    t: torch.Tensor  # [N] f32, inf on a miss
    prim: torch.Tensor  # [N] int32, -1 on a miss
    dropped: torch.Tensor  # 0-d int64: live rays cut off (visit cap/stack)


def nvcc_command(src: str, out: str):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
        f"-DSTACK_CAP={STACK_CAP}", "-o", out, src,
    ]


def _load_library():
    """Build ops/csrc/packet_dfs.cu (once per source and flags) and load
    it.  Raises if nvcc fails; there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_CSRC, "packet_dfs.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(nvcc_command("", "")).encode()
        ).hexdigest()[:16]
    so = os.path.join(_BUILD, f"packet_dfs_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            nvcc_command(src, tmp), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    fn = lib.packet_dfs_trace
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_inputs(o, d, valid, t_limit, node_rows, prim_rows, meta,
                  width):
    if not 1 <= width <= 8:
        raise ValueError(f"packet-DFS supports tree_width <= 8, got {width}")
    n = o.shape[0]
    for name, x, dt, shape in (
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("valid", valid, torch.bool, (n,)),
        ("t_limit", t_limit, torch.float32, (n,)),
        ("node_rows", node_rows, torch.float32, (node_rows.shape[0], 8)),
        ("prim_rows", prim_rows, torch.float32, (prim_rows.shape[0], 16)),
        ("meta", meta, torch.int32, (node_rows.shape[0] // 2,)),
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
    if node_rows.shape[0] % 8:
        raise ValueError("node_rows must hold whole 8-slot nodes")
    if prim_rows.shape[0] % 8:
        raise ValueError("prim_rows must hold whole 8-prim groups")


def dfs_trace_cuda(o, d, valid, t_limit, node_rows, prim_rows, meta,
                   width: int, kill_eps: float):
    """Launch the kernel on the current stream; returns (t, prim,
    dropped).  ``t_limit`` None is a closest-hit trace, else a shadow
    trace."""
    global launches
    _check_inputs(o, d, valid, t_limit, node_rows, prim_rows, meta, width)
    if o.device.type != "cuda":
        raise ValueError("dfs_trace_cuda needs CUDA tensors")
    lib = _load_library()
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    dropped = torch.zeros((), dtype=torch.int64, device=o.device)
    err = lib.packet_dfs_trace(
        o.data_ptr(), d.data_ptr(), valid.data_ptr(),
        None if t_limit is None else t_limit.data_ptr(),
        node_rows.data_ptr(), prim_rows.data_ptr(), meta.data_ptr(),
        t.data_ptr(), prim.data_ptr(), dropped.data_ptr(), n, width,
        float(kill_eps), torch.cuda.current_stream(o.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"packet_dfs kernel launch failed: cuda error {err}")
    if n:  # the C side launches nothing for an empty batch
        launches += 1
    return t, prim, dropped


def dfs_trace_plain(o, d, valid, t_limit, node_rows, prim_rows, meta,
                    width: int, kill_eps: float, stats: dict = None):
    """The kernel's per-ray DFS in plain torch ops (any device).

    Each step pops one node for every ray still traversing, slab-tests
    its W children, pushes the hit inner children in reverse slot order
    and folds the hit leaf children's prim groups in slot order, exactly
    as the kernel's loop body does.  Returns (t, prim, dropped) like the
    kernel.  ``stats``, if given, gets the work this data needs (the
    counts a roofline bound needs): node ``visits``, ``boxes`` (tests of
    non-empty child slots), and prim tests by type, ``tris`` and
    ``spheres`` (pad slots are no test).
    """
    _check_inputs(o, d, valid, t_limit, node_rows, prim_rows, meta, width)
    W = width
    dev = o.device
    n = o.shape[0]
    do_kill = t_limit is not None
    o_x, o_y, o_z = o.unbind(1)
    d_x, d_y, d_z = d.unbind(1)
    tub0 = (torch.clamp_max(t_limit, T_NO_LIMIT) if do_kill
            else torch.full((n,), T_NO_LIMIT, dtype=torch.float32,
                            device=dev))
    tub0 = torch.where(valid, tub0, -1.0)
    inv_x, inv_y, inv_z = 1.0 / d_x, 1.0 / d_y, 1.0 / d_z
    kill_lim = tub0 - kill_eps

    tub = tub0.clone()
    best = torch.full((n,), T_NO_LIMIT, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    stack = torch.zeros((n, STACK_CAP), dtype=torch.int64, device=dev)
    sp = (tub0 >= 0.0).long()  # the root, for live rays
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
        node = stack[idx, spa]
        blk = rows[node]  # [A, W, 8]
        if stats is not None:
            _count(stats, "visits", idx.numel())
            _count(stats, "boxes", (blk[..., 0] <= blk[..., 3]).sum())
        ox, oy, oz = o_x[idx, None], o_y[idx, None], o_z[idx, None]
        ix, iy, iz = inv_x[idx, None], inv_y[idx, None], inv_z[idx, None]
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
        m = (tn <= tf) & (tf >= 0.0) & (tn <= ta[:, None])  # [A, W]
        ibase, icnt = meta4[node, 0], meta4[node, 1]

        # inner children, reverse slot order so slot 0 pops first
        for w in range(W - 1, -1, -1):
            push = (w < icnt) & m[:, w]
            fits = spa < STACK_CAP
            overflow[idx[push & ~fits]] = True
            do = push & fits
            stack[idx[do], spa[do]] = ibase[do] + w
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
                ptype = torch.where(gv[..., None], rec[..., 12], -1.0)
                _count(stats, "tris", ((ptype > -0.5) & (ptype <= 0.5)).sum())
                _count(stats, "spheres", (ptype > 0.5).sum())
            r = idx[ja]
            ok, t = packed_prim_test(
                o_x[r, None, None], o_y[r, None, None], o_z[r, None, None],
                d_x[r, None, None], d_y[r, None, None], d_z[r, None, None],
                *(rec[..., k] for k in range(13)),
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
) -> WaveTraceResult:
    """Closest-hit / shadow traversal of N rays (o, d: [N, 3] f32;
    valid: [N] bool).

    Returns t (inf on a miss), prim (-1 on a miss) and dropped (live
    rays cut off by the visit cap or a stack overflow — such rays may
    have lost hits; surfaced rather than silent).  Shadow passes
    (t_limit given) never record hits beyond the limit and stop a ray
    once a hit lands kill_eps short of it, so the pass condition
    ``t > maxT - eps`` decides as a full closest-hit trace would.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain version.  ``packet_size`` is accepted for the JAX
    signature and ignored: the kernel traces one ray per thread.
    """
    del packet_size
    bvh = scene.bvh
    args = (o.float().contiguous(), d.float().contiguous(),
            valid.bool().contiguous(),
            None if t_limit is None else t_limit.float().contiguous(),
            bvh.dfs_node_rows, bvh.dfs_prim_rows, bvh.node_meta, bvh.width,
            kill_eps)
    if o.device.type == "cuda":
        return WaveTraceResult(*dfs_trace_cuda(*args))
    if o.device.type == "cpu":
        return WaveTraceResult(*dfs_trace_plain(*args))
    raise ValueError(f"no packet-DFS path for device {o.device}")
