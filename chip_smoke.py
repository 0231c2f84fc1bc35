#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
main path at full size, checks the card against the CPU per pixel, and
prints one JSON line for the kernels and, last, the device line.  Phases:

1. set-up: the card's name and power limit, nvcc's version, the build of
   packet_dfs.cu, partition.cu and wavefront2.cu (one nvcc each, started
   together) and what ptxas reports for each kernel (registers, stack
   frame, spills, shared memory);
2. the packet-DFS kernel against its plain version on 262,144 rays of
   terrain n=121 (28,800 tris): hit/miss, prim and t bit-equal, shadow
   decisions equal, dropped == 0; kernel, plain and bound times; and the
   partition kernel (ray form and payload form), the count and pack
   kernels and the whole wavefront trace on the same rays, as in phase 3;
3. the main path at full size: the fast preset as shipped (packet-DFS at
   depths 0-1, the compacted wavefront at the roulette depths 2-3),
   800x600, depth 4, NEE 1x1.0 per depth — run A is bench.py's
   configuration and procedural scene (Cornell box with spheres, one
   leaf: 2 frames of 32 spp), run B terrain n=121 seen from above so it
   fills the frame (1 frame of 32 spp; six wavefront levels); the launch
   counts of all four kernels must equal what the scene's schedule
   gives (the payload form of the partition is off the main path: 0).
   Then run B once more with traversal_rr="dfs" (every trace through
   packet-DFS), for the two frame times side by side.  Then every kernel
   against its plain version on the runs' own traces: the DFS kernel on
   15,360,000-lane traces; both partition forms, and the count and pack
   kernels level by level, on run B's depth-2 closest-hit and shadow
   traces; and the whole wavefront trace against the DFS kernel on the
   same rays;
4. the same small frames on the card and on the CPU, per pixel: the
   Cornell box, and terrain n=8 under max_leaf_size=4 (three levels).

Needs one CUDA card; exits non-zero (and prints no result) without one,
or when run outside a checkout of the repository.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: float operations the traversal needs, counted from ops/intersect.py's
#: packed_prim_test and the slab test (adds, products, divisions, sqrt,
#: min/max, compares): per non-empty child box, per triangle test, per
#: sphere test (a prim is tested by its own type only; pads cost
#: nothing), and per ray (the three reciprocals of d)
BOX_FLOPS = 25
TRI_FLOPS = 38
SPH_FLOPS = 37
RAY_FLOPS = 3

#: the main path's device (the script checks there is a card)
DEVICE = "cuda"
N_RAYS = 262_144
WIDTH, HEIGHT = 800, 600
PIXEL_RTOL, PIXEL_ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
#: camera (origin, look-at) of run A (bench.py's fallback viewpoint) and
#: of run B (above the terrain, which then fills the frame)
VIEW_A = ([0, 0.75, 2.5], [0, 0.75, 0])
VIEW_B = ([0, 1.3, 1.3], [0, 0, 0])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fast_config(**over):
    """bench.py's configuration: the fast preset as shipped."""
    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs

    kw = fast_preset_kwargs(WIDTH, HEIGHT, 64)
    kw.update(**over)
    return RenderConfig(width=WIDTH, height=HEIGHT, total_samples=64,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


#: the kernels: name -> (module of its wrapper, its launch counter there)
COUNTERS = {
    "packet_dfs": ("packet_dfs", "launches"),
    "partition_rays": ("partition", "ray_launches"),
    "partition": ("partition", "launches"),
    "wf2_count": ("wavefront2", "count_launches"),
    "wf2_pack": ("wavefront2", "pack_launches"),
}
#: kernels the main path does not launch (the partition's payload form,
#: kept for whole-depth compaction); held on the card all the same
OFF_PATH = ("partition",)


def _ops_module(name):
    import importlib

    return importlib.import_module(f"cuda_raytracer_tpu_torch.ops.{name}")


def reset_launches():
    for mod, attr in COUNTERS.values():
        setattr(_ops_module(mod), attr, 0)


def read_launches():
    return {k: getattr(_ops_module(mod), attr)
            for k, (mod, attr) in COUNTERS.items()}


def phase_setup():
    from cuda_raytracer_tpu_torch.ops import _build, packet_dfs, partition
    from cuda_raytracer_tpu_torch.ops import wavefront2

    print(f"[setup] card: {smi_line()}")
    nvcc = _build.nvcc_command("", "")[0]
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"[setup] nvcc: {ver[-1]}")
    t0 = time.perf_counter()
    _build.build_all([("packet_dfs", packet_dfs.build_defines()),
                      ("partition", ()), ("wavefront2", ())])
    packet_dfs._load_library()
    partition._load_library()
    wavefront2._load_library()
    print(f"[setup] packet_dfs.cu, partition.cu and wavefront2.cu built "
          f"(one nvcc each, in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, defines in (("packet_dfs", packet_dfs.build_defines()),
                          ("partition", ()), ("wavefront2", ())):
        for line in _build.ptxas_report(name, defines):
            print(f"[setup] ptxas, {name}.cu: {line}")


def terrain_ray_set(dev):
    """262,144 rays on terrain n=121: camera rays of the slice, random
    incoherent rays and invalid lanes (closest-hit set), plus shadow
    rays from the camera hits toward the area light."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import shade as S
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(), device=dev)
    r.load_static_scene(terrain_scene(n=121))
    r.setup()
    scene = r.scene
    n_cam, n_inv = N_RAYS // 2, N_RAYS // 32
    n_rnd = N_RAYS - n_cam - n_inv
    o_c, d_c = S.generate_camera_rays(
        rng.PRNGKey(7), 512, n_cam // 512, 1, r.camera.pos, r.camera.c2w,
        math.tan(math.radians(r.camera.hFov) / 2),
        math.tan(math.radians(r.camera.vFov) / 2),
        pix_order="tiles32s", device=dev,
    )
    g = np.random.default_rng(11)
    o_r = g.uniform([-1.0, -0.2, -1.0], [1.0, 0.6, 1.0], (n_rnd + n_inv, 3))
    d_r = g.standard_normal((n_rnd + n_inv, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, dtype=torch.float32,
                                         device=dev)])
    d = torch.cat([d_c, torch.as_tensor(d_r, dtype=torch.float32,
                                         device=dev)])
    valid = torch.arange(N_RAYS, device=dev) < n_cam + n_rnd

    # shadow rays: camera hits of the closest set toward the light
    res = packet_dfs.trace_closest_packets(scene, o, d, valid)
    hit = S.compute_hits(scene, o, d, res.t, res.prim)
    u = torch.as_tensor(g.random((N_RAYS, 2)), dtype=torch.float32,
                        device=dev)
    o_s, d_s, max_t, _, _ = S.nee_shadow_rays(
        scene, hit, torch.ones_like(o), 0, u, 1.0
    )
    return scene, (o, d, valid, None), (o_s, d_s, hit.valid, max_t)


def _plain_chunked(args, chunk, stats):
    """The plain version over chunks of the rays (rays are independent,
    so the result is the same; it bounds the plain version's [N, stack]
    stack and leaf temporaries at main-path sizes)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs

    rays, tables = args[:4], args[4:]
    parts = [
        packet_dfs.dfs_trace_plain(
            *(None if x is None else x[i:i + chunk] for x in rays),
            *tables, stats=stats)
        for i in range(0, rays[0].shape[0], chunk)
    ]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            sum(p[2] for p in parts))


def measure_kernel(label, scene, rays, chunk=1 << 20):
    """The kernel against its plain version on one ray set (o, d, valid,
    t_limit): hit/miss, prim and t bit-equal, shadow decisions equal,
    dropped == 0.  Then kernel time (CUDA events), plain time (host
    clock) and the bound from these rays' bytes and the work this data
    needs, as the plain version counted it."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs

    b = scene.bvh
    rays = tuple(None if x is None else x.contiguous() for x in rays)
    args = (*rays, b.dfs_node_rows, b.dfs_prim_rows, b.node_meta, b.width,
            1e-3, packet_dfs.stack_entries(b))
    max_t = rays[3]
    tk, pk, dropped = packet_dfs.dfs_trace_cuda(*args)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp, pp, dropped_plain = _plain_chunked(args, chunk, stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hm = int(((pk < 0) != (pp < 0)).sum())
    prim_bad = int((pk != pp).sum())
    t_bad = int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
    both = (pk >= 0) & (pp >= 0)
    err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    ulp = ((tk.view(torch.int32).long() - tp.view(torch.int32).long())
           .abs()[both])
    max_ulp = int(ulp.max()) if ulp.numel() else 0
    dropped, dropped_plain = int(dropped), int(dropped_plain)
    n = rays[0].shape[0]
    print(f"[kernel] {label}: {n} rays, hit/miss mismatches {hm}, prim "
          f"mismatches {prim_bad}, t bit mismatches {t_bad}, max ulp gap "
          f"{max_ulp}, max |dt| {err}, dropped {dropped} (plain "
          f"{dropped_plain}), hits {int((pk >= 0).sum())}")
    check(hm == 0 and prim_bad == 0 and t_bad == 0,
          f"{label}: kernel disagrees with its plain version")
    check(dropped == 0 and dropped_plain == 0, f"{label}: dropped rays")
    if max_t is not None:
        eps = 1e-3
        dec_bad = int(((tk > max_t - eps) != (tp > max_t - eps)).sum())
        print(f"[kernel] {label}: shadow decisions differing: {dec_bad}")
        check(dec_bad == 0, f"{label}: shadow decisions differ")

    ms = cuda_time_ms(lambda: packet_dfs.dfs_trace_cuda(*args), 5)
    # each input read once, each output (t, prim, dropped) written once
    nbytes = sum(x.numel() * x.element_size()
                 for x in args[:7] if x is not None) + 8 * n + 8
    flops = (stats["boxes"] * BOX_FLOPS + stats["tris"] * TRI_FLOPS
             + stats["spheres"] * SPH_FLOPS + n * RAY_FLOPS)
    bytes_ms = nbytes / HBM_BPS * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[kernel] {label}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.5f} ms, {bound_ms / ms:.3f} of it reached "
          f"(bytes {nbytes} -> {bytes_ms:.5f} ms; {flops} flops from "
          f"{stats['visits']} visits ({stats['visits'] / n:.3f} per ray, "
          f"stack {args[-1]}), {stats['boxes']} box tests, "
          f"{stats['tris']} triangle and {stats['spheres']} sphere tests "
          f"-> {ops_ms:.5f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms > ops_ms else "operations",
                max_abs_err=err)


def phase_kernel(dev):
    """The DFS kernel on the terrain ray sets; then, on the same rays
    (a dense population with a deep descent, which the main path's
    roulette-thinned traces are not), the partition, count and pack
    kernels against their plain versions and the whole wavefront trace
    against the DFS kernel."""
    scene, closest, shadow = terrain_ray_set(dev)
    a = measure_kernel("terrain closest-hit", scene, closest)
    b = measure_kernel("terrain shadow", scene, shadow)
    for label, rays in (("terrain closest-hit", closest),
                        ("terrain shadow", shadow)):
        measure_partition(label, rays)
        measure_wavefront(label, scene, rays)
        compare_traces(label, scene, rays)
    return max(a["max_abs_err"], b["max_abs_err"])


def expected_launches(r, frames):
    """Launches per kernel that ``frames`` frames must make, from the
    config's pass classes and the scene's wavefront schedule: a depth
    makes one closest-hit trace and one shadow trace per NEE sample and
    light; a DFS trace is one launch; a wavefront trace is one
    partition, one pack per level it visits and one count per level
    that has inner children."""
    cfg, bvh = r.config, r.scene.bvh
    inner = [lv.has_inner for lv in bvh.wf_levels]
    n_pack = inner.index(False) + 1 if False in inner else len(inner)
    n_count = sum(inner[:n_pack])
    want = dict.fromkeys(COUNTERS, 0)
    for depth in range(cfg.max_depth):
        num_nee = (cfg.nee_schedule[depth][0]
                   if depth < len(cfg.nee_schedule) else 0)
        traces = 1 + num_nee * r.scene.num_lights
        rr = cfg.rr_start_depth and depth >= cfg.rr_start_depth
        kind = cfg.traversal
        if depth:
            kind = cfg.traversal_secondary or kind
        if rr:
            kind = cfg.traversal_rr or kind
        if kind in ("dfs", "auto"):
            want["packet_dfs"] += traces
        else:
            want["partition_rays"] += (traces if rr and cfg.compact_secondary
                                       else 0)
            want["wf2_pack"] += traces * n_pack
            want["wf2_count"] += traces * n_count
    return {k: v * frames for k, v in want.items()}


def run_slice(label, scene_fn, frames, viewpoint=None, **over):
    """Drive the main path (warm-up frame, then ``frames`` counted
    frames) under fast_config(**over).  Returns a dict: the counted
    ``launches`` per kernel, the renderer ``r``, ``ms`` per frame, and
    the rays (o, d, valid, t_limit) of the warm-up frame's first DFS
    closest-hit trace (``dfs[True]``) and shadow trace (``dfs[False]``)
    and first wavefront closest-hit and shadow trace (``wf``)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(**over), camera_mode="collada",
                          device=DEVICE)
    t0 = time.perf_counter()
    r.load_static_scene(scene_fn())
    load_s = time.perf_counter() - t0
    if viewpoint is not None:
        r.set_viewpoint(*viewpoint)
    # warm-up frame (allocator, first launches); keeps the inputs of the
    # first closest-hit and first shadow trace of each traversal
    seen_dfs, seen_wf = {}, {}
    launch, trace_wf = packet_dfs.dfs_trace_cuda, backends.trace_closest_wavefront

    def keep_dfs(*args):
        seen_dfs.setdefault(args[3] is None, args[:4])
        return launch(*args)

    def keep_wf(scene, o, d, valid, t_limit, *args, **kw):
        seen_wf.setdefault(t_limit is None, (o, d, valid, t_limit))
        return trace_wf(scene, o, d, valid, t_limit, *args, **kw)

    packet_dfs.dfs_trace_cuda = keep_dfs
    backends.trace_closest_wavefront = keep_wf
    try:
        r.render()
    finally:
        packet_dfs.dfs_trace_cuda = launch
        backends.trace_closest_wavefront = trace_wf
    r._reset_accumulation()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    dropped = 0
    for _ in range(frames):
        r.render()
        dropped += r.dropped
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()

    img = r.get_image()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mrays = r.mrays_per_frame * frames / elapsed
    want = expected_launches(r, frames)
    levels = [len(lv[0]) for lv in r.scene.bvh.wf_sched]
    print(f"[slice {label}] traversal_rr={r.config.traversal_rr!r}, "
          f"{r.scene.num_prims} prims, wavefront segments per level "
          f"{levels}, flatten {load_s:.2f} s, {frames} frame(s) of "
          f"{r.config.samples_per_frame} spp: {mrays:.3f} Mrays/s, "
          f"{elapsed / frames * 1e3:.1f} ms/frame, dropped {dropped}, image "
          f"mean {float(img.mean()):.6f}, finite "
          f"{bool(np.isfinite(img).all())}, peak device memory {peak:.2f} "
          f"GiB, launches {launches} (want {want})")
    check(img.shape == (HEIGHT, WIDTH, 3), "image shape")
    check(bool(np.isfinite(img).all()), f"run {label}: non-finite image")
    check(float(img.mean()) > 0.0, f"run {label}: black image")
    check(dropped == 0, f"run {label}: dropped rays")
    check(r.traces_per_frame == 8, f"run {label}: traces per frame")
    check(launches == want, f"run {label}: kernel launches {launches} != "
          f"the schedule's {want}")
    return dict(launches=launches, r=r, ms=elapsed / frames * 1e3,
                dfs=seen_dfs, wf=seen_wf)


def _host_ms(fn):
    """Host-clock time of fn() on the card, synchronised both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BPS * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms)


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def measure_partition(label, rays):
    """Both forms of the partition kernel against their plain versions on
    one captured trace's rays: n_live equal, the live prefix equal to the
    bit (past it both leave entries undefined).  Payload form: on
    make_payload's [N, 8] payload, timed beside the one PyTorch call that
    computes the same function (boolean-mask indexing; used nowhere in
    the port).  Ray form: on the rays, timed beside what it replaces on
    the main path, make_payload and the payload form.  Returns
    {"payload": row, "rays": row}."""
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    rays = tuple(None if x is None else x.contiguous() for x in rays)
    payload = wf.make_payload(*rays)
    n, rows = payload.shape
    out = {}
    for form, launch, plain, inputs in (
        ("payload", partition.partition_cuda, partition.partition_plain,
         (payload,)),
        ("rays", partition.partition_rays_cuda, partition.compact_rays_plain,
         rays),
    ):
        q_k, n_k = launch(*inputs)
        (q_p, n_p), plain_ms = _host_ms(lambda: plain(*inputs))
        k = int(n_k)
        bad = int((q_k[:k].view(torch.int32)
                   != q_p[:k].view(torch.int32)).sum())
        err = float((q_k[:k] - q_p[:k]).abs().max()) if k else 0.0
        print(f"[kernel] partition ({form}), {label}: {n} entries, n_live "
              f"{k} (plain {int(n_p)}), {bad} words of the live prefix "
              f"differ")
        check(k == int(n_p) and bad == 0,
              f"partition ({form}), {label}: kernel disagrees with its "
              f"plain version")
        ms = cuda_time_ms(lambda: launch(*inputs), 10)
        if form == "payload":
            other = "boolean-mask call"
            other_ms = cuda_time_ms(lambda: payload[payload[:, 7] >= 0.0], 10)
            # every entry read once, every live entry and n_live written
            nbytes = (n + k) * rows * 4 + 4
        else:
            other = "make_payload + payload form"
            other_ms = cuda_time_ms(
                lambda: partition.partition_cuda(wf.make_payload(*rays)), 10)
            # valid (and t_limit) of every lane, o and d of the live lanes
            # read once; the live entries and n_live written
            nbytes = n * (1 + (4 if rays[3] is not None else 0)) \
                + k * (24 + 32) + 4
        b = _bound(nbytes, 0)
        print(f"[kernel] partition ({form}), {label}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, {other} {other_ms:.4f} ms, bound "
              f"{b['bound_ms']:.5f} ms (bytes), {b['bound_ms'] / ms:.3f} of "
              f"it reached")
        out[form] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         n_live=k, other_ms=other_ms,
                         library_ms=other_ms if form == "payload" else None,
                         **b)
    return out


def _sorted_regions(queue, seg_base, total):
    """The first ``total`` entries ordered by (region, ray id): entries
    of one region are one node's, so a ray is there at most once."""
    import torch

    pos = torch.arange(total, dtype=torch.int32, device=queue.device)
    region = torch.searchsorted(seg_base[1:].contiguous(), pos, right=True)
    rid = queue[:total].view(torch.int32)[:, 6].long()
    return queue[:total][torch.argsort(region * (1 << 32) + rid)]


def measure_wavefront(label, scene, rays):
    """The count and pack kernels against their plain versions, level by
    level, on one captured trace (compacted, as the main path runs it):
    counts equal exactly; after pack the ray keys (hits) equal to the
    bit, the region cursors equal, and the next queue equal as a set of
    entries per region (ranks come from atomic cursors, so both sides
    are sorted by ray id within a region first).  Every level is timed;
    the level with the most entries gives the JSON line's numbers."""
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bvh = scene.bvh
    W = bvh.width
    node_rows, prim_rows = bvh.wf_node_rows, scene.wf_prim_rows
    do_kill = rays[3] is not None
    n = rays[0].shape[0]
    cap = wf.queue_capacity(n + (-n) % wf.CHUNK, 2, bvh.wf_sched)
    queue, n_live = partition.partition_rays_cuda(
        *(None if x is None else x.contiguous() for x in rays))
    seg_base = torch.stack([torch.zeros_like(n_live), n_live])
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64, device=DEVICE)
    dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    bound = n
    best = None
    sums = dict(count_ms=0.0, pack_ms=0.0, count_plain=0.0, pack_plain=0.0,
                count_bound=0.0, pack_bound=0.0)
    for lvl, lv in enumerate(bvh.wf_levels):
        total = int(seg_base[-1])
        # the level's schedule and the table rows it refers to, once each:
        # one node row per segment, 64 B per prim of its leaf children
        tables = (_nbytes(seg_base, lv.seg_node, lv.child)
                  + lv.num_segs * node_rows.shape[1] * 4)
        leaf_prims = int(lv.child[lv.child[:, 0] == 2, 2].sum())
        row = dict(level=lvl, entries=total)
        if lv.has_inner:
            counts = wf.count_cuda(queue, seg_base, lv, node_rows, W, bound)
            cstats = {}
            counts_p, row["count_plain_ms"] = _host_ms(
                lambda: wf.count_plain(queue, seg_base, lv, node_rows, W,
                                       stats=cstats))
            row["count_err"] = int((counts - counts_p).abs().max())
            check(row["count_err"] == 0,
                  f"count, {label} level {lvl}: kernel disagrees with its "
                  f"plain version")
            row["count_ms"] = cuda_time_ms(
                lambda: wf.count_cuda(queue, seg_base, lv, node_rows, W,
                                      bound), 5)
            # entries, schedule and node rows read once, counts written
            row["count_bound"] = _bound(
                total * 32 + tables + counts.numel() * 4,
                cstats.get("boxes", 0) * BOX_FLOPS + total * RAY_FLOPS)
            seg_base_next, route, cursor0, lost = wf.plan_regions(
                counts, lv, cap)
            check(int(lost) == 0, f"{label} level {lvl}: queue overflow")
            total_next = int(seg_base_next[-1])
        else:
            seg_base_next, total_next = None, 0
            route = torch.full((lv.num_segs * W,), -1, dtype=torch.int32,
                               device=DEVICE)
            cursor0 = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        out_rows = max(total_next, 1)
        out_k = torch.empty((out_rows, 8), dtype=torch.float32, device=DEVICE)
        out_p = torch.empty_like(out_k)
        cur_k, cur_p = cursor0.clone(), cursor0.clone()
        keys_k, keys_p = keys.clone(), keys.clone()

        def pack(fn, cur, out, ks, **kw):
            return fn(queue, seg_base, lv, route, cur, node_rows, prim_rows,
                      W, do_kill, 1e-3, out, ks, dropped, bound, **kw)

        pack(wf.pack_cuda, cur_k, out_k, keys_k)
        pstats = {}
        _, row["pack_plain_ms"] = _host_ms(
            lambda: pack(wf.pack_plain, cur_p, out_p, keys_p, stats=pstats))
        key_bad = int((keys_k != keys_p).sum())
        cur_bad = int((cur_k != cur_p).sum())
        q_bad = 0
        if total_next:
            a = _sorted_regions(out_k, seg_base_next, total_next)
            b = _sorted_regions(out_p, seg_base_next, total_next)
            q_bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        tk, _ = wf.decode_keys(keys_k)
        tp, _ = wf.decode_keys(keys_p)
        hit = torch.isfinite(tp)
        row["pack_err"] = (float((tk - tp)[hit].abs().max())
                           if bool(hit.any()) else 0.0)
        check(key_bad == 0 and cur_bad == 0 and q_bad == 0,
              f"pack, {label} level {lvl}: kernel disagrees with its plain "
              f"version ({key_bad} keys, {cur_bad} cursors, {q_bad} queue "
              f"words)")
        check(int(dropped) == 0, f"pack, {label} level {lvl}: dropped")
        scratch = cursor0.clone()

        def timed_pack():
            scratch.copy_(cursor0)
            pack(wf.pack_cuda, scratch, out_k, keys_k)

        row["pack_ms"] = cuda_time_ms(timed_pack, 5)
        # entries, schedule, node and prim rows read once; survivors, hit
        # keys and region cursors written
        row["pack_bound"] = _bound(
            total * 32 + tables + _nbytes(route, cursor0) + leaf_prims * 64
            + pstats.get("survivors", 0) * 32 + pstats.get("hits", 0) * 8,
            pstats.get("boxes", 0) * BOX_FLOPS
            + pstats.get("tris", 0) * TRI_FLOPS
            + pstats.get("spheres", 0) * SPH_FLOPS + total * RAY_FLOPS)
        print(f"[kernel] wavefront, {label}, level {lvl}: {lv.num_segs} "
              f"segments, {total} entries -> {total_next}; "
              + (f"count {row['count_ms']:.4f} ms (plain "
                 f"{row['count_plain_ms']:.1f} ms, bound "
                 f"{row['count_bound']['bound_ms']:.5f} ms by "
                 f"{row['count_bound']['bound_by']}), "
                 if lv.has_inner else "no count, ")
              + f"pack {row['pack_ms']:.4f} ms (plain "
              f"{row['pack_plain_ms']:.1f} ms, bound "
              f"{row['pack_bound']['bound_ms']:.5f} ms by "
              f"{row['pack_bound']['bound_by']}); work {pstats}")
        sums["pack_ms"] += row["pack_ms"]
        sums["pack_plain"] += row["pack_plain_ms"]
        sums["count_ms"] += row.get("count_ms", 0.0)
        sums["count_plain"] += row.get("count_plain_ms", 0.0)
        sums["pack_bound"] += row["pack_bound"]["bound_ms"]
        if lv.has_inner:
            sums["count_bound"] += row["count_bound"]["bound_ms"]
        if best is None or (lv.has_inner and total > best["entries"]):
            best = row
        if not lv.has_inner:
            break
        keys = keys_k
        queue, seg_base, bound = out_k, seg_base_next, cap
    print(f"[kernel] wavefront, {label}: all levels: count {sums['count_ms']:.4f}"
          f" ms (bound {sums['count_bound']:.5f} ms), pack "
          f"{sums['pack_ms']:.4f} ms (bound {sums['pack_bound']:.5f} ms); "
          f"plain versions {sums['count_plain']:.1f} and "
          f"{sums['pack_plain']:.1f} ms; all comparisons equal; the JSON line "
          f"takes level {best['level']} ({best['entries']} entries)")
    return best


def compare_traces(label, scene, rays):
    """The whole compacted wavefront trace against the DFS kernel on the
    same rays: hit/miss equal, t bit-equal (both run packed_prim_test in
    one op order without FMA contraction), prim equal except where two
    prims tie at a bit-equal t (the DFS keeps its first group's winner,
    the wavefront the largest prim), shadow decisions equal."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    o, d, valid, t_limit = rays
    a = wf.trace_closest_wavefront(scene, o, d, valid, t_limit, compact=True)
    b = packet_dfs.trace_closest_packets(scene, o, d, valid, t_limit)
    hm = int(((a.prim < 0) != (b.prim < 0)).sum())
    t_bad = int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum())
    ties = int(((a.prim != b.prim) & (a.prim >= 0)).sum())
    print(f"[trace] {label}: wavefront vs packet-DFS on {o.shape[0]} lanes "
          f"({int(valid.sum())} live): hit/miss mismatches {hm}, t bit "
          f"mismatches {t_bad}, prims differing at a bit-equal t {ties}, "
          f"hits {int((a.prim >= 0).sum())}, dropped {int(a.dropped)}")
    check(hm == 0 and t_bad == 0, f"{label}: wavefront and DFS disagree")
    check(int(a.dropped) == 0, f"{label}: dropped")
    if t_limit is not None:
        eps = 1e-3
        dec = int(((a.t > t_limit - eps) != (b.t > t_limit - eps)).sum())
        print(f"[trace] {label}: shadow decisions differing: {dec}")
        check(dec == 0, f"{label}: shadow decisions differ")
    ms_wf = cuda_time_ms(lambda: wf.trace_closest_wavefront(
        scene, o, d, valid, t_limit, compact=True,
        want_prim=t_limit is None), 3)
    ms_dfs = cuda_time_ms(lambda: packet_dfs.trace_closest_packets(
        scene, o, d, valid, t_limit), 3)
    print(f"[trace] {label}: whole trace {ms_wf:.3f} ms through the "
          f"wavefront, {ms_dfs:.3f} ms through packet-DFS")


def phase_slice():
    """Runs A and B as shipped, run B again with traversal_rr="dfs";
    then every kernel against its plain version on the runs' own traces
    (the main path's shapes).  Returns the JSON rows of the kernels."""
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    run_a = run_slice(
        "A cornell", lambda: cornell_box_scene(with_spheres=True), 2,
        viewpoint=VIEW_A,
    )
    run_b = run_slice("B terrain", lambda: terrain_scene(n=121), 1,
                      viewpoint=VIEW_B)
    run_b_dfs = run_slice("B terrain, roulette depths through DFS",
                          lambda: terrain_scene(n=121), 1, viewpoint=VIEW_B,
                          traversal_rr="dfs")
    print(f"[slice B] frame with the roulette depths through the wavefront "
          f"{run_b['ms']:.1f} ms, through packet-DFS {run_b_dfs['ms']:.1f} ms")
    for k in COUNTERS:
        if k not in OFF_PATH:
            check(run_b["launches"][k] > 0, f"run B never launched {k}")

    ra, rb = run_a["r"], run_b["r"]
    dfs = measure_kernel("run A camera trace", ra.scene, run_a["dfs"][True])
    measure_kernel("run A first shadow trace", ra.scene, run_a["dfs"][False])
    measure_kernel("run B camera trace", rb.scene, run_b["dfs"][True],
                   chunk=1 << 18)

    closest, shadow = run_b["wf"][True], run_b["wf"][False]
    part = measure_partition("run B depth-2 closest-hit trace", closest)
    measure_partition("run B depth-2 shadow trace", shadow)
    measure_partition("run A depth-2 closest-hit trace", run_a["wf"][True])
    measure_partition("run A depth-2 shadow trace", run_a["wf"][False])
    lvl = measure_wavefront("run B depth-2 closest-hit trace", rb.scene,
                            closest)
    lvl_s = measure_wavefront("run B depth-2 shadow trace", rb.scene, shadow)
    measure_wavefront("run A depth-2 closest-hit trace", ra.scene,
                      run_a["wf"][True])
    compare_traces("run B depth-2 closest-hit", rb.scene, closest)
    compare_traces("run B depth-2 shadow", rb.scene, shadow)
    compare_traces("run A depth-2 closest-hit", ra.scene, run_a["wf"][True])

    csrc = "cuda_raytracer_tpu_torch/ops/csrc/"
    tpu = "cuda_raytracer_tpu/ops/pallas/"
    launches = run_b["launches"]

    def row(name, source, replaces, k, err, library_ms=None):
        return dict(name=name, route="cuda", source=csrc + source,
                    replaces=tpu + replaces, launches=launches[name],
                    max_abs_err=err, ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                    library_ms=library_ms)

    return [
        row("packet_dfs", "packet_dfs.cu", "packet_dfs.py:99", dfs,
            dfs["max_abs_err"]),
        row("partition_rays", "partition.cu", "partition.py:38",
            part["rays"], part["rays"]["max_abs_err"]),
        row("partition", "partition.cu", "partition.py:38",
            part["payload"], part["payload"]["max_abs_err"],
            part["payload"]["library_ms"]),
        row("wf2_count", "wavefront2.cu", "wavefront2.py:262",
            dict(ms=lvl["count_ms"], plain_ms=lvl["count_plain_ms"],
                 **lvl["count_bound"]),
            float(max(lvl["count_err"], lvl_s["count_err"]))),
        row("wf2_pack", "wavefront2.cu", "wavefront2.py:377",
            dict(ms=lvl["pack_ms"], plain_ms=lvl["pack_plain_ms"],
                 **lvl["pack_bound"]),
            max(lvl["pack_err"], lvl_s["pack_err"])),
    ]


def phase_cpu_vs_cuda():
    """The shipped preset at 64x32 on the card and on the CPU: the
    Cornell box (one leaf), and terrain n=8 under max_leaf_size=4 (three
    wavefront levels, so count and routing are on the small frame's path
    too)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    w, h, spf, frames = 64, 32, 2, 2
    cases = (
        ("cornell", lambda: cornell_box_scene(with_spheres=True), VIEW_A, {}),
        ("terrain n=8, max_leaf_size=4", lambda: terrain_scene(n=8), VIEW_B,
         dict(max_leaf_size=4)),
    )
    for name, scene_fn, view, over in cases:
        kw = fast_preset_kwargs(w, h, spf * frames)
        kw.update(samples_per_frame=spf, **over)
        cfg = RenderConfig(width=w, height=h, total_samples=spf * frames,
                           max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)
        imgs = []
        for dev in (DEVICE, "cpu"):
            r = WavefrontRenderer(cfg, camera_mode="collada", device=dev)
            r.load_static_scene(scene_fn())
            r.set_viewpoint(*view)
            for _ in range(frames):
                r.render()
                check(r.dropped == 0, f"cpu-vs-cuda {name}: dropped")
            imgs.append(r.get_raw_image())
        a, b = imgs
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        print(f"[cpu-vs-cuda] {name}, traversal_rr={cfg.traversal_rr!r}, "
              f"{len(r.scene.bvh.wf_sched)} wavefront level(s), {w}x{h}, "
              f"{frames} frames of {spf} spp: {int(bad.sum())} of {w * h} "
              f"pixels outside rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max "
              f"|diff| {float(np.abs(a - b).max()):.3g}")
        check(float(bad.mean()) <= MAX_BAD,
              f"card and CPU frames differ ({name})")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cuda_raytracer_tpu_torch")):
        fail("run from a checkout of the repository (package missing)")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)

    phase_setup()
    err = phase_kernel(DEVICE)
    kernels = phase_slice()
    kernels[0]["max_abs_err"] = max(err, kernels[0]["max_abs_err"])
    phase_cpu_vs_cuda()

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
