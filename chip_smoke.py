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
   then the wavefront kernels and trace on the same kind of ray sets of
   terrain n=121 at tree width 8 and of terrain n=40 under
   max_leaf_size=64, whose segments with more leaf prims than the pack
   kernel stages in shared memory read them from global memory;
3. the main path at full size: the fast preset as shipped (packet-DFS at
   depths 0-1, the compacted wavefront at the roulette depths 2-3),
   800x600, depth 4, NEE 1x1.0 per depth — run A is bench.py's
   configuration and procedural scene (Cornell box with spheres, one
   leaf: 2 frames of 32 spp), run B terrain n=121 seen from above so it
   fills the frame (1 frame of 32 spp; six wavefront levels); the launch
   counts of all six kernels must equal what the scene's schedule
   gives (the payload form of the partition is off the main path: 0;
   one count per wavefront trace, on its level-0 queue, since each pack
   counts the level after it).  Then run B once more with
   traversal_rr="dfs" (every trace through packet-DFS), for the two
   frame times side by side.  Then every kernel against its plain
   version on the runs' own traces: the DFS kernel on 15,360,000-lane
   traces; both partition forms on run A's and run B's depth-2 traces;
   the count and pack kernels level by level (counts, keys, cursors, the
   next level's counts and each kernel's region plan exact, the next
   queue as sets per region) on run B's depth-2 closest-hit and shadow
   traces, run A's depth-2 closest-hit trace and run B's 15,360,000
   camera rays (all live, six levels); the whole wavefront trace against
   the DFS kernel on the same rays; and the decode kernel on two
   traces' 15,360,000 keys;
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


def cuda_time_ms(fn, reps: int, prep=None) -> float:
    """Device time of fn() per call: CUDA events around each call, behind
    a device sleep long enough for the host to queue every call, so no
    host gap between launches is timed.  prep() (not timed) runs before
    each call."""
    import torch

    if prep is not None:
        prep()
    fn()  # warm
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    evs = []
    for _ in range(reps):
        if prep is not None:
            prep()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


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
    "wf2_decode": ("wavefront2", "decode_launches"),
}
#: leaf prims a pack block stages in shared memory (WF_STAGE_PRIMS of
#: ops/csrc/wavefront2.cu); a segment with more reads them from global
WF_STAGE_PRIMS = 128
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


def terrain_ray_set(dev, n=121, **over):
    """262,144 rays on terrain n (fast_config(**over)): camera rays of
    the slice, random incoherent rays and invalid lanes (closest-hit
    set), plus shadow rays from the camera hits toward the area light."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import shade as S
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(**over), device=dev)
    r.load_static_scene(terrain_scene(n=n))
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
    # the widest tree the kernels take, and segments whose leaf prims do
    # not fit the pack kernel's staging buffer (terrain n=40 under
    # max_leaf_size=64: 14 segments of its level 2)
    for tag, n, over in (("W=8 terrain", 121, dict(tree_width=8)),
                         ("terrain n=40, max_leaf_size=64", 40,
                          dict(max_leaf_size=64))):
        scene_x, closest_x, shadow_x = terrain_ray_set(dev, n, **over)
        for label, rays in ((f"{tag} closest-hit", closest_x),
                            (f"{tag} shadow", shadow_x)):
            got = measure_wavefront(label, scene_x, rays)
            compare_traces(label, scene_x, rays)
            if "max_leaf_size" in over:
                check(got["n_global"] > 0, f"{label}: no segment read its "
                      f"leaf prims from global memory")
    return max(a["max_abs_err"], b["max_abs_err"])


def expected_launches(r, frames):
    """Launches per kernel that ``frames`` frames must make, from the
    config's pass classes and the scene's wavefront schedule: a depth
    makes one closest-hit trace and one shadow trace per NEE sample and
    light; a DFS trace is one launch; a wavefront trace is one
    partition, one count if it has a level with inner children (the
    level-0 queue's: each pack counts the level after it), one pack per
    level it visits and one decode of the keys."""
    cfg, bvh = r.config, r.scene.bvh
    inner = [lv.has_inner for lv in bvh.wf_levels]
    n_pack = inner.index(False) + 1 if False in inner else len(inner)
    n_count = int(inner[0])
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
            want["wf2_decode"] += traces
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


def _plan_tensors(n_slots, n_next):
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    def z(k):
        return torch.full((k,), -7, dtype=torch.int32, device=DEVICE)

    return wf.Plan(z(n_next + 1), z(n_next + 1), z(n_slots), z(n_next))


def _check_plan(where, plan, counts, lv, cap):
    """A region plan a kernel's last block made against plan_regions and
    tile_prefix of the same counts: every word equal.  Returns the
    entries it lost."""
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    sb, route, cursor, lost = wf.plan_regions(counts, lv, cap)
    bad = sum(int((a != b).sum()) for a, b in (
        (plan.seg_base, sb), (plan.route, route), (plan.cursor, cursor),
        (plan.tile_base, wf.tile_prefix(sb))))
    check(bad == 0, f"{where}: the kernel's region plan differs from "
          f"plan_regions in {bad} words")
    return int(lost)


def measure_wavefront(label, scene, rays):
    """The count and pack kernels against their plain versions, level by
    level, on one captured trace (compacted, as the main path runs it,
    and with fused counts: each pack counts the next level and plans
    it).  At every level with inner children the count kernel runs too
    (the main path runs it on the level-0 queue only): counts exact, and
    equal to what the previous pack counted for this level.  After each
    kernel its region plan (seg_base, tile_base, cursors, route) equals
    plan_regions of the plain counts, word for word.  After pack the ray
    keys (hits) equal to the bit, the region cursors and the next
    level's counts exact, and the next queue equal as a set of entries
    per region (ranks come from atomic cursors, so both sides are sorted
    by ray id within a region first).  Every level is timed.  Returns
    the level-0 row (count on the main path), the row of the inner level
    with the most entries, the sums and the final keys."""
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bvh = scene.bvh
    W = bvh.width
    levels = bvh.wf_levels
    node_rows, prim_rows = bvh.wf_node_rows, scene.wf_prim_rows
    row_bytes = node_rows.shape[1] * 4
    do_kill = rays[3] is not None
    n = rays[0].shape[0]
    cap = wf.queue_capacity(n + (-n) % wf.CHUNK, 2, bvh.wf_sched)
    queue, n_live = partition.partition_rays_cuda(
        *(None if x is None else x.contiguous() for x in rays))
    zero = torch.zeros_like(n_live)
    seg_base = torch.stack([zero, n_live]).reshape(2)
    tile_base = torch.stack([zero, torch.div(
        n_live + wf.TILE - 1, wf.TILE, rounding_mode="floor")]).reshape(2)
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64, device=DEVICE)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=DEVICE)

    bound = n
    plan = None  # this level's regions, once a pack has planned them
    counted = None  # this level's counts, as the previous pack made them
    rows, best, n_global = [], None, 0
    sums = dict(count_ms=0.0, pack_ms=0.0, count_plain=0.0, pack_plain=0.0,
                count_bound=0.0, pack_bound=0.0)
    for lvl, lv in enumerate(levels):
        total, tiles = int(seg_base[-1]), int(tile_base[-1])
        # the level's schedule and the table rows it refers to, once
        # each: one node row per segment, 64 B per prim of its leaf
        # children
        tables = (_nbytes(seg_base, tile_base, lv.seg_node, lv.child)
                  + lv.num_segs * row_bytes)
        leaf = torch.where(lv.child[:, 0] == 2, lv.child[:, 2], 0)
        leaf_prims = int(leaf.sum())
        over = int((leaf.view(-1, W).sum(1) > WF_STAGE_PRIMS).sum())
        n_global += over
        nxt = levels[lvl + 1] if lv.has_inner else None
        fuse = nxt is not None and nxt.has_inner
        row = dict(level=lvl, entries=total, idle=tiles * wf.TILE - total)
        if lv.has_inner:
            counts, ticket, drop_c = zeros(lv.num_segs * W), zeros(1), \
                zeros(dtype=torch.int64)
            plan_c = _plan_tensors(lv.num_segs * W, lv.num_next)
            cargs = (queue, seg_base, tile_base, lv, node_rows, W, bound,
                     counts, plan_c, cap, drop_c, ticket)
            wf.count_cuda(*cargs)
            cstats = {}
            counts_p, row["count_plain_ms"] = _host_ms(
                lambda: wf.count_plain(queue, seg_base, lv, node_rows, W,
                                       stats=cstats))
            row["count_err"] = int((counts - counts_p).abs().max())
            check(row["count_err"] == 0,
                  f"count, {label} level {lvl}: kernel disagrees with its "
                  f"plain version")
            lost = _check_plan(f"count, {label} level {lvl}", plan_c,
                               counts_p, lv, cap)
            check(lost == 0 and int(drop_c) == 0 and int(ticket) == 0,
                  f"count, {label} level {lvl}: lost {lost}, dropped "
                  f"{int(drop_c)}, ticket {int(ticket)}")
            if counted is not None:
                check(torch.equal(counted, counts_p),
                      f"pack, {label} level {lvl - 1}: its counts of this "
                      f"level differ from the count of the queue it wrote")
            else:
                plan = plan_c
            row["count_ms"] = cuda_time_ms(lambda: wf.count_cuda(*cargs), 5,
                                           prep=counts.zero_)
            # entries, schedule and node rows read once; counts and the
            # plan written
            row["count_bound"] = _bound(
                total * 32 + tables + _nbytes(lv.parent, lv.pair)
                + counts.numel() * 4 + _nbytes(*plan_c),
                cstats.get("boxes", 0) * BOX_FLOPS + total * RAY_FLOPS)
            total_next = int(plan.seg_base[-1])
            route, cursor0 = plan.route, plan.cursor.clone()
        else:
            total_next = 0
            route, cursor0 = lv.pair, zeros(1)
        out_k = torch.empty((max(total_next, 1), 8), dtype=torch.float32,
                            device=DEVICE)
        out_p = torch.empty_like(out_k)
        cur_k, cur_p = cursor0.clone(), cursor0.clone()
        keys_k, keys_p = keys.clone(), keys.clone()
        drop_k, drop_p = zeros(dtype=torch.int64), zeros(dtype=torch.int64)
        fused, counts_np = None, None
        if fuse:
            fused = wf.Fused(nxt, zeros(nxt.num_segs * W),
                             _plan_tensors(nxt.num_segs * W, nxt.num_next),
                             cap, zeros(1))
            counts_np = zeros(nxt.num_segs * W)

        def pack(cur, drop):
            wf.pack_cuda(queue, seg_base, tile_base, lv, route, cur,
                         node_rows, prim_rows, W, do_kill, 1e-3, out_k,
                         keys_k, drop, bound, fused)

        pack(cur_k, drop_k)
        pstats = {}
        _, row["pack_plain_ms"] = _host_ms(lambda: wf.pack_plain(
            queue, seg_base, lv, route, cur_p, node_rows, prim_rows, W,
            do_kill, 1e-3, out_p, keys_p, drop_p, stats=pstats,
            counts_next=counts_np, lv_next=nxt if fuse else None))
        key_bad = int((keys_k != keys_p).sum())
        cur_bad = int((cur_k != cur_p).sum())
        q_bad = cnt_bad = 0
        if total_next:
            a = _sorted_regions(out_k, plan.seg_base, total_next)
            b = _sorted_regions(out_p, plan.seg_base, total_next)
            q_bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if fuse:
            cnt_bad = int((fused.counts != counts_np).sum())
        tk, _ = wf.decode_plain(keys_k)
        tp, _ = wf.decode_plain(keys_p)
        hit = torch.isfinite(tp)
        row["pack_err"] = (float((tk - tp)[hit].abs().max())
                           if bool(hit.any()) else 0.0)
        check(key_bad == 0 and cur_bad == 0 and q_bad == 0 and cnt_bad == 0,
              f"pack, {label} level {lvl}: kernel disagrees with its plain "
              f"version ({key_bad} keys, {cur_bad} cursors, {q_bad} queue "
              f"words, {cnt_bad} next-level counts)")
        check(int(drop_k) == 0 and int(drop_p) == 0,
              f"pack, {label} level {lvl}: dropped")
        if fuse:
            lost = _check_plan(f"pack, {label} level {lvl}", fused.plan,
                               counts_np, nxt, cap)
            check(lost == 0 and int(fused.ticket) == 0,
                  f"pack, {label} level {lvl}: lost {lost}, ticket "
                  f"{int(fused.ticket)}")
        scratch, drop_t = cursor0.clone(), zeros(dtype=torch.int64)

        def prep():
            scratch.copy_(cursor0)
            if fuse:
                fused.counts.zero_()

        row["pack_ms"] = cuda_time_ms(lambda: pack(scratch, drop_t), 5,
                                      prep=prep)
        # entries, schedule, node and prim rows read once (and, counting
        # for the next level, its schedule and node rows); survivors, hit
        # keys, region cursors (and the next counts and plan) written
        fused_bytes = 0
        if fuse:
            fused_bytes = (_nbytes(nxt.seg_node, nxt.child, nxt.parent,
                                   nxt.pair, fused.counts, *fused.plan)
                           + nxt.num_segs * row_bytes)
        row["pack_bound"] = _bound(
            total * 32 + tables + _nbytes(route, cursor0) + leaf_prims * 64
            + pstats.get("survivors", 0) * 32 + pstats.get("hits", 0) * 8
            + fused_bytes,
            (pstats.get("boxes", 0) + pstats.get("fused_boxes", 0))
            * BOX_FLOPS + pstats.get("tris", 0) * TRI_FLOPS
            + pstats.get("spheres", 0) * SPH_FLOPS + total * RAY_FLOPS)
        print(f"[kernel] wavefront, {label}, level {lvl}: {lv.num_segs} "
              f"segments ({over} with more than {WF_STAGE_PRIMS} leaf prims), "
              f"{total} entries in {tiles} tiles ({row['idle']} idle lanes) "
              f"-> {total_next}; "
              + (f"count {row['count_ms']:.4f} ms (plain "
                 f"{row['count_plain_ms']:.1f} ms, bound "
                 f"{row['count_bound']['bound_ms']:.5f} ms by "
                 f"{row['count_bound']['bound_by']}), "
                 if lv.has_inner else "no count, ")
              + f"pack{' with fused counts' if fuse else ''} "
              f"{row['pack_ms']:.4f} ms (plain {row['pack_plain_ms']:.1f} ms, "
              f"bound {row['pack_bound']['bound_ms']:.5f} ms by "
              f"{row['pack_bound']['bound_by']}); work {pstats}")
        sums["pack_ms"] += row["pack_ms"]
        sums["pack_plain"] += row["pack_plain_ms"]
        sums["count_ms"] += row.get("count_ms", 0.0)
        sums["count_plain"] += row.get("count_plain_ms", 0.0)
        sums["pack_bound"] += row["pack_bound"]["bound_ms"]
        if lv.has_inner:
            sums["count_bound"] += row["count_bound"]["bound_ms"]
        rows.append(row)
        if best is None or (lv.has_inner and total > best["entries"]):
            best = row
        if not lv.has_inner:
            break
        keys = keys_k
        queue, seg_base, tile_base = out_k, plan.seg_base, plan.tile_base
        bound = cap
        plan, counted = (fused.plan, fused.counts) if fuse else (None, None)
    print(f"[kernel] wavefront, {label}: all levels: pack "
          f"{sums['pack_ms']:.4f} ms (bound {sums['pack_bound']:.5f} ms); "
          f"count {rows[0].get('count_ms', 0.0):.4f} ms on the level-0 queue "
          f"(the main path's), {sums['count_ms']:.4f} ms at every level "
          f"(bound {sums['count_bound']:.5f} ms); plain versions "
          f"{sums['count_plain']:.1f} and {sums['pack_plain']:.1f} ms; "
          f"{n_global} segments read leaf prims from global memory; all "
          f"comparisons equal; the JSON line takes level {best['level']} "
          f"({best['entries']} entries)")
    return dict(level0=rows[0], best=best, sums=sums, keys=keys,
                n_global=n_global)


def measure_decode(label, keys):
    """The decode kernel against its plain version on one trace's keys,
    with and without prim ids: t and prim equal to the bit.  Kernel and
    plain (torch ops on the card) times; the bound is 8 B read and 8 B
    written per key."""
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bad, errs = 0, [torch.zeros((), device=keys.device)]
    for want_prim in (True, False):
        tk, pk = wf.decode_cuda(keys, want_prim)
        tp, pp = wf.decode_plain(keys, want_prim)
        bad += int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
        bad += int((pk != pp).sum())
        fin = torch.isfinite(tp)
        if bool(fin.any()):
            errs.append((tk - tp)[fin].abs().max())
    # torch's max keeps a NaN (a NaN t from the kernel shows as NaN)
    err = float(torch.stack(errs).max())
    n = keys.shape[0]
    print(f"[kernel] decode, {label}: {n} keys ({int((pk == -2).sum())} "
          f"hits), {bad} words differ from the plain version, max abs "
          f"error in t {err}")
    check(err == 0.0, f"decode, {label}: t differs from the plain version "
          f"by {err}")
    check(bad == 0, f"decode, {label}: kernel disagrees with its plain "
          f"version")
    ms = cuda_time_ms(lambda: wf.decode_cuda(keys), 10)
    plain_ms = cuda_time_ms(lambda: wf.decode_plain(keys), 10)
    b = _bound(n * 16, 0)
    print(f"[kernel] decode, {label}: kernel {ms:.4f} ms, plain (torch on "
          f"the card) {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
          f"(bytes), {b['bound_ms'] / ms:.3f} of it reached")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **b)


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
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = wf.trace_closest_wavefront(scene, o, d, valid, t_limit, compact=True)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    b = packet_dfs.trace_closest_packets(scene, o, d, valid, t_limit)
    hm = int(((a.prim < 0) != (b.prim < 0)).sum())
    t_bad = int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum())
    ties = int(((a.prim != b.prim) & (a.prim >= 0)).sum())
    print(f"[trace] {label}: wavefront vs packet-DFS on {o.shape[0]} lanes "
          f"({int(valid.sum())} live): hit/miss mismatches {hm}, t bit "
          f"mismatches {t_bad}, prims differing at a bit-equal t {ties}, "
          f"hits {int((a.prim >= 0).sum())}, dropped {int(a.dropped)}; "
          f"the wavefront trace took {peak:.3f} GiB of device memory above "
          f"what was allocated before it (torch.cuda.max_memory_allocated)")
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
    return dict(wf_ms=ms_wf, dfs_ms=ms_dfs, peak_gib=peak)


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
    wfb = measure_wavefront("run B depth-2 closest-hit trace", rb.scene,
                            closest)
    wfb_s = measure_wavefront("run B depth-2 shadow trace", rb.scene, shadow)
    measure_wavefront("run A depth-2 closest-hit trace", ra.scene,
                      run_a["wf"][True])
    # many lanes live and a deep tree: all 15,360,000 camera rays of run B
    cam = measure_wavefront("run B camera trace", rb.scene,
                            run_b["dfs"][True])
    compare_traces("run B depth-2 closest-hit", rb.scene, closest)
    compare_traces("run B depth-2 shadow", rb.scene, shadow)
    compare_traces("run A depth-2 closest-hit", ra.scene, run_a["wf"][True])
    compare_traces("run B camera trace", rb.scene, run_b["dfs"][True])
    dec = measure_decode("run B depth-2 closest-hit trace", wfb["keys"])
    measure_decode("run B camera trace", cam["keys"])

    csrc = "cuda_raytracer_tpu_torch/ops/csrc/"
    tpu = "cuda_raytracer_tpu/ops/pallas/"
    launches = run_b["launches"]

    def row(name, source, replaces, k, err, library_ms=None):
        return dict(name=name, route="cuda", source=csrc + source,
                    replaces=tpu + replaces, launches=launches[name],
                    max_abs_err=err, ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                    library_ms=library_ms)

    # count: the main path's, on the level-0 queue; pack: the level with
    # the most entries
    cnt, pk = wfb["level0"], wfb["best"]
    return [
        row("packet_dfs", "packet_dfs.cu", "packet_dfs.py:99", dfs,
            dfs["max_abs_err"]),
        row("partition_rays", "partition.cu", "partition.py:38",
            part["rays"], part["rays"]["max_abs_err"]),
        row("partition", "partition.cu", "partition.py:38",
            part["payload"], part["payload"]["max_abs_err"],
            part["payload"]["library_ms"]),
        row("wf2_count", "wavefront2.cu", "wavefront2.py:262",
            dict(ms=cnt["count_ms"], plain_ms=cnt["count_plain_ms"],
                 **cnt["count_bound"]),
            float(max(cnt["count_err"], wfb_s["level0"]["count_err"]))),
        row("wf2_pack", "wavefront2.cu", "wavefront2.py:377",
            dict(ms=pk["pack_ms"], plain_ms=pk["pack_plain_ms"],
                 **pk["pack_bound"]),
            max(pk["pack_err"], wfb_s["best"]["pack_err"])),
        row("wf2_decode", "wavefront2.cu", "wavefront2.py:1420", dec,
            dec["max_abs_err"]),
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
