#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version on the card, drives the port's
main path at full size, checks the card against the CPU per pixel, and
prints one JSON line per kernel and, last, the device line.  Phases:

1. set-up: the card's name and power limit, nvcc's version, kernel build;
2. the packet-DFS kernel against its plain version on 262,144 rays of
   terrain n=121 (28,800 tris): hit/miss, prim and t bit-equal, shadow
   decisions equal, dropped == 0; kernel, plain and bound times;
3. the slice at full size: the fast preset with traversal_rr="dfs",
   800x600, depth 4, NEE 1x1.0 per depth — run A is bench.py's
   configuration and procedural scene (Cornell box with spheres, 2
   frames of 32 spp), run B terrain n=121 seen from above so it fills
   the frame (1 frame of 32 spp); each kernel's launch count must equal
   traces per frame x frames; then the kernel against its plain version
   on the runs' own 15,360,000-lane traces;
4. the same small frame on the card and on the CPU, per pixel.

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
    """bench.py's configuration with traversal_rr="dfs"."""
    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs

    kw = fast_preset_kwargs(WIDTH, HEIGHT, 64)
    kw.update(traversal_rr="dfs", **over)
    return RenderConfig(width=WIDTH, height=HEIGHT, total_samples=64,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


def phase_setup():
    from cuda_raytracer_tpu_torch.ops import packet_dfs

    print(f"[setup] card: {smi_line()}")
    nvcc = packet_dfs.nvcc_command("", "")[0]
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"[setup] nvcc: {ver[-1]}")
    t0 = time.perf_counter()
    packet_dfs._load_library()
    print(f"[setup] packet_dfs.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


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
    so the result is the same; it bounds the plain version's [N, 64]
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
            1e-3)
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
          f"{stats['visits']} visits, {stats['boxes']} box tests, "
          f"{stats['tris']} triangle and {stats['spheres']} sphere tests "
          f"-> {ops_ms:.5f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms > ops_ms else "operations",
                max_abs_err=err)


def phase_kernel(dev):
    scene, closest, shadow = terrain_ray_set(dev)
    a = measure_kernel("terrain closest-hit", scene, closest)
    b = measure_kernel("terrain shadow", scene, shadow)
    return max(a["max_abs_err"], b["max_abs_err"])


def run_slice(label, scene_fn, frames, viewpoint=None):
    """Drive the main path (warm-up frame, then ``frames`` counted
    frames).  Returns (launches, renderer, the rays (o, d, valid,
    t_limit) of the warm-up frame's first closest-hit trace, under True,
    and first shadow trace, under False)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(), camera_mode="collada",
                          device=DEVICE)
    t0 = time.perf_counter()
    r.load_static_scene(scene_fn())
    load_s = time.perf_counter() - t0
    if viewpoint is not None:
        r.set_viewpoint(*viewpoint)
    # warm-up frame (allocator, first launches); keeps the kernel's
    # inputs of its first closest-hit and first shadow trace
    seen = {}
    launch = packet_dfs.dfs_trace_cuda

    def keep(*args):
        seen.setdefault(args[3] is None, args[:4])  # closest-hit or shadow
        return launch(*args)

    packet_dfs.dfs_trace_cuda = keep
    try:
        r.render()
    finally:
        packet_dfs.dfs_trace_cuda = launch
    r._reset_accumulation()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    packet_dfs.launches = 0
    t0 = time.perf_counter()
    dropped = 0
    for _ in range(frames):
        r.render()
        dropped += r.dropped
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = packet_dfs.launches

    img = r.get_image()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mrays = r.mrays_per_frame * frames / elapsed
    want = r.traces_per_frame * frames
    print(f"[slice {label}] {r.scene.num_prims} prims, flatten "
          f"{load_s:.2f} s, {frames} frame(s) of {r.config.samples_per_frame}"
          f" spp: {mrays:.3f} Mrays/s, {elapsed / frames * 1e3:.1f} ms/frame,"
          f" dropped {dropped}, image mean {float(img.mean()):.6f}, finite "
          f"{bool(np.isfinite(img).all())}, peak device memory {peak:.2f} "
          f"GiB, packet_dfs launches {launches} (want {want})")
    check(img.shape == (HEIGHT, WIDTH, 3), "image shape")
    check(bool(np.isfinite(img).all()), f"run {label}: non-finite image")
    check(float(img.mean()) > 0.0, f"run {label}: black image")
    check(dropped == 0, f"run {label}: dropped rays")
    check(launches == want, f"run {label}: kernel launches {launches} != "
          f"traces per frame x frames {want}")
    return launches, r, seen


def phase_slice():
    """Runs A and B; then the kernel against its plain version on the
    runs' own traces (the main path's shapes).  Run A's camera trace
    gives the kernel line's numbers; run B's descends a deep tree."""
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    launches_a, ra, seen_a = run_slice(
        "A cornell", lambda: cornell_box_scene(with_spheres=True), 2,
        viewpoint=VIEW_A,
    )
    _, rb, seen_b = run_slice(
        "B terrain", lambda: terrain_scene(n=121), 1,
        viewpoint=VIEW_B,
    )
    main = measure_kernel("run A camera trace", ra.scene, seen_a[True])
    measure_kernel("run A first shadow trace", ra.scene, seen_a[False])
    measure_kernel("run B camera trace", rb.scene, seen_b[True],
                   chunk=1 << 18)
    return launches_a, main


def phase_cpu_vs_cuda():
    import numpy as np

    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    w, h, spf, frames = 64, 32, 2, 2
    kw = fast_preset_kwargs(w, h, spf * frames)
    kw.update(traversal_rr="dfs", samples_per_frame=spf)
    cfg = RenderConfig(width=w, height=h, total_samples=spf * frames,
                       max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)
    imgs = []
    for dev in (DEVICE, "cpu"):
        r = WavefrontRenderer(cfg, camera_mode="collada", device=dev)
        r.load_static_scene(cornell_box_scene(with_spheres=True))
        r.set_viewpoint(*VIEW_A)
        for _ in range(frames):
            r.render()
        imgs.append(r.get_raw_image())
    a, b = imgs
    bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    print(f"[cpu-vs-cuda] {w}x{h}, {frames} frames of {spf} spp: "
          f"{int(bad.sum())} of {w * h} pixels outside rtol={PIXEL_RTOL} "
          f"atol={PIXEL_ATOL}; max |diff| {float(np.abs(a - b).max()):.3g}")
    check(float(bad.mean()) <= MAX_BAD, "card and CPU frames differ")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cuda_raytracer_tpu_torch")):
        fail("run from a checkout of the repository (package missing)")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)

    phase_setup()
    err = phase_kernel(DEVICE)
    launches_a, k = phase_slice()
    phase_cpu_vs_cuda()

    kernels = [dict(
        name="packet_dfs",
        route="cuda",
        source="cuda_raytracer_tpu_torch/ops/csrc/packet_dfs.cu",
        replaces="cuda_raytracer_tpu/ops/pallas/packet_dfs.py:99",
        launches=launches_a,
        max_abs_err=max(err, k["max_abs_err"]),
        ms=k["ms"],
        plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"],
        bound_by=k["bound_by"],
        library_ms=None,
    )]
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
