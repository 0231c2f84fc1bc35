#!/usr/bin/env python3
"""Time a frame's wavefront traces and their steps, one tree at a time.

    python3 tools/torch_wf_steps.py [--tree PATH]

Imports ``cuda_raytracer_tpu_torch`` from PATH (default: this checkout;
PATH may be an unpacked earlier commit), renders the warm-up frame of
chip_smoke.py's run A (Cornell box) and run B (terrain n=121) with the
fast preset as shipped, keeps the rays of every wavefront trace of the
frame (depths 2 and 3, closest-hit and shadow) and of run B's camera
trace (15,360,000 lanes, all live), and times each trace through the
compacted wavefront and through packet-DFS on the same rays: CUDA events
around each call behind a device sleep (no host gap is timed), the mean
of 5 calls.  Then it times the steps of the wavefront trace with the
same timer: each call the trace makes to the module's ``count_cuda``,
``pack_cuda``, ``plan_regions`` and ``decode_keys`` (whichever the tree
calls) gets a device sleep before it and CUDA events around it, and
prints each step's time per level, the mean of 5 traces.  The steps
of a tree whose trace takes ``fused_counts`` are timed with it on and
off.  Prints the card's name and power limit first.  To compare two
trees, run both in one call, in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


STEPS = ("count_cuda", "plan_regions", "pack_cuda", "decode_keys")


def step_times(wf, fn, reps):
    """{step: [ms of each call, in the trace's order]} of fn()'s trace,
    the mean of ``reps`` traces: each of wf's STEPS that the tree has is
    wrapped for the run, with a device sleep before each call (so the
    host queues the call before the device reaches it) and CUDA events
    around it."""
    import torch

    fn()  # warm
    real = {k: getattr(wf, k) for k in STEPS if hasattr(wf, k)}
    evs = {k: [] for k in real}

    def timed(k):
        def call(*a, **kw):
            torch.cuda._sleep(2_000_000)
            e = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = real[k](*a, **kw)
            e[1].record()
            evs[k].append(e)
            return out
        return call

    for k in real:
        setattr(wf, k, timed(k))
    try:
        for _ in range(reps):
            fn()
    finally:
        for k, f in real.items():
            setattr(wf, k, f)
    torch.cuda.synchronize()
    out = {}
    for k, e in evs.items():
        per = len(e) // reps
        if per:
            out[k] = [sum(e[r * per + i][0].elapsed_time(e[r * per + i][1])
                          for r in range(reps)) / reps for i in range(per)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.tree), HERE]

    import importlib.util
    import inspect

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py (its timing), whatever tree is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    print(f"card: {cs.smi_line()}; tree {os.path.abspath(args.tree)} "
          f"(package {os.path.dirname(wf.__file__)})")

    def capture(scene_fn, view):
        r = WavefrontRenderer(cs.fast_config(), camera_mode="collada",
                              device="cuda")
        r.load_static_scene(scene_fn())
        r.set_viewpoint(*view)
        traces, cam = [], {}
        real_wf, real_dfs = (backends.trace_closest_wavefront,
                             packet_dfs.dfs_trace_cuda)

        def keep_wf(scene, o, d, valid, t_limit, *a, **kw):
            traces.append((o, d, valid, t_limit))
            return real_wf(scene, o, d, valid, t_limit, *a, **kw)

        def keep_dfs(*a):
            cam.setdefault("rays", a[:4])
            return real_dfs(*a)

        backends.trace_closest_wavefront = keep_wf
        packet_dfs.dfs_trace_cuda = keep_dfs
        try:
            r.render()
        finally:
            backends.trace_closest_wavefront = real_wf
            packet_dfs.dfs_trace_cuda = real_dfs
        return r.scene, traces, cam["rays"]

    fusable = "fused_counts" in inspect.signature(
        wf.trace_closest_wavefront).parameters
    names = ("depth-2 closest-hit", "depth-2 shadow", "depth-3 closest-hit",
             "depth-3 shadow")
    for run, scene_fn, view in (
        ("A", lambda: cornell_box_scene(with_spheres=True), cs.VIEW_A),
        ("B", lambda: terrain_scene(n=121), cs.VIEW_B),
    ):
        scene, traces, cam = capture(scene_fn, view)
        sets = list(zip(names, traces))
        if run == "B":
            sets.append(("camera", cam))
        live = [int(rays[2].sum()) for _, rays in sets]
        dfs = [cs.cuda_time_ms(lambda: packet_dfs.trace_closest_packets(
            scene, *rays), 5) for _, rays in sets]
        print(f"[steps] run {run}, packet-DFS: " + ", ".join(
            f"{n} {ms:.4f} ms ({k} live)"
            for (n, _), ms, k in zip(sets, dfs, live))
            + f"; the frame's four {sum(dfs[:4]):.4f} ms")
        got = [cs.cuda_time_ms(lambda: wf.trace_closest_wavefront(
            scene, *rays, compact=True, want_prim=rays[3] is None), 5)
            for _, rays in sets]
        print(f"[steps] run {run}, wavefront: " + ", ".join(
            f"{n} {ms:.4f} ms" for (n, _), ms in zip(sets, got))
            + f"; the frame's four {sum(got[:4]):.4f} ms")
        for fused in ((True, False) if fusable else (None,)):
            kw = {} if fused is None else dict(fused_counts=fused)
            for n, rays in sets:
                steps = step_times(wf, lambda: wf.trace_closest_wavefront(
                    scene, *rays, compact=True, want_prim=rays[3] is None,
                    **kw), 5)
                print(f"[steps] run {run}, {n}"
                      + ("" if fused is None else f", fused_counts={fused}")
                      + ": " + "; ".join(
                          f"{k} {sum(v):.4f} ms in {len(v)} calls ("
                          + ", ".join(f"{x:.4f}" for x in v) + ")"
                          for k, v in steps.items()))
        del traces, cam, sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
