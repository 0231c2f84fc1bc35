#!/usr/bin/env python3
"""Where a frame of the PyTorch port goes on the GPU.

    python3 tools/torch_profile_frame.py [--scene cornell|terrain|run_c|run_h]
                                         [--traversal-rr pallas|dfs]
                                         [--compact-depths]
                                         [--preset fast|reference]

Runs chip_smoke.py's run-A (cornell), run-B (terrain), run-C (its
COLLADA document, loaded through load_scene with the document's camera)
or run-H (run C's document with a directional light beside its area
light, and the sky map attached as ``render_cli -e`` attaches it: three
lights, the camera render_cli -e leaves) configuration (the fast preset as shipped, or with the roulette depths through
packet-DFS; 800x600, 32 spp per frame, depth 4, NEE 1x1.0) on one card:
a warm-up frame, then two frames (the first of an accumulation, whose
film runs the median, and a later one) with every bounce-loop stage
timed by CUDA events around it (trace, the fused shading chain's gaps
by variant (``shade_gap``: ops/shade_stages.py GAPS), plus raygen and
film; each row of a stage with kernels names them (ops/csrc/shade.cu's
gap kernels, raygen.cu, film.cu), and each profiled frame prints their
device time beside the stage's, the rest being the stage's glue: its
draws, the allocation of its outputs) and, inside
the wavefront traces, the partition
of the rays into the level-0 queue, the count kernel (with its region
plan), the pack kernel (with the next level's counts and plan) and the
decode kernel of the hit keys (the merge), with the live entries the
partition found per trace; then the device launches of one wavefront
closest-hit and one shadow trace of that frame (torch.profiler); then
the two frames again under torch.profiler for device time by kernel
name and the device's busy share of each.  With ``--compact-depths`` the frame
runs whole-depth compaction (``compact_depths=True``; "auto" fuses the
frame on the card): the roulette depths' stages run over the live
lanes, and the path state's packing (``pack_state``) and partition are
timed too.  ``--preset reference`` runs render_cli's default preset
instead (what ``render_cli scene.dae`` renders with no ``--preset``:
raster order, a draw per ray, no roulette, every trace through
packet-DFS, 2 spp per frame, depth 3, NEE 1x1.0) at 800x600.  The
stage table needs the stages dispatched one by one, so it is taken on
the eager frame (``fuse_frame="no"``; with ``--compact-depths``, which
needs a fused frame, the per-depth programs called without capture).
Last, the frame as the engine runs it on the card, as CUDA graphs
(render/graphs.py): a first frame (warm-up, capture, replay), a later
frame on the host clock, the first frame of an accumulation (the
median's film) after a reset, then eight frames, each with its image's
host copy (``get_image``), under torch.profiler, read by the renderer's
named host ranges (``crt.*``, render/engine.py; ``crt_report``): per
frame, each range's host ms, the device ms of the work launched inside
it (by the profiler's correlation ids, a graph launch covering its
graph's kernels) and the device-idle ms while it was the innermost range
open on the host.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
# the benchmark's interval arithmetic (rtbench/rtb/stats.py)
sys.path.insert(0, os.path.join(HERE, "rtbench"))

#: the kernels of a stage row: the fused shading chain's
#: (ops/csrc/shade.cu: a gap after a closest-hit trace is a
#: shade_hit_kernel<...>, after a shadow trace a nee_accum_kernel<...>),
#: raygen's (raygen.cu) and the film's (film.cu: reconstruct +
#: accumulate, and the median where the frame runs it)
STAGE_KERNELS = {"shade_gap": ("shade_hit_kernel<", "nee_accum_kernel<"),
                 "raygen": ("raygen_kernel",),
                 "film": ("film_kernel", "median3x3_kernel")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell", "terrain", "run_c",
                                        "run_h"),
                    default="cornell")
    ap.add_argument("--traversal-rr", choices=("pallas", "dfs"),
                    default="pallas")
    ap.add_argument("--compact-depths", action="store_true")
    ap.add_argument("--preset", choices=("fast", "reference"),
                    default="fast")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.ops import shade_stages as SS
    from cuda_raytracer_tpu_torch.render import bounce, engine
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    if args.preset == "reference":
        cfg = cs._cli_config(["scene.dae", "--size",
                              f"{cs.WIDTH}x{cs.HEIGHT}"])[0]
    else:
        cfg = cs.fast_config(traversal_rr=args.traversal_rr,
                             compact_depths=args.compact_depths)
    print(f"card: {cs.smi_line()}; preset {args.preset}: "
          f"{cfg.samples_per_frame} spp per frame, depth {cfg.max_depth}, "
          f"traversal_rr={cfg.traversal_rr!r}, "
          f"compact_depths={cfg.compact_depths}")
    def make(cfg):
        r = WavefrontRenderer(cfg, camera_mode="collada", device="cuda")
        if args.scene == "cornell":
            r.load_static_scene(cornell_box_scene(with_spheres=True))
            r.set_viewpoint(*cs.VIEW_A)
        elif args.scene in ("run_c", "run_h"):
            lights = (("area", "directional") if args.scene == "run_h"
                      else ("area",))
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "run_c.dae")
                with open(path, "w") as f:
                    f.write(cs.run_c_document(121, lights))
                r.load_scene(path)
            if args.scene == "run_h":
                cs._attach_env(r, cs.sky_map())
        else:
            r.load_static_scene(terrain_scene(n=121))
            r.set_viewpoint(*cs.VIEW_B)
        return r

    if cfg.compact_depths:
        r = make(cfg)
        r.graphs.enabled = False  # compaction needs the fused programs
    else:
        r = make(cfg.replace(fuse_frame="no"))
    r.render()  # warm-up
    torch.cuda.synchronize()

    # --- stage times by CUDA events -------------------------------------
    events = collections.defaultdict(list)

    def timed(name, fn):
        def wrapped(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events[name].append((s, e))
            return out
        return wrapped

    gap = r._stages["shade_gap"]
    r._stages = {k: timed(k, v) for k, v in r._stages.items()}
    # the chain's gaps once per variant
    gaps = {g: timed(f"shade_gap ({g})", gap) for g in SS.GAPS}

    def gap_by_variant(*a, **kw):
        g = SS.gap_variant(kw["opened"] is not None, kw["accum"],
                           kw["sample"] is not None, kw["store"],
                           kw["scatter"] is not None)
        return gaps[g](*a, **kw)

    r._stages["shade_gap"] = gap_by_variant
    r._raygen = timed("raygen", r._raygen)
    r._film = timed("film", r._film)
    # the module functions wrapped below, put back before the graphed
    # frame (whose capture must not record the timing events)
    saved = [(engine, "pack_state"), (bounce, "pack_state"),
             (engine, "compact_live_payload"), (wf, "compact_live_rays"),
             (wf, "count_level"), (wf, "pack_level"), (wf, "decode_keys")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    # whole-depth compaction's own steps (the engine's and the bounce
    # loop's names for them)
    engine.pack_state = timed("pack_state", engine.pack_state)
    bounce.pack_state = timed("pack_state", bounce.pack_state)
    engine.compact_live_payload = timed("partition (path state)",
                                        engine.compact_live_payload)
    # inside the wavefront traces (these rows are part of the trace rows)
    live = []
    parts = {"compact_live_rays": "partition (rays)",
             "count_level": "count (+ plan)",
             "pack_level": "pack (+ next counts, plan)",
             "decode_keys": "merge (decode kernel)"}
    for fn, label in parts.items():
        setattr(wf, fn, timed("  wavefront: " + label, getattr(wf, fn)))
    compact = wf.compact_live_rays

    def compact_and_note(o, *rest):
        out = compact(o, *rest)
        live.append((o.shape[0], out[1]))
        return out

    wf.compact_live_rays = compact_and_note
    first_wf = {}
    trace_wf = backends.trace_closest_wavefront

    def keep_first(scene, o, d, valid, t_limit, *a, **kw):
        first_wf.setdefault(t_limit is None, (scene, o, d, valid, t_limit,
                                              a, kw))
        return trace_wf(scene, o, d, valid, t_limit, *a, **kw)

    backends.trace_closest_wavefront = keep_first
    # the first frame of an accumulation (its film runs the median), then
    # a later one (the median only below post_process_threshold samples)
    r._reset_accumulation()
    frames = []
    for which in ("first frame", "later frame"):
        events.clear()
        live.clear()
        median = r.image_samples < r.config.post_process_threshold
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        backends.trace_closest_wavefront = trace_wf
        label = f"{which}, {'with' if median else 'without'} the median"
        stage_ms = _stage_table(label, events, frame_ms, live)
        frames.append((label, frame_ms, stage_ms))

    # --- profiler: device time by kernel (the event wrappers stay) ------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # device launches of one wavefront trace (the first of each kind)
    for closest, (scene, o, d, valid, t_limit, a, kw) in sorted(
            first_wf.items(), reverse=True):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            trace_wf(scene, o, d, valid, t_limit, *a, **kw)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        print(f"[launches] one wavefront {'closest-hit' if closest else 'shadow'}"
              f" trace ({len(scene.bvh.wf_levels)} levels): "
              f"{sum(e.count for e in kern)} device launches: "
              + ", ".join(f"{e.count}x {e.key[:48]}" for e in kern))
    r._reset_accumulation()
    for label, frame_ms, stage_ms in frames:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            r.render()
            torch.cuda.synchronize()
        # kernel rows only (operator rows repeat their kernels' time;
        # the renderer's crt.* ranges show on the device's timeline too)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("crt.")]
        dev_total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"[profiler] {label}: {dev_total:.1f} ms of device kernel "
              f"time in {sum(e.count for e in rows)} launches; busy share "
              f"of the unprofiled {frame_ms:.1f} ms frame "
              f"{dev_total / frame_ms:.3f}")
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:25]:
            print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
        # each stage with kernels: their device time beside the stage's
        # event time; what is left is the stage's glue (its draws, the
        # allocation of its outputs, launch gaps)
        for stage, kernels in STAGE_KERNELS.items():
            mine = [e for e in rows if any(k in e.key for k in kernels)]
            k_ms = sum(e.self_device_time_total for e in mine) / 1e3
            s_ms = stage_ms.get(stage, 0.0)
            print(f"[kernels] {label}: {stage}: {' + '.join(kernels)} "
                  f"{k_ms:.3f} ms in {sum(e.count for e in mine)} "
                  f"launch(es) of the stage's {s_ms:.3f} ms; glue "
                  f"{s_ms - k_ms:.3f} ms")
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    graphed(make(cfg), frames[-1][1])
    return 0


def _stage_table(label, events, frame_ms, live):
    """Print one frame's stage table (and the partition's live entries);
    returns ms by stage."""
    if live:
        print(f"[live] {label}: entries the partition kept, per wavefront "
              "trace in frame order (each roulette depth's closest-hit "
              "trace, then its shadow trace per light): "
              + ", ".join(f"{int(k)} of {n}" for n, k in live))
    total = 0.0
    stage_ms = {}
    print(f"[stages] {label}, {frame_ms:.1f} ms on the host clock (in "
          f"brackets the stage's kernels, ops/csrc/):")
    for name, evs in sorted(events.items(),
                            key=lambda kv: -sum(s.elapsed_time(e)
                                                for s, e in kv[1])):
        ms = sum(s.elapsed_time(e) for s, e in evs)
        total += ms
        stage = name.split(" ")[0]
        stage_ms[stage] = stage_ms.get(stage, 0.0) + ms
        text = (f"{name} [{' + '.join(STAGE_KERNELS[stage])}]"
                if stage in STAGE_KERNELS else name)
        print(f"  {text:44s} {ms:9.2f} ms in {len(evs)} call(s)")
    print(f"  {'(sum of stages)':44s} {total:9.2f} ms")
    return stage_ms


def graphed(r, eager_ms, frames=8):
    """The frame as CUDA graphs: first frame, a later one on the host
    clock, the first frame of an accumulation (the median's film), then
    ``frames`` frames, each with its image's host copy, under
    torch.profiler: the renderer's ``crt.*`` ranges (crt_report)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    first = frame()
    frame()  # a later frame: for the fast preset, the film without median
    ms = frame()
    # the first frame of an accumulation: its film runs the median
    r._reset_accumulation()
    median_ms = frame()
    print(f"[graphed] the frame as CUDA graphs ({r.graphs.captures} "
          f"captured, {len(r.graphs)} keys): first frame {first:.1f} ms "
          f"(warm-up {r.graphs.warmup_s * 1e3:.1f} ms and captures "
          f"{r.graphs.capture_s * 1e3:.1f} ms of it), "
          f"then {ms:.1f} ms on the host clock (eager {eager_ms:.1f}), "
          f"{median_ms:.1f} ms for the first frame of an accumulation (the "
          f"median's film) after a reset")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            r.render()
            r.get_image()
        torch.cuda.synchronize()
    crt_report(prof.events(), frames, f"[graphed] {frames} frames, each "
               "with get_image()")


#: host events of the CUDA runtime or driver that launch device work
_RUNTIME = ("cu",)


def crt_report(events, frames, label):
    """Print, per frame, each ``crt.`` range's host ms, the device ms of
    the work launched inside it (a kernel, copy or fill counts under the
    innermost ``crt.`` range open when the host made the runtime call
    that launched it: its profiler correlation id is the call's; a graph
    launch covers its graph's kernels) and the device-idle ms in which
    it was the innermost ``crt.`` range open on the host.  ``events``:
    a torch.profiler session's ``events()`` over ``frames`` frames."""
    from torch.autograd import DeviceType
    from rtb import stats

    crt, calls, device = [], {}, []
    for e in events:
        t = (e.time_range.start * 1e-3, e.time_range.end * 1e-3)
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("crt."):
                crt.append((e.name, *t))
            elif e.name.startswith(_RUNTIME):
                calls[e.id] = t[0]
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(("crt.", "rtbench."))):
            device.append((e.id, *t))
    if not crt:
        print(f"{label}: no crt. range recorded")
        return

    def innermost(at):
        open_ = [c for c in crt if c[1] <= at <= c[2]]
        return (min(open_, key=lambda c: c[2] - c[1])[0] if open_
                else "(no crt. range)")

    host = collections.defaultdict(float)
    for name, s, e in crt:
        host[name] += e - s
    dev = collections.defaultdict(float)
    unmatched = 0
    for cid, s, e in device:
        if cid in calls:
            dev[innermost(calls[cid])] += e - s
        else:
            unmatched += 1
            dev["(launch not found)"] += e - s
    lo = min(c[1] for c in crt)
    hi = max(c[2] for c in crt)
    idle = collections.defaultdict(float)
    for gs, ge in stats.gaps([(s, e) for _, s, e in device], lo, hi):
        # the gap, cut where a crt. range starts or ends
        cuts = sorted({gs, ge} | {x for _, a, b in crt for x in (a, b)
                                  if gs < x < ge})
        for a, b in zip(cuts, cuts[1:]):
            idle[innermost((a + b) / 2)] += b - a
    print(f"{label}: {len(device)} device operations, {unmatched} with no "
          f"runtime call found; window {(hi - lo) / frames:.3f} ms a frame "
          f"(first crt. range to last), device idle "
          f"{sum(idle.values()) / frames:.3f} ms of it")
    print(f"  {'ms per frame':36s} {'host':>8s} {'device':>8s} {'idle':>8s}")
    names = sorted(set(host) | set(dev) | set(idle),
                   key=lambda n: min([c[1] for c in crt if c[0] == n]
                                     or [hi]))
    for name in names:
        print(f"  {name:36s} {host[name] / frames:8.3f} "
              f"{dev[name] / frames:8.3f} {idle[name] / frames:8.3f}")


if __name__ == "__main__":
    sys.exit(main())
