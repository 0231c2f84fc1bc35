#!/usr/bin/env python3
"""Where a frame of the PyTorch port goes on the GPU.

    python3 tools/torch_profile_frame.py [--scene cornell|terrain]

Runs chip_smoke.py's run-A (cornell) or run-B (terrain) configuration
(the fast preset with traversal_rr="dfs", 800x600, 32 spp per frame,
depth 4, NEE 1x1.0) on one card: a warm-up frame, then one frame with every bounce-loop stage timed
by CUDA events around it (trace, shade_hit, nee_prep, nee_accum,
scatter, plus raygen and film), then one frame under torch.profiler for
device time by kernel name and the device's busy share of the frame.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell", "terrain"),
                    default="cornell")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    print(f"card: {cs.smi_line()}")
    r = WavefrontRenderer(cs.fast_config(), camera_mode="collada",
                          device="cuda")
    if args.scene == "cornell":
        r.load_static_scene(cornell_box_scene(with_spheres=True))
        r.set_viewpoint(*cs.VIEW_A)
    else:
        r.load_static_scene(terrain_scene(n=121))
        r.set_viewpoint(*cs.VIEW_B)
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

    r._stages = {k: timed(k, v) for k, v in r._stages.items()}
    r._raygen = timed("raygen", r._raygen)
    r._film = timed("film", r._film)
    t0 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    total = 0.0
    print(f"[stages] one frame, {frame_ms:.1f} ms on the host clock:")
    for name, evs in sorted(events.items(),
                            key=lambda kv: -sum(s.elapsed_time(e)
                                                for s, e in kv[1])):
        ms = sum(s.elapsed_time(e) for s, e in evs)
        total += ms
        print(f"  {name:24s} {ms:9.2f} ms in {len(evs)} call(s)")
    print(f"  {'(sum of stages)':24s} {total:9.2f} ms")

    # --- profiler: device time by kernel (the event wrappers stay) ------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        r.render()
        torch.cuda.synchronize()
    # kernel rows only (operator rows repeat their kernels' time)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[profiler] one frame: {dev_total:.1f} ms of device kernel "
          f"time in {sum(e.count for e in rows)} launches; busy share "
          f"of the unprofiled {frame_ms:.1f} ms frame "
          f"{dev_total / frame_ms:.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
