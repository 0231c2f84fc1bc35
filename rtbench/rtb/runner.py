"""One run of one cell: set-up, the measured window, the check and the
result line's contents.  ``run.py`` calls ``run_cell`` on the card; the
tests call it on the CPU with small cells."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional

from . import catalog, check, rays, stats, system, traffic
from . import trace as tracing

#: top-level modules that the process may not hold once the window has
#: closed (whole names: the port's own name begins with the last one)
BANNED = ("jax", "jaxlib", "flax", "cuda_raytracer_tpu")


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def render_seed(seed: int) -> int:
    """The renderer's seed (a non-negative int32) of the run's seed."""
    return seed % (1 << 31)


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)
             ) -> Dict:
    """Run ``cell`` (catalog.cell) once; returns the result's fields:
    correct, attempted, failed, metrics, device, breakdown (traced runs)
    and compared."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": time.perf_counter() - t0}
    config, job = cell["config"], cell["job"]
    render, camera = job["render"], config["camera"]
    on_card = device.startswith("cuda")
    if on_card:
        system.build_kernels()
    phases["kernels"] = time.perf_counter() - t0
    scene = catalog.scene_builder(config["builder"])(config)
    phases["scene"] = time.perf_counter() - t0
    sut = catalog.system(job["system"]).Renderer(
        scene, render, camera, render_seed(seed), device)
    phases["load"] = time.perf_counter() - t0
    rays_per_frame = rays.rays_per_frame(render, len(scene["lights"]))
    keeper = check.Keeper(seed, int(job["check"]["images"]))
    frames = traffic.frames(job)
    spf = render["samples_per_frame"]
    threshold = render["post_process_threshold"]
    ranges = {"on": False}

    def host_range(name):
        return (tracing.host_range(name) if ranges["on"]
                else contextlib.nullcontext())

    state = {"image": None, "copies": 0, "failed": 0, "frames": 0}

    def step(fr, keep: bool):
        """One frame of the job: (seconds, render() seconds)."""
        if fr.reset:
            origin, look = traffic.pose(camera, job, fr.image)
            with host_range("place"):
                sut.place(origin, look)
            state["image"] = {"origin": [float(x) for x in origin],
                              "look": [float(x) for x in look],
                              "frames": []}
        index = sut.frames
        t = time.perf_counter()
        with host_range("render"):
            dropped = sut.frame()
        t_render = time.perf_counter() - t
        img = None
        if fr.copy:
            with host_range("get_image"):
                img = sut.image()
        dt = time.perf_counter() - t
        rec = state["image"]
        rec["frames"].append(index)
        if keep:
            state["frames"] += 1
            state["failed"] += dropped > 0
            if img is not None:
                state["copies"] += 1
                median = (fr.index + 1) * spf < threshold
                number = state["copies"]
                keeper.offer("median" if median else "film", lambda: {
                    "image": img, "median": median, "number": number,
                    "frames": [(i, rec["origin"], rec["look"])
                               for i in rec["frames"]]})
        return dt, t_render

    # set-up: one whole image of the job (its film programs with and
    # without the median are captured here), then the window starts on
    # the next image
    first_frame_s = None
    for fr in frames:
        _, t_render = step(fr, keep=False)
        if first_frame_s is None:
            first_frame_s = t_render
        if fr.last:
            break
    if on_card:
        torch.cuda.synchronize()
    if trace:
        # the profiler's first start loads its tracing library (seconds):
        # part of set-up, not of the profiled span
        tracing.profile(lambda: 0)

    frame_s = []
    profiled = None
    per_span = int(job.get("profile_images", 1))
    t_start = time.perf_counter()
    setup_s = t_start - t0
    phases["first_image"] = setup_s
    log(f"[rtbench] set-up {setup_s:.3f} s (seconds from the process's "
        f"start at the end of each step: {phases}); window of {seconds} s")
    while True:
        fr = next(frames)
        if (trace and profiled is None and fr.reset
                and time.perf_counter() - t_start >= 0.25 * seconds):
            def span(fr=fr):
                ranges["on"] = True
                n, done, f = 0, 0, fr
                while True:
                    frame_s.append(step(f, keep=True)[0])
                    n += 1
                    if f.last:
                        done += 1
                        if done == per_span:
                            break
                    f = next(frames)
                ranges["on"] = False
                return n
            profiled = tracing.profile(span)
            continue
        frame_s.append(step(fr, keep=True)[0])
        if (fr.last and time.perf_counter() - t_start >= seconds
                and (profiled is not None or not trace)):
            break
    t_end = time.perf_counter()
    window_s = t_end - t_start
    # the fullest device's peak
    peak = max(torch.cuda.max_memory_allocated(d) for d in sut.devices) \
        if on_card else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"the process holds {', '.join(found)} after the "
                         "window")

    result = {"attempted": state["frames"], "failed": state["failed"]}
    metrics = {}
    if not trace:
        values = {
            "mrays_per_s": rays_per_frame * len(frame_s) / window_s / 1e6,
            "frame_ms_p95": stats.percentile(frame_s, 95) * 1e3,
            "setup_s": setup_s,
        }
        # a metric split by kind of cell ("frame_ms_p95.realtime") reads
        # the quantity its name begins with
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        ctx = {"load_times": sut.load_times,
               "host_s": {"first_frame": first_frame_s},
               "trace": profiled,
               "port_kernels": system.kernel_names()}
        for m in cell["per_layer"]:
            value = catalog.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in profiled.device_ops()],
            "idle_gaps": [[n, s] for n, s in profiled.idle_gaps()]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": len(sut.devices), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = profiled.busy_s()
        dev["window_s"] = profiled.window_s
    result["device"] = dev
    log(f"[rtbench] window {window_s:.3f} s, {len(frame_s)} frames, "
        f"{state['copies']} host copies, {state['failed']} frames "
        f"dropped rays; peak {peak} B")

    # the check, after the window, with the renderer's memory freed
    records = keeper.records()
    sut.close()
    del sut
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refs = check.reference_values(
        scene, dict(render, seed=render_seed(seed)), camera, records, seed,
        job["check"], device=device)
    images = [r["image"] for r in records]
    got = check.values_at(images, refs)
    compared = check.compare(got, refs, job["check"]["limits"],
                             check.count_nonfinite(images))
    log(f"[rtbench] check: {len(records)} images "
        f"({', '.join(sorted(k for k in keeper.kept))}), "
        f"{time.perf_counter() - t:.3f} s; gaps "
        f"{check.quantiles(got, refs)}")
    result["correct"] = check.passed(compared)
    result["compared"] = compared
    return result
