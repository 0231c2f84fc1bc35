"""The renderer's named host ranges (utils/timing.span, render/engine.py)
on the CPU, with the plain versions:

* one profiled render() opens each ``crt.frame.*`` range of its frame
  once, in order and without overlap: inputs, raygen, a range per depth
  (under whole-depth compaction the path state's partitions between the
  compacted depths), the film, a fused frame's copy out of the graphs'
  pool, the wait; for fuse_frame yes/no and compact_depths on/off; each
  read of a device value on the host falls inside one of them;
* get_image() and get_raw_image() copy inside ``crt.image.copy``;
* with no profiler running a range is the shared null context and never
  builds a ``record_function``;
* frames rendered under the profiler are bit-equal to frames without it;
* stage_times keeps the scene load's steps and the frame, and no
  per-depth laps.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.utils import timing

from torch_threads import _one_torch_thread  # noqa: F401

W, H, SPF = 32, 16, 4
VIEW = ([0, 0.75, 2.5], [0, 0.75, 0])


def renderer(fuse_frame="yes", compact_depths=False):
    """The fast preset (roulette from depth 2 of 4) on the Cornell box."""
    kw = fast_preset_kwargs(W, H, 4 * SPF)
    kw.update(samples_per_frame=SPF, fuse_frame=fuse_frame,
              compact_depths=compact_depths)
    r = WavefrontRenderer(
        RenderConfig(width=W, height=H, total_samples=4 * SPF, max_depth=4,
                     nee_schedule=((1, 1.0),) * 4, **kw),
        camera_mode="collada", device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.set_viewpoint(*VIEW)
    return r


def host_events(fn):
    """The host events that ``fn()`` records under the profiler, as
    (name, start, end) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()), key=lambda x: x[1])


def ranges(fn):
    """The ``crt.`` host ranges that ``fn()`` opens under the profiler, as
    (name, start, end) in start order."""
    return [x for x in host_events(fn) if x[0].startswith("crt.")]


def expected(r):
    """The ranges of one frame of ``r``, in order."""
    cfg = r.config
    dense = cfg.rr_start_depth if r.compacting else cfg.max_depth
    names = ["inputs", "raygen"] + [f"depth{i}" for i in range(dense)]
    if r.compacting:
        names.append(f"partition{dense - 1}")
        for depth in range(dense, cfg.max_depth):
            names.append(f"depth{depth}")
            if depth + 1 < cfg.max_depth:
                names.append(f"partition{depth}")
    names.append("film")
    if r.fused:
        names.append("copy_out")
    return ["crt.frame." + n for n in names + ["wait"]]


@pytest.mark.parametrize("fuse_frame", ["yes", "no"])
@pytest.mark.parametrize("compact_depths", [False, True])
def test_frame_ranges(fuse_frame, compact_depths):
    r = renderer(fuse_frame, compact_depths)
    assert r.compacting == (fuse_frame == "yes" and compact_depths)
    events = host_events(r.render)
    got = [x for x in events if x[0].startswith("crt.")]
    if r.compacting:
        # every compacted depth ran: none found its lanes all dead
        assert len(r.live_counts) == 2 and min(r.live_counts) > 0
    assert [n for n, _, _ in got] == expected(r)
    # one after another: no range inside another
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert end <= start
    # each read of a device value on the host (the dropped count; under
    # compaction each live count) waits inside a range
    reads = [x for x in events if x[0] == "aten::_local_scalar_dense"]
    assert len(reads) >= 1 + len(r.live_counts)
    for _, s, e in reads:
        assert any(a <= s and e <= b for _, a, b in got)


def test_image_copy_range():
    r = renderer()
    r.render()
    got = ranges(lambda: (r.get_image(), r.get_raw_image(), r.get_image()))
    assert [n for n, _, _ in got] == ["crt.image.copy"] * 3


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timing.span("crt.frame.inputs") is timing.span("x")
    with timing.span("crt.frame.inputs") as inside:
        assert inside is None
    r = renderer()
    r.render()
    r.get_image()
    with pytest.raises(AssertionError, match="record_function"):
        with profile(activities=[ProfilerActivity.CPU]):
            timing.span("crt.frame.inputs")


@pytest.mark.parametrize("fuse_frame", ["yes", "no"])
def test_profiled_frames_bit_equal(fuse_frame):
    def frames(r):
        out = []
        for _ in range(2):
            r.render()
            out += [r.get_image(), r.get_raw_image()]
        return out

    plain = frames(renderer(fuse_frame))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = frames(renderer(fuse_frame))
    for a, b in zip(plain, traced):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_stage_times_keys():
    r = renderer()
    r.render()
    keys = set(r.stage_times)
    assert {"frame", "bvh_build", "flatten", "upload"} <= keys
    assert not [k for k in keys if k.startswith(("depth", "partition"))]
