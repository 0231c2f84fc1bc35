"""The whole slice: the port's WavefrontRenderer against the JAX engine.

Both run the fast preset at 64x32, 2 spp per frame, 2 frames, depth 4,
NEE 1x1.0 per depth, on the Cornell box with spheres.  The port runs
the preset as shipped: packet-DFS at depths 0-1 and the compacted
wavefront (``traversal_rr="pallas"``) at depths 2-3, their plain
versions on the CPU; one case keeps ``traversal_rr="dfs"``, and one
runs terrain n=8 under ``max_leaf_size=4`` in both engines, whose tree
has three wavefront levels (the Cornell box is a single leaf at any
leaf size).  The JAX engine traces
with its XLA scan (``traversal*="xla"``), which finds the same closest
hits and shadow decisions without Pallas interpret mode.  The port's
threefry draws the JAX engine's noise, so per pixel any gap is float
rounding (XLA's CPU fusion contracts FMAs, torch does not); where that
rounding flips a path (a scatter ray grazing an edge) a pixel differs
outright.  Held: per-pixel rtol=1e-4, atol=1e-5, with at most 1% of
pixels outside it, reported.
"""

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.config import fast_preset_kwargs as jax_fast
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer

from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs, partition, wavefront2
from cuda_raytracer_tpu_torch.render import backends
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

W, H, SPF, FRAMES = 64, 32, 2, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01

BASE = dict(width=W, height=H, total_samples=SPF * FRAMES, max_depth=4,
            nee_schedule=((1, 1.0),) * 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here.  The rounding once put down to
    threads is torch's vectorized CPU float32 ``sqrt``, one ulp off the
    IEEE result on some hosts: threads only move where an op's vector
    body ends and its correctly rounded scalar tail begins, so one
    thread made it rarer without curing it.  The plain versions now take
    their roots from ``ops.intersect.sqrt_rn``; these tests compare to
    the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(**over):
    """The fast preset as shipped (only the frame is cut to SPF spp)."""
    kw = fast_preset_kwargs(W, H, SPF * FRAMES)
    kw.update(samples_per_frame=SPF, **over)
    return RenderConfig(**BASE, **kw)


def jax_config(**over):
    kw = jax_fast(W, H, SPF * FRAMES)
    kw.update(traversal="xla", traversal_secondary="xla", traversal_rr="xla",
              samples_per_frame=SPF, **over)
    return JaxConfig(**BASE, **kw)


VIEW = ([0, 0.75, 2.5], [0, 0.75, 0])


def _viewpoint(r):
    r.set_viewpoint(*VIEW)


def _bad_fraction(got, want):
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    return bad.mean(), int(bad.sum())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    r = JaxRenderer(jax_config(), camera_mode="collada")
    r.load_static_scene(jax_cornell(with_spheres=True))
    _viewpoint(r)
    r.render()
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "frame1.npz")
    r.save_checkpoint(ckpt)
    r.render()
    return r.get_raw_image(), r.get_image(), ckpt


def _port_frames(cfg, scene, viewpoint, monkeypatch):
    """Render FRAMES frames on the CPU; returns (renderer, wavefront
    traces made)."""
    calls = []
    real = backends.trace_closest_wavefront
    monkeypatch.setattr(
        backends, "trace_closest_wavefront",
        lambda *a, **kw: calls.append(kw["compact"]) or real(*a, **kw))
    r = WavefrontRenderer(cfg, camera_mode="collada", device="cpu")
    r.load_static_scene(scene)
    r.set_viewpoint(*viewpoint)
    counts = (packet_dfs, "launches"), (partition, "launches"), \
        (partition, "ray_launches"), (wavefront2, "count_launches"), \
        (wavefront2, "pack_launches")
    for mod, name in counts:
        setattr(mod, name, 0)
    for _ in range(FRAMES):
        r.render()
        assert r.dropped == 0
    # the CPU runs the plain versions: no kernel launch is counted
    assert [getattr(mod, name) for mod, name in counts] == [0] * 5
    assert r.traces_per_frame == 8
    return r, calls


def _check_images(r, raw_ref, post_ref):
    raw = r.get_raw_image()
    assert raw.shape == (H, W, 3) and np.isfinite(raw).all()
    assert raw.mean() > 0.05
    frac, nbad = _bad_fraction(raw, raw_ref)
    print(f"raw image: {nbad} of {H * W} pixels outside rtol={RTOL} "
          f"atol={ATOL}")
    assert frac <= MAX_BAD
    frac, nbad = _bad_fraction(r.get_image(), post_ref)
    print(f"median-filtered image: {nbad} pixels outside")
    assert frac <= MAX_BAD


def test_frame_matches_jax_engine(jax_run, monkeypatch):
    """The preset as shipped: depths 2 and 3 trace through the
    compacted wavefront (a closest-hit and a shadow trace each)."""
    raw_ref, post_ref, _ = jax_run
    cfg = port_config()
    assert cfg.traversal_rr == "pallas"
    r, calls = _port_frames(cfg, cornell_box_scene(with_spheres=True),
                            VIEW, monkeypatch)
    assert calls == [True] * 4 * FRAMES
    _check_images(r, raw_ref, post_ref)


def test_frame_matches_jax_engine_rr_dfs(jax_run, monkeypatch):
    """The slice-1 configuration: every trace through packet-DFS."""
    raw_ref, post_ref, _ = jax_run
    r, calls = _port_frames(port_config(traversal_rr="dfs"),
                            cornell_box_scene(with_spheres=True), VIEW,
                            monkeypatch)
    assert calls == []
    _check_images(r, raw_ref, post_ref)


def test_frame_matches_jax_engine_multilevel(monkeypatch):
    """Terrain n=8 (98 triangles) under max_leaf_size=4 in both
    engines: the wavefront passes cross three levels, so the count
    kernel's function and the routing are on the frame's path."""
    view = ([0, 1.3, 1.3], [0, 0, 0])
    ref = JaxRenderer(jax_config(max_leaf_size=4), camera_mode="collada")
    ref.load_static_scene(jax_terrain(n=8))
    ref.set_viewpoint(*view)
    for _ in range(FRAMES):
        ref.render()
    r, calls = _port_frames(port_config(max_leaf_size=4), terrain_scene(n=8),
                            view, monkeypatch)
    assert len(r.scene.bvh.wf_sched) == 3
    assert calls == [True] * 4 * FRAMES
    _check_images(r, ref.get_raw_image(), ref.get_image())


def test_jax_checkpoint_resumes_in_port(jax_run, tmp_path):
    """The JAX engine's checkpoint after frame 1 loads into the port,
    which renders frame 2 to the JAX engine's 2-frame image."""
    raw_ref, _, ckpt = jax_run
    r = WavefrontRenderer(port_config(), camera_mode="collada", device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    _viewpoint(r)
    r.load_checkpoint(ckpt)
    assert (r.image_samples, r.frame_index) == (SPF, 1)
    r.render()
    frac, nbad = _bad_fraction(r.get_raw_image(), raw_ref)
    print(f"resumed image: {nbad} pixels outside")
    assert frac <= MAX_BAD
    # and the port's checkpoint keeps the JAX keys: it loads back into
    # the JAX engine
    out = tmp_path / "port.npz"
    r.save_checkpoint(str(out))
    data = np.load(out)
    assert sorted(data.files) == sorted(np.load(ckpt).files)
    back = JaxRenderer(jax_config(), camera_mode="collada")
    back.load_static_scene(jax_cornell(with_spheres=True))
    back.load_checkpoint(str(out))
    assert (back.image_samples, back.frame_index) == (SPF * FRAMES, FRAMES)
    assert np.array_equal(back.get_raw_image(), r.get_raw_image())
