"""The whole slice: the port's WavefrontRenderer against the JAX engine.

Both run the fast preset at 64x32, 2 spp per frame, 2 frames, depth 4,
NEE 1x1.0 per depth, on the Cornell box with spheres.  The port traces
with packet-DFS (its plain version on the CPU); the JAX engine traces
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
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer

from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

W, H, SPF, FRAMES = 64, 32, 2, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01

BASE = dict(width=W, height=H, total_samples=SPF * FRAMES, max_depth=4,
            nee_schedule=((1, 1.0),) * 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: with its CPU thread pool, the
    chunk of a large elementwise op that one worker thread computes has
    been seen to round differently in an occasional process (a block of
    rays' t off in the last bits, amplified by cancellation), never with
    one thread; these tests compare to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config():
    kw = fast_preset_kwargs(W, H, SPF * FRAMES)
    kw.update(traversal_rr="dfs", samples_per_frame=SPF)
    return RenderConfig(**BASE, **kw)


def jax_config():
    kw = jax_fast(W, H, SPF * FRAMES)
    kw.update(traversal="xla", traversal_secondary="xla", traversal_rr="xla",
              samples_per_frame=SPF)
    return JaxConfig(**BASE, **kw)


def _viewpoint(r):
    r.set_viewpoint([0, 0.75, 2.5], [0, 0.75, 0])


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


def test_frame_matches_jax_engine(jax_run):
    raw_ref, post_ref, _ = jax_run
    r = WavefrontRenderer(port_config(), camera_mode="collada", device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    _viewpoint(r)
    packet_dfs.launches = 0
    for _ in range(FRAMES):
        r.render()
        assert r.dropped == 0
    assert packet_dfs.launches == 0  # the CPU runs the plain version
    assert r.traces_per_frame == 8
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
