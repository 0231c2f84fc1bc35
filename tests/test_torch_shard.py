"""The port's sharded frames (parallel/shard.py) against the JAX package's.

The JAX package shards over its 8 virtual CPU devices (tests/conftest.py);
the port's mesh is 8 ``cpu`` entries, one shard each, on the one CPU
device.  Setup of tests/test_shard.py: the Cornell box with spheres,
32x16, 8 spp per frame, depth 2, NEE 1x1.0.  The port traces with its
plain DFS and the JAX package with its XLA traversal (``"auto"`` on the
CPU), so, as in tests/test_torch_engine.py, a pixel may differ by float
rounding (or outright where the rounding flips a path).  Held: per pixel
rtol 1e-4, atol 1e-5, at most 1% of pixels outside, reported.  Three JAX
sharded frame functions are compiled, once each (module fixtures): a
samples-mode frame, a tiles-mode frame in tiles32s order, and a
ShardedRenderer in tiles mode whose tiles8 slabs fall back to raster.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.parallel import shard as jax_shard
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten

from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.parallel import shard
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene

from test_torch_collada import document
from torch_threads import _one_torch_thread  # noqa: F401

NDEV = 8
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
BASE = dict(width=32, height=16, samples_per_frame=NDEV, max_depth=2,
            nee_schedule=((1, 1.0), (1, 1.0)))
#: (shard_mode, config fields) of the two direct frames
CASES = {
    "samples": ("samples", {}),
    "tiles": ("tiles", dict(sample_order="tiles32s", rng_granule=128)),
}
TAN_H = math.tan(math.radians(50.0) / 2)
TAN_V = math.tan(math.radians(35.0) / 2)
CAM = (np.array([0.0, 0.75, 2.5], np.float32), np.eye(3, dtype=np.float32))
VIEW = ([0.0, 0.75, 2.5], [0.0, 0.75, 0.0])
MESH = ["cpu"] * NDEV


def _bad(got, want):
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside rtol={RTOL} "
          f"atol={ATOL}")
    return float(bad.mean())


@pytest.fixture(scope="module")
def jax_mesh():
    devs = jax.devices("cpu")
    if len(devs) < NDEV:
        pytest.skip(f"need {NDEV} virtual devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:NDEV]), ("rays",))


@pytest.fixture(scope="module")
def port_scene():
    return flatten_scene(cornell_box_scene(with_spheres=True),
                         device="cpu")[0]


@pytest.fixture(scope="module")
def jax_frames(jax_mesh):
    """The JAX package's direct frames, keys 7 and 11, one jit each."""
    scene, _ = jax_flatten(jax_cornell(with_spheres=True))
    cam = tuple(jnp.asarray(a) for a in CAM)
    out = {}
    for seed, (name, (mode, over)) in zip((7, 11), CASES.items()):
        cfg = JaxConfig(**BASE, shard_mode=mode, **over)
        frame = jax.jit(lambda s, c, k, cfg=cfg: jax_shard.render_frame_sharded(
            jax_mesh, s, cfg, c, k, TAN_H, TAN_V))
        out[name] = np.asarray(frame(scene, cam, jax.random.PRNGKey(seed)))
    return out


def _config(mode, **over):
    return RenderConfig(**BASE, shard_mode=mode, **over)


@pytest.mark.parametrize("name", list(CASES))
def test_frame_matches_jax(name, jax_frames, port_scene):
    mode, over = CASES[name]
    key = rng.PRNGKey(7 if name == "samples" else 11)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # tiles32s slabs: no fallback
        img = shard.render_frame_sharded(
            shard.make_render_mesh(MESH), port_scene, _config(mode, **over),
            CAM, key, TAN_H, TAN_V)
    img = img.numpy()
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _bad(img, jax_frames[name]) <= MAX_BAD
    # ShardedRenderer.compile's one-frame function is the same frame
    frame = shard.ShardedRenderer(_config(mode, **over), MESH).compile(
        port_scene, 50.0, 35.0)
    assert np.array_equal(frame(port_scene, CAM, key).numpy(), img)


@pytest.mark.parametrize("mode", ["samples", "tiles"])
def test_shards_equal_chunks(mode, port_scene):
    """samples: the frame is the mean of the shards' chunks, each traced
    alone with fold_in(key, i); tiles: each slab equals the slab traced
    alone (in tiles32s order within the slab)."""
    cfg = _config(mode, sample_order="tiles32s", rng_granule=128)
    key = rng.PRNGKey(13)
    img = shard.render_frame_sharded(shard.make_render_mesh(MESH),
                                     port_scene, cfg, CAM, key, TAN_H,
                                     TAN_V).numpy()
    if mode == "samples":
        chunks = [shard._render_chunk(port_scene, cfg, CAM,
                                      rng.fold_in(key, i), TAN_H, TAN_V, 1)
                  for i in range(NDEV)]
        np.testing.assert_allclose(img, torch.stack(chunks).mean(0).numpy(),
                                   rtol=1e-6, atol=0)
        return
    rows = cfg.height // NDEV
    slab_cfg = shard._slab_config(cfg, rows)
    assert slab_cfg.sample_order == "tiles32s"
    for i in (0, 3, NDEV - 1):
        slab, dropped = shard._trace_slab(
            port_scene, slab_cfg, CAM, rng.fold_in(key, i), TAN_H, TAN_V,
            cfg.samples_per_frame, row_offset=i * rows,
            full_height=cfg.height)
        assert int(dropped) == 0
        assert np.array_equal(img[i * rows:(i + 1) * rows], slab.numpy())


def test_chip_rng_streams_disjoint(port_scene):
    """Different shards trace different samples of the same estimator."""
    cfg = _config("samples")
    key = rng.PRNGKey(3)
    imgs = [shard._render_chunk(port_scene, cfg, CAM, rng.fold_in(key, i),
                                TAN_H, TAN_V, 1).numpy() for i in range(3)]
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])
    means = [im.mean() for im in imgs]
    assert max(means) < 3 * min(means) + 1e-3


def _renderer(cls, cfg, mesh):
    r = cls(cfg, mesh, camera_mode="canonical")
    r.load_static_scene((jax_cornell if cls is jax_shard.ShardedRenderer
                         else cornell_box_scene)(with_spheres=True))
    r.set_viewpoint(*VIEW)
    return r


#: tiles mode in tiles8 order: 2-row slabs fall back to raster; the median
#: filter is on below 16 spp, so after the first frame only
RENDERER = dict(BASE, total_samples=2 * NDEV, shard_mode="tiles",
                sample_order="tiles8", post_process_threshold=2 * NDEV)


@pytest.fixture(scope="module")
def jax_renderer(jax_mesh, tmp_path_factory):
    """The JAX ShardedRenderer's two frames: (raw and displayed image after
    each, its checkpoint after frame 1, the renderer)."""
    sr = _renderer(jax_shard.ShardedRenderer, JaxConfig(**RENDERER),
                   jax_mesh)
    with pytest.warns(UserWarning, match="falls back to raster"):
        sr.render()
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "frame1.npz")
    sr.save_checkpoint(ckpt)
    frames = [(sr.get_raw_image(), sr.get_image())]
    sr.render()
    frames.append((sr.get_raw_image(), sr.get_image()))
    return frames, ckpt, sr


def test_sharded_renderer_matches_jax(jax_renderer, tmp_path):
    """Two accumulated frames (tiles8 slabs falling back to raster, with
    the warning in both packages; the median filter gated by
    post_process_threshold as in JAX), and checkpoints that cross between
    the packages."""
    frames, jax_ckpt, jax_sr = jax_renderer
    sr = _renderer(shard.ShardedRenderer, RenderConfig(**RENDERER), MESH)
    with pytest.warns(UserWarning, match="falls back to raster"):
        sr.render()
    assert sr.dropped == 0 and sr.image_samples == NDEV
    raw1, img1 = sr.get_raw_image(), sr.get_image()
    assert not np.array_equal(img1, raw1)  # median-filtered below 16 spp
    assert _bad(raw1, frames[0][0]) <= MAX_BAD
    assert _bad(img1, frames[0][1]) <= MAX_BAD
    port_ckpt = str(tmp_path / "port.npz")
    sr.save_checkpoint(port_ckpt)
    sr.render()
    raw2 = sr.get_raw_image()
    assert sr.image_samples == 2 * NDEV and not np.array_equal(raw1, raw2)
    assert np.array_equal(sr.get_image(), raw2)  # 16 spp: no filter
    assert _bad(raw2, frames[1][0]) <= MAX_BAD

    # the JAX checkpoint resumes in the port: frame 2 as JAX renders it
    resumed = _renderer(shard.ShardedRenderer, RenderConfig(**RENDERER),
                        MESH)
    resumed.load_checkpoint(jax_ckpt)
    assert (resumed.image_samples, resumed.frame_index) == (NDEV, 1)
    assert np.array_equal(resumed.get_raw_image(), frames[0][0])
    resumed.render()
    assert _bad(resumed.get_raw_image(), frames[1][0]) <= MAX_BAD
    # and the port's resumes in JAX's: frame 2 as the port renders it
    jax_sr.load_checkpoint(port_ckpt)
    assert (jax_sr.image_samples, jax_sr.frame_index) == (NDEV, 1)
    assert np.array_equal(jax_sr.get_raw_image(), raw1)
    jax_sr.render()
    assert _bad(jax_sr.get_raw_image(), raw2) <= MAX_BAD
    assert sorted(np.load(port_ckpt).files) == sorted(np.load(jax_ckpt).files)

    # reset-on-move clears accumulation
    sr.set_viewpoint([0.0, 0.8, 2.4], [0.0, 0.7, 0.0])
    assert sr.image_samples == 0


def test_cutracer_mode_refused(jax_mesh, tmp_path):
    """The JAX ShardedRenderer takes camera_mode='cutracer' and fails in
    its first frame (it unpacks the cutracer camera's four arrays as
    pos, c2w); the port refuses the mode up front, naming it."""
    with pytest.raises(ValueError, match="cutracer"):
        shard.ShardedRenderer(RenderConfig(**BASE), MESH,
                              camera_mode="cutracer")
    path = str(tmp_path / "scene.dae")
    with open(path, "w") as f:
        f.write(document())
    sr = jax_shard.ShardedRenderer(JaxConfig(**BASE), jax_mesh,
                                   camera_mode="cutracer")
    sr.load_scene(path)
    with pytest.raises(ValueError, match="unpack"):
        sr.render()


def test_make_render_mesh(monkeypatch):
    assert shard.make_render_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one"):
        shard.make_render_mesh([])
    with pytest.raises(ValueError, match="does not divide over 3"):
        shard._shard_setup([torch.device("cpu")] * 3, _config("tiles"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.make_render_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.ShardedRenderer(RenderConfig(**BASE))
