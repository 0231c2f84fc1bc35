"""The port's traversal-backend factory: which pass gets which trace,
and what raises until it is ported.  The two ported backends must agree
on the same rays (hit/miss, t to the bit, shadow decisions)."""

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.render.backends import make_trace_fn
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    s, _ = flatten_scene(terrain_scene(n=8), tree_width=4, max_leaf_size=4,
                         device="cpu")
    return s


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, 0.3, -1.0], [1.0, 0.8, 1.0], (n, 3))
    d = rng.standard_normal((n, 3))
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32),
            torch.arange(n) % 4 != 0)


PASSES = {
    "camera": dict(),
    "secondary": dict(secondary=True),
    "compacted": dict(secondary=True, compact=True),
    "rr_dense": dict(secondary=True, rr_dense=True),
}


@pytest.mark.parametrize("which", sorted(PASSES))
def test_pallas_backend_traces_unseeded_passes(scene, which):
    """traversal*="pallas" with seed_k=0: every class of pass runs the
    wavefront and agrees with the DFS backend on the same rays."""
    wf_cfg = RenderConfig(traversal="pallas", traversal_secondary="pallas",
                          traversal_rr="pallas", seed_k=0)
    dfs_cfg = RenderConfig(traversal="dfs", traversal_secondary="dfs",
                           traversal_rr="dfs", seed_k=0)
    o, d, valid = _rays(512, 3)
    a = make_trace_fn(wf_cfg, **PASSES[which])(scene, o, d, valid)
    b = make_trace_fn(dfs_cfg, **PASSES[which])(scene, o, d, valid)
    assert int(a.dropped) == 0 and int((a.prim >= 0).sum()) > 100
    assert torch.equal(a.prim < 0, b.prim < 0)
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    # a shadow pass: prim ids are not decoded, decisions agree
    max_t = torch.where(b.prim >= 0, b.t, 2.0) * torch.where(
        torch.arange(512) % 3 == 0, 0.5, 1.5)
    sa = make_trace_fn(wf_cfg, **PASSES[which])(scene, o, d, valid, max_t)
    sb = make_trace_fn(dfs_cfg, **PASSES[which])(scene, o, d, valid, max_t)
    assert set(sa.prim.unique().tolist()) <= {-2, -1}
    assert torch.equal(sa.t > max_t - 1e-3, sb.t > max_t - 1e-3)


def test_compacted_pass_is_never_seeded(scene):
    """The fast preset's seed_k=16 does not touch the compacted passes
    (the only wavefront passes of the preset): they trace."""
    cfg = RenderConfig(traversal="dfs", traversal_secondary="dfs",
                       traversal_rr="pallas", seed_k=16)
    o, d, valid = _rays(256, 4)
    res = make_trace_fn(cfg, secondary=True, compact=True)(scene, o, d, valid)
    assert int((res.prim >= 0).sum()) > 50


@pytest.mark.parametrize("kw,cfg_kw", [
    (dict(secondary=True), dict(traversal_secondary="pallas", seed_k=16)),
    (dict(), dict(traversal="pallas", seed_k=16, seed_primary=True)),
])
def test_seeded_wavefront_pass_raises(scene, kw, cfg_kw):
    """A pass the JAX package would seed raises, naming the item."""
    trace = make_trace_fn(RenderConfig(**cfg_kw), **kw)
    o, d, valid = _rays(64, 5)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        trace(scene, o, d, valid)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="slab_bf16"):
        make_trace_fn(RenderConfig(traversal="pallas", slab_bf16=True))
    with pytest.raises(NotImplementedError, match="slab_bf16"):
        make_trace_fn(RenderConfig(traversal="dfs", slab_bf16=True))
    # "xla" is ported (ops/traverse.py), and takes no bf16 slabs
    make_trace_fn(RenderConfig(traversal="xla", slab_bf16=True))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        make_trace_fn(RenderConfig(traversal="dfs", seed_primary=True))
    # the camera pass of a pallas config is unseeded by default
    make_trace_fn(RenderConfig(traversal="pallas"))
