"""The port's traversal-backend factory: which pass gets which trace,
with which seeds and box test.  The two kernel backends must agree on
the same rays (hit/miss, t to the bit, shadow decisions), seeded or
not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.render import backends
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
def test_seeded_wavefront_pass_raises(scene, kw, cfg_kw, monkeypatch):
    """A pass the JAX package seeds (since the seeds are ported it no
    longer raises): it seeds, and it equals the unseeded pass, closest
    hit and shadow decisions (the seed t is the leaf test's t, so t is
    bit-equal; prims may differ only at a tie of bit-equal t)."""
    seeded = []
    real = backends.seed_hits
    monkeypatch.setattr(backends, "seed_hits",
                        lambda *a, **k: seeded.append(1) or real(*a, **k))
    o, d, valid = _rays(512, 5)
    a = make_trace_fn(RenderConfig(**cfg_kw), **kw)(scene, o, d, valid)
    assert seeded == [1]
    b = make_trace_fn(RenderConfig(**{**cfg_kw, "seed_k": 0}), **kw)(
        scene, o, d, valid)
    assert seeded == [1]
    assert int(a.dropped) == 0 and int((a.prim >= 0).sum()) > 100
    assert torch.equal(a.prim < 0, b.prim < 0)
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    assert int(((a.prim != b.prim) & (a.prim >= 0)).sum()) <= 5
    max_t = torch.where(b.prim >= 0, b.t, 2.0) * torch.where(
        torch.arange(512) % 3 == 0, 0.5, 1.5)
    sa = make_trace_fn(RenderConfig(**cfg_kw), **kw)(scene, o, d, valid,
                                                     max_t)
    sb = make_trace_fn(RenderConfig(**{**cfg_kw, "seed_k": 0}), **kw)(
        scene, o, d, valid, max_t)
    assert seeded == [1, 1]
    assert torch.equal(sa.t > max_t - 1e-3, sb.t > max_t - 1e-3)


#: the table of (pass, config) make_trace_fn is held on: every pass
#: class under each backend, with and without seed_primary and slab_bf16
SEED_TABLE = [
    (which, dict(traversal=kind, traversal_secondary=kind,
                 traversal_rr=kind, seed_primary=primary,
                 slab_bf16=bf16))
    for which in sorted(PASSES)
    for kind in ("dfs", "pallas")
    for primary in (False, True)
    for bf16 in (False, True)
] + [(which, dict(traversal="xla", seed_primary=True, slab_bf16=True))
     for which in sorted(PASSES)]


def _options_seen(backend_mod, cfg_cls, scene, table):
    """What each (pass, config) hands its traversal: (seeded, bf16), with
    the backend module's traversals replaced by recorders."""
    seen = []

    def packets(*a, slab_bf16=False, seed_t=None, **k):
        seen.append(("dfs", seed_t is not None, slab_bf16))
        return "dfs"

    def wavefront(*a, box_bf16=False, seed_t=None, **k):
        seen.append(("pallas", seed_t is not None, box_bf16))
        return "pallas"

    def xla(*a, **k):
        seen.append(("xla", False, False))
        return "xla"

    saved = (backend_mod.trace_closest_packets,
             backend_mod.trace_closest_wavefront, backend_mod.trace_closest)
    (backend_mod.trace_closest_packets, backend_mod.trace_closest_wavefront,
     backend_mod.trace_closest) = packets, wavefront, xla
    try:
        o, d, valid = _rays(64, 7)
        if cfg_cls is not RenderConfig:
            o, d, valid = (jnp.asarray(x.numpy()) for x in (o, d, valid))
        for which, cfg_kw in table:
            trace = backend_mod.make_trace_fn(cfg_cls(seed_k=16, **cfg_kw),
                                              **PASSES[which])
            trace(scene, o, d, valid)
    finally:
        (backend_mod.trace_closest_packets,
         backend_mod.trace_closest_wavefront,
         backend_mod.trace_closest) = saved
    return seen


def test_unported_options_raise(scene):
    """Nothing raises any more (slab_bf16 and the seeds are ported):
    make_trace_fn hands each pass exactly the seeds and the bf16 switch
    the JAX package's make_trace_fn hands it (its seeds_for: no seeds for
    compacted or rr_dense passes, nor for DFS passes or the camera pass
    unless seed_primary; "xla" takes neither), over every pass class,
    backend, seed_primary and slab_bf16."""
    from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
    from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
    from cuda_raytracer_tpu.render import backends as jax_backends
    from cuda_raytracer_tpu.render.flatscene import flatten_scene as jflat

    ref, _ = jflat(jax_terrain(n=8), tree_width=4, max_leaf_size=4)
    ours = _options_seen(backends, RenderConfig, scene, SEED_TABLE)
    theirs = _options_seen(jax_backends, JaxConfig, ref, SEED_TABLE)
    assert ours == theirs
    seeded = [(which, cfg["traversal"], cfg["seed_primary"])
              for (which, cfg), (_, s, _) in zip(SEED_TABLE, ours) if s]
    assert sorted(set(seeded)) == [
        ("camera", "dfs", True), ("camera", "pallas", True),
        ("secondary", "dfs", True), ("secondary", "pallas", False),
        ("secondary", "pallas", True)]
