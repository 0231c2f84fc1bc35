"""The port's ``"xla"`` traversal (ops/traverse.py, torch ops) against the
JAX package's trace_bruteforce and trace_closest, and tree width 16
through the port's ``"auto"``.

Scene: terrain n=8 under max_leaf_size=4 (98 prims), at tree widths 4,
8 and 16, 2,048 rays (a quarter invalid).  Tolerances: hit/miss exact;
prim exact except where two prims tie at a bit-equal t; t bit-equal to
the JAX trace_bruteforce (its jnp ops run one by one and round as torch
does); against the jitted JAX trace_closest, rtol=1e-5 + atol=1e-6
(XLA's CPU fusion contracts FMAs); dropped == 0.  The frame at width 16
is held per pixel against the JAX CPU engine, whose ``"auto"`` is this
traversal off the TPU: rtol=1e-4, atol=1e-5 on at least 99% of pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops import traverse as jtr
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten

from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import traverse as tr
from cuda_raytracer_tpu_torch.render.backends import make_trace_fn
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene

N_RAYS = 2048
JIT_RTOL, JIT_ATOL = 1e-5, 1e-6
PIX_RTOL, PIX_ATOL, MAX_BAD = 1e-4, 1e-5, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py, whose fixture
    names the rounding it once guarded against (torch's CPU float32
    ``sqrt``, now replaced by ``ops.intersect.sqrt_rn`` in the plain
    versions); these tests compare t to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_scenes = {}


def scenes(width):
    if width not in _scenes:
        ours, _ = flatten_scene(terrain_scene(n=8), tree_width=width,
                                max_leaf_size=4, device="cpu")
        ref, _ = jax_flatten(jax_terrain(n=8), tree_width=width,
                             max_leaf_size=4)
        _scenes[width] = (ours, ref)
    return _scenes[width]


def rays(n, seed):
    """Rays from above the terrain, mostly downward, and a quarter of the
    lanes invalid."""
    g = np.random.default_rng(seed)
    o = g.uniform([-0.9, 0.1, -0.9], [0.9, 0.9, 0.9], (n, 3))
    d = g.standard_normal((n, 3)) + [0.0, -3.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = np.arange(n) % 4 != 0
    return o.astype(np.float32), d.astype(np.float32), valid


def check_closest(ta, pa, tb, pb, rtol=0.0, atol=0.0):
    """rtol = atol = 0: t bit-equal.  Prims may differ only at a tie."""
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(ta[hit].view(np.int32),
                                      tb[hit].view(np.int32))
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=rtol, atol=atol)
    differ = hit & (pa != pb)
    assert np.array_equal(ta[differ], tb[differ]), "prim differs off a tie"


def _port(fn, scene, o, d, valid, *args):
    r = fn(scene, torch.from_numpy(o), torch.from_numpy(d),
           torch.from_numpy(valid), *args)
    return r.t.numpy(), r.prim.numpy(), int(r.dropped)


def _jax(fn, scene, o, d, valid, *args):
    r = fn(scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid), *args)
    return np.asarray(r.t), np.asarray(r.prim), int(r.dropped)


@pytest.mark.parametrize("width", [4, 8, 16])
def test_traces_match_jax(width):
    ours, ref = scenes(width)
    assert ours.bvh.width == width and ours.bvh.num_levels > 1
    o, d, valid = rays(N_RAYS, seed=width)
    ta, pa, dropped = _port(tr.trace_closest, ours, o, d, valid, 2)
    assert dropped == 0
    # invalid rays miss
    assert np.all(pa[~valid] == -1) and np.all(np.isinf(ta[~valid]))
    assert (pa >= 0).sum() > N_RAYS // 2
    tbf, pbf, _ = _port(tr.trace_bruteforce, ours, o, d, valid)
    tj, pj, _ = _jax(jtr.trace_bruteforce, ref, o, d, valid)
    # the port's brute force is the JAX one, op for op
    np.testing.assert_array_equal(tbf.view(np.int32), tj.view(np.int32))
    np.testing.assert_array_equal(pbf, pj)
    check_closest(ta, pa, tj, pj)
    tc, pc, jdropped = _jax(jtr.trace_closest, ref, o, d, valid, 2)
    assert jdropped == 0
    check_closest(ta, pa, tc, pc, JIT_RTOL, JIT_ATOL)


def test_queue_overflow_counted():
    """A queue too small for its entries (capacity N, grazing rays that
    enter several boxes per level) counts what it cuts off, as the JAX
    traversal counts it, and keeps the hits of the entries it holds."""
    ours, ref = scenes(4)
    g = np.random.default_rng(3)
    n = 256
    o = np.stack([np.full(n, -1.1), g.uniform(-0.02, 0.02, n),
                  g.uniform(-0.9, 0.9, n)], 1).astype(np.float32)
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    valid = np.ones(n, bool)
    ta, pa, dropped = _port(tr.trace_closest, ours, o, d, valid, 1)
    tc, pc, jdropped = _jax(jtr.trace_closest, ref, o, d, valid, 1)
    assert dropped == jdropped > 0
    check_closest(ta, pa, tc, pc, JIT_RTOL, JIT_ATOL)


def test_auto_routes_wide_trees():
    """``"auto"`` sends a tree wider than 8 to the torch traversal (as the
    JAX DFS sends it away); an explicit "dfs" or "pallas" raises there."""
    ours, _ = scenes(16)
    o, d, valid = rays(256, seed=4)
    want = _port(tr.trace_closest, ours, o, d, valid, 2)
    got = _port(make_trace_fn(RenderConfig(traversal="auto")), ours, o, d,
                valid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    xla = make_trace_fn(RenderConfig(traversal="xla"))
    # shadow passes take a t_limit, which the "xla" traversal ignores
    got = _port(xla, ours, o, d, valid, torch.full((256,), 0.1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for kind in ("dfs", "pallas"):
        with pytest.raises(ValueError, match="width"):
            _port(make_trace_fn(RenderConfig(traversal=kind)), ours, o, d,
                  valid)


def test_width16_frame_matches_jax():
    """One frame at tree width 16 (16x12, 2 spp, depth 3) through the
    port's "auto" against the JAX CPU engine."""
    kw = dict(width=16, height=12, samples_per_frame=2, total_samples=2,
              tree_width=16, max_leaf_size=4, max_depth=3)
    view = ([0, 1.3, 1.3], [0, 0, 0])
    ref = JaxRenderer(JaxConfig(**kw))
    ref.load_static_scene(jax_terrain(n=8))
    ref.set_viewpoint(*view)
    ref.render()
    r = WavefrontRenderer(RenderConfig(**kw), device="cpu")
    r.load_static_scene(terrain_scene(n=8))
    r.set_viewpoint(*view)
    r.render()
    assert r.dropped == 0
    got, want = r.get_raw_image(), np.asarray(ref.get_raw_image())
    assert float(want.mean()) > 0.0
    bad = ~np.isclose(got, want, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside the tolerance")
    assert bad.mean() <= MAX_BAD
