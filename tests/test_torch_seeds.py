"""Seeded bounds in the port (ops/seeds.py and the traversals' seed_t /
seed_prim), on the CPU, against the JAX package.

* ``seed_hits`` against the JAX ``seed_hits``: prims exact, t within the
  jitted tolerance, rtol 1e-5 + atol 1e-6 (run op by op, the JAX sweep
  still lands a few sphere hits 1-4 ulp off torch's, and off the JAX
  package's own trace_bruteforce, to which the port's t is bit-equal;
  the count is printed).
* Seeded DFS and wavefront traces (plain versions) against the JAX
  package's seeded Pallas traces in interpret mode, which run under jit
  (XLA's CPU fusion contracts multiply-adds): hit/miss exact, prim exact
  off ties at a bit-equal t, t within rtol 1e-5 + atol 1e-6.
* Seeded against unseeded in the port: the port's seed t is its leaf
  test's t, op for op, so the two traces agree to the bit; prims may
  differ only where two prims tie at a bit-equal t (the seed stands, an
  equal hit is no improvement).
* Seeded shadow decisions ``t > max_t - eps`` equal the oracle's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops.seeds import seed_hits as jax_seed_hits
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten

import torch

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs as pdfs
from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
from cuda_raytracer_tpu_torch.ops.seeds import seed_hits, seeded_bound
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene

JIT_RTOL, JIT_ATOL = 1e-5, 1e-6
EPS = np.float32(1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py, whose fixture
    names the rounding it once guarded against (torch's CPU float32
    ``sqrt``, now replaced by ``ops.intersect.sqrt_rn`` in the plain
    versions); these tests compare to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: name -> (port scene, JAX scene, max_leaf, ray origin box)
SCENES = {
    "box": (lambda: cornell_box_scene(with_spheres=True),
            lambda: jax_cornell(with_spheres=True), 4, 0.9),
    "terrain": (lambda: terrain_scene(n=8), lambda: jax_terrain(n=8), 4,
                0.9),
}
_cache = {}


def scenes(name):
    if name not in _cache:
        mk_port, mk_jax, ml, box = SCENES[name]
        ours, _ = flatten_scene(mk_port(), tree_width=4, max_leaf_size=ml,
                                device="cpu")
        ref, _ = jax_flatten(mk_jax(), tree_width=4, max_leaf_size=ml)
        _cache[name] = (ours, ref, box)
    return _cache[name]


def random_rays(n, seed, origin_box):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * origin_box).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _seeds(ours, o, d, valid, k=16):
    return seed_hits(ours, _t(o), _t(d), _t(valid), k=k)


def _shadow_limits(ref, o, d, valid):
    """max_t per ray: the oracle's hit t (2.0 on a miss) times 0.5 for
    every third ray (blocked) and 1.5 otherwise (reaches its light)."""
    full = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(valid))
    t_hit = np.where(np.asarray(full.prim) >= 0, np.asarray(full.t), 2.0)
    n = len(o)
    scale = np.where(np.arange(n) % 3 == 0, 0.5, 1.5)
    return (t_hit * scale).astype(np.float32), np.asarray(full.t)


@pytest.mark.parametrize("name,k", [("box", 16), ("terrain", 32)])
def test_seed_hits_match_jax(name, k):
    ours, ref, box = scenes(name)
    o, d = random_rays(2048, seed=21, origin_box=box)
    valid = np.arange(len(o)) % 7 != 0
    a = _seeds(ours, o, d, valid, k)
    b = jax_seed_hits(ref, jnp.asarray(o), jnp.asarray(d),
                      jnp.asarray(valid), k=k)
    np.testing.assert_array_equal(a.prim.numpy(), np.asarray(b.prim))
    ta, tb = a.t.numpy(), np.asarray(b.t)
    np.testing.assert_allclose(ta, tb, rtol=JIT_RTOL, atol=JIT_ATOL)
    print(f"{int((ta != tb).sum())} of {len(ta)} seed t differ in bits")
    assert (a.prim.numpy() >= 0).mean() > 0.05
    assert np.all(a.prim.numpy()[~valid] == -1)


def test_seed_hits_are_real_hits():
    """Every seed is a real hit of its prim, so an upper bound on the
    closest hit; where the closest prim is a seed prim, the seed is it."""
    ours, ref, box = scenes("box")
    o, d = random_rays(1024, seed=11, origin_box=box)
    valid = np.ones(len(o), bool)
    sd = _seeds(ours, o, d, valid, k=32)
    full = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(valid))
    st, sp = sd.t.numpy(), sd.prim.numpy()
    ft, fp = np.asarray(full.t), np.asarray(full.prim)
    hit = sp >= 0
    assert hit.mean() > 0.5
    assert np.all(st[hit] >= ft[hit])
    same = hit & (sp == fp)
    np.testing.assert_array_equal(st[same], ft[same])


def test_no_seed_rows():
    """A scene without seed rows seeds nothing (t 1e30, prim -1)."""
    ours, _, box = scenes("box")
    o, d = random_rays(64, seed=1, origin_box=box)

    class Bare:
        seed_rows = None

    sd = seed_hits(Bare(), _t(o), _t(d), torch.ones(64, dtype=torch.bool))
    assert torch.all(sd.t == 1e30) and torch.all(sd.prim == -1)


def _check(ta, pa, tb, pb, rtol=0.0, atol=0.0):
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(ta[hit].view(np.int32),
                                      tb[hit].view(np.int32))
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=rtol, atol=atol)
    differ = hit & (pa != pb)
    print(f"{hit.sum()} hits, {differ.sum()} prims differing")
    assert differ.sum() <= 0.01 * hit.sum()


def _dfs(ours, o, d, valid, t_limit=None, sd=None):
    r = pdfs.trace_closest_packets(
        ours, _t(o), _t(d), _t(valid),
        None if t_limit is None else _t(t_limit),
        seed_t=None if sd is None else sd.t,
        seed_prim=None if sd is None else sd.prim)
    assert int(r.dropped) == 0
    return r.t.numpy(), r.prim.numpy()


def _wf(ours, o, d, valid, t_limit=None, sd=None, **kw):
    r = wf.trace_closest_wavefront(
        ours, _t(o), _t(d), _t(valid),
        None if t_limit is None else _t(t_limit),
        seed_t=None if sd is None else sd.t,
        seed_prim=None if sd is None else sd.prim, **kw)
    assert int(r.dropped) == 0
    return r.t.numpy(), r.prim.numpy()


@pytest.mark.parametrize("trace", ["dfs", "wavefront", "wavefront_compact"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_seeded_matches_unseeded(name, trace):
    ours, _, box = scenes(name)
    o, d = random_rays(1024, seed=12, origin_box=box)
    valid = np.arange(len(o)) % 5 != 0
    sd = _seeds(ours, o, d, valid)
    kw = dict(compact=True) if trace == "wavefront_compact" else {}
    run = _dfs if trace == "dfs" else (
        lambda *a, **k: _wf(*a, **k, **kw))
    ta, pa = run(ours, o, d, valid)
    tb, pb = run(ours, o, d, valid, sd=sd)
    _check(tb, pb, ta, pa)
    assert (pa >= 0).sum() > 100


def test_seeded_dfs_matches_pallas_kernel(monkeypatch):
    """The seeded JAX DFS kernel (interpret mode) on terrain n=8."""
    from cuda_raytracer_tpu.ops.pallas import packet_dfs as jax_pdfs

    monkeypatch.setattr(jax_pdfs, "_INTERPRET", True)
    ours, ref, box = scenes("terrain")
    o, d = random_rays(jax_pdfs.C, seed=31, origin_box=box)
    valid = np.arange(len(o)) % 7 != 0
    sd = _seeds(ours, o, d, valid)
    ta, pa = _dfs(ours, o, d, valid, sd=sd)
    jsd = jax_seed_hits(ref, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(valid), k=16)
    res = jax_pdfs.trace_closest_packets(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        seed_t=jsd.t, seed_prim=jsd.prim)
    _check(ta, pa, np.asarray(res.t), np.asarray(res.prim), JIT_RTOL,
           JIT_ATOL)


def test_seeded_wavefront_matches_pallas_kernels(monkeypatch):
    """The seeded JAX wavefront (interpret-mode Pallas) on the box scene,
    closest-hit and shadow (want_prim=False)."""
    from cuda_raytracer_tpu.ops.pallas import wavefront2 as jax_wf2

    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref, box = scenes("box")
    o, d = random_rays(jax_wf2.CHUNK, seed=32, origin_box=box)
    valid = np.arange(len(o)) % 5 != 0
    sd = _seeds(ours, o, d, valid)
    jsd = jax_seed_hits(ref, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(valid), k=16)
    ta, pa = _wf(ours, o, d, valid, sd=sd)
    res = jax_wf2.trace_closest_wavefront(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        seed_t=jsd.t, seed_prim=jsd.prim)
    _check(ta, pa, np.asarray(res.t), np.asarray(res.prim), JIT_RTOL,
           JIT_ATOL)
    # the walls seed most rays here: their keys start from the seed
    assert (pa >= 0).mean() > 0.4


@pytest.mark.parametrize("trace", ["dfs", "wavefront"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_seeded_shadow_decision(name, trace):
    ours, ref, box = scenes(name)
    o, d = random_rays(1024, seed=13, origin_box=box)
    valid = np.arange(len(o)) % 9 != 0
    max_t, full_t = _shadow_limits(ref, o, d, valid)
    sd = _seeds(ours, o, d, valid)
    if trace == "dfs":
        t, p = _dfs(ours, o, d, valid, max_t, sd)
    else:
        t, p = _wf(ours, o, d, valid, max_t, sd, want_prim=False)
        assert set(np.unique(p)) <= {-2, -1}
    got = t > max_t - EPS
    np.testing.assert_array_equal(got, full_t > max_t - EPS)
    assert 0 < got.sum() < len(o)


def test_seeded_bound():
    """The start bound: min(limit, 1e30, seed); -1 where the seed lands
    kill_eps short of the limit (a shadow ray answered untraced)."""
    seed = torch.tensor([0.5, 2.0, 1e30, 0.9995, float("nan")])
    lim = torch.tensor([1.0, 1.0, 3.0, 1.0, 1.0])
    np.testing.assert_array_equal(
        seeded_bound(seed, lim, 1e-3).numpy(),
        np.float32([-1.0, 1.0, 3.0, 0.9995, float("nan")]))
    np.testing.assert_array_equal(
        seeded_bound(seed).numpy(),
        np.float32([0.5, 2.0, 1e30, 0.9995, float("nan")]))
