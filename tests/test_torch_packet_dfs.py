"""The port's DFS traversal (its plain version, on the CPU) against the
JAX package's oracles, trace_bruteforce and trace_closest.

The CUDA kernel runs the same per-ray DFS in the same op order; it is
held against this plain version on the card by chip_smoke.py.

Tolerances: hit/miss exact; prim exact except where two prims tie at a
bit-equal t (the DFS keeps the first group's winner, the oracle the
lowest index); shadow decisions ``t > max_t - eps`` exact; invalid
lanes miss; dropped == 0.  t within rtol=1e-6 of trace_bruteforce,
whose jnp ops run one by one and round as torch does (the same
packed_prim_test, op for op: seen bit-equal).  trace_closest
and interpret-mode Pallas run under jit, where XLA's CPU fusion
contracts multiply-adds into FMAs; the plane offset g.w - g.o cancels,
so the gap is absolute (seen: 1.1e-7 at t = 0.002, 5e-5 relative) and
is held to rtol=1e-5 with atol=1e-6.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce, trace_closest
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse

import torch

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs as pdfs
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF


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


def _soup(mod, bsdf):
    rng = np.random.default_rng(5)
    ntri = 1200
    base = rng.random((ntri, 3)) * 4 - 2
    v = base[:, None, :] + rng.random((ntri, 3, 3)) * 0.3
    mesh = mod.Mesh(
        v.reshape(-1, 3),
        np.tile([[0.0, 0.0, 1.0]], (ntri * 3, 1)),
        np.arange(ntri * 3).reshape(-1, 3),
        bsdf([1, 1, 1]),
    )
    return mod.Scene([mesh], [])


#: name -> (port scene, JAX scene, tree_width, max_leaf, ray origin box)
SCENES = {
    "box": (lambda: cornell_box_scene(with_spheres=True),
            lambda: jax_cornell(with_spheres=True), 4, 4, 0.9),
    "soup": (lambda: _soup(st, DiffuseBSDF), lambda: _soup(jst, JaxDiffuse),
             4, 8, 3.0),
    "terrain": (lambda: terrain_scene(n=20), lambda: jax_terrain(n=20),
                8, 8, 1.0),
}
_cache = {}


def scenes(name):
    if name not in _cache:
        mk_port, mk_jax, w, ml, box = SCENES[name]
        ours, _ = flatten_scene(mk_port(), tree_width=w, max_leaf_size=ml,
                                device="cpu")
        ref, _ = jax_flatten(mk_jax(), tree_width=w, max_leaf_size=ml)
        _cache[name] = (ours, ref, box)
    return _cache[name]


def random_rays(n, seed, origin_box):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * origin_box).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _port_trace(scene, o, d, valid, t_limit=None):
    res = pdfs.trace_closest_packets(
        scene, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(valid),
        None if t_limit is None else torch.from_numpy(t_limit),
    )
    return res.t.numpy(), res.prim.numpy(), int(res.dropped)


def _jax_trace(fn, scene, o, d, valid):
    r = fn(scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid))
    return np.asarray(r.t), np.asarray(r.prim)


#: against jitted JAX (trace_closest, interpret-mode Pallas)
JIT_RTOL, JIT_ATOL = 1e-5, 1e-6


def check_closest(ta, pa, tb, pb, rtol, atol=0.0):
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    gap = np.abs(ta[hit].view(np.int32).astype(np.int64)
                 - tb[hit].view(np.int32).astype(np.int64))
    print(f"{hit.sum()} hits, max t ulp gap {gap.max() if gap.size else 0}")
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=rtol, atol=atol)
    differ = hit & (pa != pb)
    assert np.array_equal(ta[differ], tb[differ]), "prim differs off a tie"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_matches_oracles(name):
    ours, ref, box = scenes(name)
    o, d = random_rays(1024, seed=1, origin_box=box)
    valid = np.arange(len(o)) % 5 != 0
    ta, pa, dropped = _port_trace(ours, o, d, valid)
    assert dropped == 0
    assert np.all(pa[~valid] == -1) and np.all(np.isinf(ta[~valid]))
    assert (pa >= 0).sum() > 50
    tb, pb = _jax_trace(trace_bruteforce, ref, o, d, valid)
    check_closest(ta, pa, tb, pb, rtol=1e-6)
    if name == "soup":  # the deepest tree; trace_closest compiles per scene
        tb, pb = _jax_trace(trace_closest, ref, o, d, valid)
        check_closest(ta, pa, tb, pb, JIT_RTOL, JIT_ATOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shadow_decisions_match(name):
    """Shadow mode (t_limit + kill) decides t > max_t - eps exactly as a
    full closest-hit trace of the oracle does."""
    ours, ref, box = scenes(name)
    o, d = random_rays(1024, seed=6, origin_box=box)
    n = len(o)
    valid = np.ones(n, bool)
    tb, pb = _jax_trace(trace_bruteforce, ref, o, d, valid)
    t_hit = np.where(pb >= 0, tb, 2.0).astype(np.float32)
    scale = np.where(np.arange(n) % 3 == 0, 0.5, 1.5).astype(np.float32)
    max_t = t_hit * scale
    ta, pa, dropped = _port_trace(ours, o, d, valid, max_t)
    assert dropped == 0
    eps = np.float32(1e-3)
    np.testing.assert_array_equal(ta > max_t - eps, tb > max_t - eps)
    # some rays are blocked, some reach their light
    assert 0 < (ta > max_t - eps).sum() < n


def test_matches_pallas_kernel(monkeypatch):
    """The JAX package's own DFS kernel (Pallas, run in interpret mode as
    its tests run it), on one 1024-ray packet of the box scene: hit/miss
    and prim exact (ties at bit-equal t aside), t within the jitted
    tolerance (interpret mode runs under jit)."""
    from cuda_raytracer_tpu.ops.pallas import packet_dfs as jax_pdfs

    monkeypatch.setattr(jax_pdfs, "_INTERPRET", True)
    ours, ref, box = scenes("box")
    o, d = random_rays(jax_pdfs.C, seed=12, origin_box=box)
    valid = np.ones(len(o), bool)
    ta, pa, _ = _port_trace(ours, o, d, valid)
    res = jax_pdfs.trace_closest_packets(ref, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(valid))
    assert int(res.dropped) == 0
    check_closest(ta, pa, np.asarray(res.t), np.asarray(res.prim),
                  JIT_RTOL, JIT_ATOL)
    assert (pa >= 0).sum() > 500


def test_stack_overflow_counted(monkeypatch):
    """A stack too small for the tree counts the rays it cuts off in
    dropped instead of writing past the stack."""
    ours, _, box = scenes("soup")
    o, d = random_rays(1024, seed=9, origin_box=box)
    valid = np.ones(len(o), bool)
    _, _, dropped = _port_trace(ours, o, d, valid)
    assert dropped == 0
    monkeypatch.setattr(pdfs, "STACK_CAP", 1)
    _, _, dropped = _port_trace(ours, o, d, valid)
    assert dropped > 0


def test_visit_cap_counted(monkeypatch):
    ours, _, box = scenes("soup")
    o, d = random_rays(1024, seed=9, origin_box=box)
    monkeypatch.setattr(pdfs, "MAX_VISITS", 2)
    _, _, dropped = _port_trace(ours, o, d, np.ones(len(o), bool))
    assert dropped > 0


def test_root_leaf_scene():
    """A root-is-leaf tree traverses through the synthesized leaf row."""
    ours, _ = flatten_scene(cornell_box_scene(with_spheres=False),
                            tree_width=4, max_leaf_size=64, device="cpu")
    ref, _ = jax_flatten(jax_cornell(with_spheres=False), tree_width=4,
                         max_leaf_size=64)
    assert ours.bvh.root_is_leaf
    o, d = random_rays(1024, seed=2, origin_box=0.9)
    valid = np.ones(len(o), bool)
    ta, pa, _ = _port_trace(ours, o, d, valid)
    tb, pb = _jax_trace(trace_bruteforce, ref, o, d, valid)
    check_closest(ta, pa, tb, pb, rtol=1e-6)


def test_cuda_tensors_never_take_plain_path(monkeypatch):
    """The wrapper's device dispatch: CPU tensors run the plain version,
    anything else goes to the kernel launch (which raises without a
    card) — no try/fallback between them."""
    ours, _, box = scenes("box")
    o, d = random_rays(256, seed=3, origin_box=box)
    valid = np.ones(len(o), bool)
    real_cuda, real_plain = pdfs.dfs_trace_cuda, pdfs.dfs_trace_plain
    calls = []
    monkeypatch.setattr(pdfs, "dfs_trace_cuda",
                        lambda *a: calls.append("cuda"))
    monkeypatch.setattr(
        pdfs, "dfs_trace_plain",
        lambda *a: calls.append("plain") or real_plain(*a),
    )
    launches = pdfs.launches
    _port_trace(ours, o, d, valid)
    assert calls == ["plain"]
    assert pdfs.launches == launches  # the plain version is no launch

    b = ours.bvh
    with pytest.raises(ValueError, match="CUDA"):
        real_cuda(torch.from_numpy(o), torch.from_numpy(d),
                  torch.from_numpy(valid), None, b.dfs_node_rows,
                  b.dfs_prim_rows, b.node_meta, b.width, 1e-3)


def test_work_counts_root_leaf():
    """The plain version's work counts (what chip_smoke.py's bound reads)
    on a one-leaf tree of 12 triangles and 2 spheres: per live ray one
    visit, one box test (the leaf's slot only) and one test per prim of
    its own type; pad slots and invalid lanes cost nothing."""
    ours, _ = flatten_scene(cornell_box_scene(with_spheres=True),
                            tree_width=4, max_leaf_size=32, device="cpu")
    assert ours.bvh.root_is_leaf
    o, d = random_rays(256, seed=4, origin_box=0.9)
    valid = np.arange(len(o)) % 4 != 0
    b = ours.bvh
    stats = {}
    pdfs.dfs_trace_plain(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(valid), None, b.dfs_node_rows,
                         b.dfs_prim_rows, b.node_meta, b.width, 1e-3,
                         stats=stats)
    live = int(valid.sum())
    assert stats == {"visits": live, "boxes": live, "tris": 12 * live,
                     "spheres": 2 * live}
