"""bf16 box tests in the port (config slab_bf16: the DFS's slab_bf16 and
the wavefront's box_bf16), plain versions on the CPU, against the JAX
package.

* The wavefront's box terms with ``bf16=True`` against the JAX
  package's ``_box_terms(..., bf16=True)`` (plain jnp, run op by op):
  slab_ok, tnear and inside equal to the bit, axis-parallel rays and
  origins inside boxes included.
* The bf16 traces equal the f32 traces to the bit (t and prim), closest
  hit and shadow decisions: the widening only adds visits and entries.
  The work counts show it (visits per ray, counted entries).
* The bf16 traces against the JAX package's bf16 Pallas traces in
  interpret mode (under jit: t within rtol 1e-5 + atol 1e-6, hit/miss
  exact, prim exact off ties at a bit-equal t).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops.pallas import wavefront2 as jax_wf2
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse

import torch

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs as pdfs
from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF

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


#: name -> (port scene, JAX scene, max_leaf, ray origin box)
SCENES = {
    "box": (lambda: cornell_box_scene(with_spheres=True),
            lambda: jax_cornell(with_spheres=True), 4, 0.9),
    "soup": (lambda: _soup(st, DiffuseBSDF), lambda: _soup(jst, JaxDiffuse),
             8, 3.0),
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


@pytest.mark.parametrize("bf16", [False, True])
def test_box_terms_match_jax(bf16):
    """[E, W] boxes against E rays, a sixth of them with an axis-parallel
    direction (1/d = inf) and some origins inside their boxes."""
    rng = np.random.default_rng(7)
    e, w = 4096, 4
    lo = rng.uniform(-2, 2, (e, w, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1.5, (e, w, 3)).astype(np.float32)
    o = rng.uniform(-2.5, 2.5, (e, 3)).astype(np.float32)
    o[::5] = lo[::5, 0] + 0.25 * (hi[::5, 0] - lo[::5, 0])  # inside box 0
    d = rng.standard_normal((e, 3)).astype(np.float32)
    d[::6, rng.integers(0, 3)] = 0.0
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    rows = np.zeros((e, 7 * w), np.float32)
    rows[:, :3 * w] = lo.reshape(e, -1)
    rows[:, 3 * w:6 * w] = hi.reshape(e, -1)
    slab, tn, ins, _ = wf._box_terms(_t(rows), w, _t(o), _t(inv), bf16)
    box = tuple(jnp.asarray(a[..., k]) for a in (lo, hi) for k in range(3))
    oj = [jnp.asarray(o[:, k:k + 1]) for k in range(3)]
    ij = [jnp.asarray(inv[:, k:k + 1]) for k in range(3)]
    slab_j, tn_j, ins_j = jax_wf2._box_terms(box, *oj, *ij, bf16=bf16)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(slab_j))
    np.testing.assert_array_equal(ins.numpy(), np.asarray(ins_j))
    np.testing.assert_array_equal(tn.numpy().view(np.int32),
                                  np.asarray(tn_j).view(np.int32))
    assert 0 < slab.numpy().mean() < 1 and ins.numpy().any()


def _shadow_limits(ref, o, d, valid):
    full = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(valid))
    t_hit = np.where(np.asarray(full.prim) >= 0, np.asarray(full.t), 2.0)
    scale = np.where(np.arange(len(o)) % 3 == 0, 0.5, 1.5)
    return (t_hit * scale).astype(np.float32), np.asarray(full.t)


def _dfs_plain(ours, o, d, valid, t_limit, bf16, stats):
    b = ours.bvh
    return pdfs.dfs_trace_plain(
        _t(o), _t(d), _t(valid), None if t_limit is None else _t(t_limit),
        b.dfs_node_rows, b.dfs_prim_rows, b.node_meta, b.width, 1e-3,
        pdfs.stack_entries(b), t_limit is not None, bf16=bf16, stats=stats)


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", ["soup", "terrain"])
def test_dfs_bf16_equals_f32(name, shadow):
    """The slab_bf16 DFS returns the f32 DFS's t and prim to the bit,
    with at least as many visits."""
    ours, ref, box = scenes(name)
    o, d = random_rays(1024, seed=13, origin_box=box)
    valid = np.arange(len(o)) % 9 != 0
    max_t = _shadow_limits(ref, o, d, valid)[0] if shadow else None
    sa, sb = {}, {}
    ta, pa, da = _dfs_plain(ours, o, d, valid, max_t, False, sa)
    tb, pb, db = _dfs_plain(ours, o, d, valid, max_t, True, sb)
    assert int(da) == int(db) == 0
    np.testing.assert_array_equal(pa.numpy(), pb.numpy())
    np.testing.assert_array_equal(ta.numpy().view(np.int32),
                                  tb.numpy().view(np.int32))
    print(f"visits per ray: f32 {sa['visits'] / len(o):.3f}, bf16 "
          f"{sb['visits'] / len(o):.3f}")
    assert sb["visits"] >= sa["visits"] > 0
    assert (pa >= 0).sum() > 50


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", ["soup", "terrain"])
def test_wavefront_bf16_equals_f32(name, shadow):
    ours, ref, box = scenes(name)
    o, d = random_rays(1024, seed=14, origin_box=box)
    valid = np.arange(len(o)) % 9 != 0
    max_t = _shadow_limits(ref, o, d, valid)[0] if shadow else None
    out = []
    for bf16 in (False, True):
        r = wf.trace_closest_wavefront(
            ours, _t(o), _t(d), _t(valid),
            None if max_t is None else _t(max_t), box_bf16=bf16,
            compact=True, want_prim=not shadow)
        assert int(r.dropped) == 0
        out.append((r.t.numpy(), r.prim.numpy()))
    (ta, pa), (tb, pb) = out
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ta.view(np.int32), tb.view(np.int32))
    assert (pa != -1).sum() > 50


def test_bf16_counts_cover_f32_counts():
    """On the soup's level-0 and level-1 queues the bf16 count is at
    least the f32 count in every (segment, child) slot, and larger in
    some: false positives only."""
    ours, _, box = scenes("soup")
    bvh = ours.bvh
    o, d = random_rays(2048, seed=15, origin_box=box)
    queue = wf.make_payload(_t(o), _t(d), torch.ones(len(o), dtype=bool))
    seg_base = torch.tensor([0, len(o)], dtype=torch.int32)
    cap = wf.queue_capacity(len(o), 2, bvh.wf_sched)
    grew = 0
    for lv in bvh.wf_levels[:2]:
        a = wf.count_plain(queue, seg_base, lv, bvh.wf_node_rows, 4)
        b = wf.count_plain(queue, seg_base, lv, bvh.wf_node_rows, 4,
                           bf16=True)
        assert bool((b >= a).all())
        grew += int((b > a).sum())
        seg_next, route, cursor, _ = wf.plan_regions(a, lv, cap)
        out = torch.zeros((cap, 8))
        wf.pack_plain(queue, seg_base, lv, route, cursor, bvh.wf_node_rows,
                      ours.wf_prim_rows, 4, False, 1e-3, out,
                      torch.full((len(o),), wf.KEY_MISS), torch.zeros(
                          (), dtype=torch.int64))
        queue, seg_base = out, seg_next
    assert grew > 0


def test_dfs_bf16_matches_pallas_kernel(monkeypatch):
    """The JAX package's slab_bf16 DFS kernel (interpret mode), terrain
    n=8, closest hit and shadow."""
    from cuda_raytracer_tpu.ops.pallas import packet_dfs as jax_pdfs

    monkeypatch.setattr(jax_pdfs, "_INTERPRET", True)
    ours, ref, box = scenes("terrain")
    o, d = random_rays(jax_pdfs.C, seed=16, origin_box=box)
    valid = np.arange(len(o)) % 7 != 0
    r = pdfs.trace_closest_packets(ours, _t(o), _t(d), _t(valid),
                                   slab_bf16=True)
    j = jax_pdfs.trace_closest_packets(ref, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(valid), slab_bf16=True)
    ta, pa = r.t.numpy(), r.prim.numpy()
    tb, pb = np.asarray(j.t), np.asarray(j.prim)
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert (hit & (pa != pb)).sum() <= 0.01 * hit.sum()
    max_t, full_t = _shadow_limits(ref, o, d, valid)
    s = pdfs.trace_closest_packets(ours, _t(o), _t(d), _t(valid),
                                   _t(max_t), slab_bf16=True)
    np.testing.assert_array_equal(s.t.numpy() > max_t - EPS,
                                  full_t > max_t - EPS)


def test_wavefront_bf16_matches_pallas_kernels(monkeypatch):
    """The JAX package's box_bf16 wavefront (interpret-mode Pallas) on
    the box scene, closest hit and shadow decisions."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref, box = scenes("box")
    o, d = random_rays(jax_wf2.CHUNK, seed=17, origin_box=box)
    valid = np.arange(len(o)) % 5 != 0
    r = wf.trace_closest_wavefront(ours, _t(o), _t(d), _t(valid),
                                   box_bf16=True)
    j = jax_wf2.trace_closest_wavefront(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        box_bf16=True)
    ta, pa = r.t.numpy(), r.prim.numpy()
    tb, pb = np.asarray(j.t), np.asarray(j.prim)
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert (hit & (pa != pb)).sum() <= 0.01 * hit.sum()
    assert hit.sum() > 500
