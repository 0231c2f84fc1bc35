"""The port's intersection tests against the JAX package's, on the same
numpy-seeded rays and the same flatten-table rows.

packed_prim_test is the leaf test the DFS kernel runs line for line.
Run op by op (as here) jnp and torch round every operation alike, so,
under the JAX package's parallel cut (``eps=1e-6``), ``ok`` is equal
and t is bit-equal; the test reports the ulp gap and holds it to 0.
Under the port's own cut (|g.d| <= prim_scale, relative to the
triangle) a verdict may change only where the cut decides; the test
counts those (ray, prim) pairs and holds each against a float64
Moller-Trumbore (the benchmark's plain reference).  The reference-style tests (bbox, triangle, sphere)
sum over vector axes, where the two libraries may add in a different
order (the sphere test shows up to 8 ulp): hit decisions equal (a flip
could only come within rounding of a boundary; none does on these
inputs), and t within rtol=1e-5, atol=1e-6.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops import intersect as JI
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten

import torch

from cuda_raytracer_tpu_torch.ops import intersect as PI
from cuda_raytracer_tpu_torch.render.flatscene import fill_prim_scale
from test_torch_parallel_cut import reference_t


#: torch's thread count in this process, before the module fixture
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here.  The rounding once blamed on
    threads was torch's vectorized CPU float32 ``sqrt``, which on some
    hosts is one ulp off the IEEE result (the scalar tail of an op is
    not; threads move where each chunk's tail begins, so one thread made
    it rarer without curing it).  The plain versions now take their
    roots from ``ops.intersect.sqrt_rn``; the tests marked
    ``default_threads`` hold it with torch's own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_threads():
    """torch's default thread count for one test."""
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(1)


def _rays(n, seed, box):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * box).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _ulp_gap(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _rows(fs):
    """The JAX package's prim rows (cols 0:23) with the port's scale slot
    (col 22) filled, as the port's flatten_scene has them."""
    packed = fill_prim_scale("prim_packed", np.array(fs.prim_packed))
    return packed[: fs.num_prims, :23]


def test_packed_prim_test_matches():
    """Every prim row of cornell-with-spheres and terrain n=20 against
    256 random rays each."""
    changed_total = 0
    for scene in (jax_cornell(with_spheres=True), jax_terrain(n=20)):
        fs, _ = jax_flatten(scene, tree_width=4, max_leaf_size=8)
        rows = _rows(fs)
        o, d = _rays(256, 3, 1.2)
        ob, db = o[:, None, :], d[:, None, :]
        cols = [rows[None, :, c] for c in range(10, 22)] + [rows[None, :, 9]]
        args = [ob[..., 0], ob[..., 1], ob[..., 2],
                db[..., 0], db[..., 1], db[..., 2]] + cols
        ok_j, t_j = JI.packed_prim_test(*[jnp.asarray(a) for a in args])
        targs = [torch.from_numpy(np.ascontiguousarray(a))
                 for a in args + [rows[None, :, 22]]]
        ok_a, t_a = PI.packed_prim_test(*targs, eps=1e-6)
        ok_j, t_j = np.asarray(ok_j), np.asarray(t_j)
        ok_a, t_a = ok_a.numpy(), t_a.numpy()
        assert np.array_equal(ok_a, ok_j)
        assert ok_a.sum() > 20
        gap = _ulp_gap(t_a[ok_a], t_j[ok_j])
        print(f"packed_prim_test: {ok_a.sum()} hits, max ulp gap {gap}")
        assert gap == 0

        # the port's cut: the same t wherever both cuts pass a prim; a
        # changed verdict is held against the float64 test
        ok_p, t_p = PI.packed_prim_test(*targs)
        ok_p, t_p = ok_p.numpy(), t_p.numpy()
        both = ok_p & ok_a
        assert np.array_equal(t_p[both].view(np.int32),
                              t_a[both].view(np.int32))
        changed = np.argwhere(ok_p != ok_a)
        changed_total += len(changed)
        print(f"verdicts the relative cut changes: {len(changed)} of "
              f"{ok_p.size} (ray, prim) pairs")
        for r, p in changed:
            v = rows[p, 0:9].reshape(3, 3)
            t64 = reference_t(o[r:r + 1], d[r:r + 1], v)[0]
            assert np.isfinite(t64) == ok_p[r, p], (r, p, t64)

        # intersect_rows is the same test over whole rows (col 22: the
        # scale), and over cols 0:22 alone the JAX package's
        tr_j = np.asarray(JI.intersect_rows(jnp.asarray(ob), jnp.asarray(db),
                                            jnp.asarray(rows[None, :, :22])))
        tr_p = PI.intersect_rows(torch.from_numpy(ob), torch.from_numpy(db),
                                 torch.from_numpy(rows[None])).numpy()
        same = np.ones_like(ok_p)
        same[tuple(changed.T)] = False
        assert np.array_equal(tr_p[same].view(np.int32),
                              tr_j[same].view(np.int32))
        assert np.array_equal(tr_p >= 0, ok_p)
    print(f"changed verdicts in all: {changed_total}")


def test_reference_tests_match():
    """intersect_bbox / intersect_triangle / intersect_sphere /
    intersect_prim on random boxes, triangles and spheres."""
    rng = np.random.default_rng(7)
    n = 4096
    o, d = _rays(n, 8, 1.0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    bmin = f32(rng.uniform(-1, 0.5, (n, 3)))
    bmax = f32(bmin + rng.uniform(0.05, 1.0, (n, 3)))
    v0, v1, v2 = (f32(rng.uniform(-1, 1, (n, 3))) for _ in range(3))
    rad = f32(rng.uniform(0.1, 0.6, n))
    ptype = (np.arange(n) % 2).astype(np.int32)
    cases = {
        "bbox": ((o, d, bmin, bmax), JI.intersect_bbox, PI.intersect_bbox),
        "triangle": ((o, d, v0, v1, v2), JI.intersect_triangle,
                     PI.intersect_triangle),
        "sphere": ((o, d, v0, rad), JI.intersect_sphere, PI.intersect_sphere),
        "prim": ((o, d, ptype, v0, np.stack([rad] * 3, 1), v2),
                 JI.intersect_prim, PI.intersect_prim),
    }
    for name, (args, fj, fp) in cases.items():
        tj = np.asarray(fj(*[jnp.asarray(a) for a in args]))
        tp = fp(*[torch.from_numpy(a) for a in args]).numpy()
        hit_j, hit_p = tj >= 0, tp >= 0
        differ = hit_j != hit_p
        # a hit decision may flip only on a boundary (t or a sidedness
        # product within rounding of 0): none on these random inputs
        assert differ.sum() == 0, name
        assert hit_p.sum() > 50, name
        np.testing.assert_allclose(tp[hit_p], tj[hit_j], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        print(f"{name}: {hit_p.sum()} hits, max ulp gap "
              f"{_ulp_gap(tp[hit_p], tj[hit_j])}")


def _sqrt_inputs():
    """1,310,720 float32 inputs: uniforms as the sphere test's
    discriminants come, subnormals, values near FLT_MAX, random bit
    patterns of every finite positive float, and 0, -0, 1, 2, 4, the
    smallest subnormal, FLT_MAX and inf."""
    rng = np.random.default_rng(11)
    fmax = np.finfo(np.float32).max
    return np.concatenate([
        rng.uniform(0.0, 100.0, 1 << 19).astype(np.float32),
        rng.uniform(0.0, 1e-3, 1 << 18).astype(np.float32),
        rng.integers(1, 1 << 23, 1 << 17, dtype=np.uint32).view(np.float32),
        (fmax * rng.uniform(0.5, 1.0, 1 << 17)).astype(np.float32),
        rng.integers(0, 0x7F800000, 1 << 18, dtype=np.uint32).view(
            np.float32),
        np.array([0.0, -0.0, 1.0, 2.0, 4.0, 1e-45, fmax, np.inf],
                 dtype=np.float32),
    ])


def test_sqrt_rn_matches_numpy(default_threads):
    """sqrt_rn is bit-equal to numpy's (IEEE) float32 sqrt on every
    input, with torch's default thread count; negatives and NaN give
    NaN as numpy does."""
    x = _sqrt_inputs()
    assert x.size >= 1 << 20
    want = np.sqrt(x).view(np.uint32)
    got = PI.sqrt_rn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    off = int((torch.sqrt(torch.from_numpy(x)).numpy().view(np.uint32)
               != want).sum())
    print(f"sqrt_rn on {x.size} inputs; torch.sqrt differs from numpy on "
          f"{off} of them here")
    assert np.array_equal(got.view(np.uint32), want)
    bad = PI.sqrt_rn(torch.tensor([-1.0, -1e-45, float("nan")])).numpy()
    assert np.isnan(bad).all()


def test_packed_prim_sphere_rows_default_threads(default_threads):
    """packed_prim_test on the sphere rows of cornell-with-spheres,
    against 65,536 rays (long enough for torch's vectorized and threaded
    paths), bit-equal to the JAX package's with torch's default thread
    count."""
    fs, _ = jax_flatten(jax_cornell(with_spheres=True), tree_width=4,
                        max_leaf_size=8)
    rows = _rows(fs)
    rows = rows[rows[:, 9] > 0.5]
    assert len(rows) == 2
    o, d = _rays(1 << 16, 5, 1.0)
    ob, db = o[:, None, :], d[:, None, :]
    cols = [rows[None, :, c] for c in range(10, 22)] + [rows[None, :, 9]]
    args = [ob[..., 0], ob[..., 1], ob[..., 2],
            db[..., 0], db[..., 1], db[..., 2]] + cols
    ok_j, t_j = JI.packed_prim_test(*[jnp.asarray(a) for a in args])
    ok_p, t_p = PI.packed_prim_test(*[torch.from_numpy(
        np.ascontiguousarray(a)) for a in args + [rows[None, :, 22]]])
    ok_j, t_j = np.asarray(ok_j), np.asarray(t_j)
    ok_p, t_p = ok_p.numpy(), t_p.numpy()
    assert np.array_equal(ok_p, ok_j)
    assert ok_p.sum() > 1000
    gap = _ulp_gap(t_p[ok_p], t_j[ok_j])
    print(f"sphere rows: {ok_p.sum()} hits, max ulp gap {gap}")
    assert gap == 0
