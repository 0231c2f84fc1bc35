"""The port's intersection tests against the JAX package's, on the same
numpy-seeded rays and the same flatten-table rows.

packed_prim_test is the leaf test the DFS kernel runs line for line.
Run op by op (as here) jnp and torch round every operation alike, so
``ok`` is equal and t is bit-equal; the test reports the ulp gap and
holds it to 0.  The reference-style tests (bbox, triangle, sphere)
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


def _rays(n, seed, box):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * box).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _ulp_gap(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def test_packed_prim_test_matches():
    """Every prim row of cornell-with-spheres and terrain n=20 against
    256 random rays each."""
    for scene in (jax_cornell(with_spheres=True), jax_terrain(n=20)):
        fs, _ = jax_flatten(scene, tree_width=4, max_leaf_size=8)
        rows = np.array(fs.prim_packed)[: fs.num_prims, :22]
        o, d = _rays(256, 3, 1.2)
        ob, db = o[:, None, :], d[:, None, :]
        cols = [rows[None, :, c] for c in range(10, 22)] + [rows[None, :, 9]]
        args = [ob[..., 0], ob[..., 1], ob[..., 2],
                db[..., 0], db[..., 1], db[..., 2]] + cols
        ok_j, t_j = JI.packed_prim_test(*[jnp.asarray(a) for a in args])
        ok_p, t_p = PI.packed_prim_test(*[torch.from_numpy(
            np.ascontiguousarray(a)) for a in args])
        ok_j, t_j = np.asarray(ok_j), np.asarray(t_j)
        ok_p, t_p = ok_p.numpy(), t_p.numpy()
        assert np.array_equal(ok_p, ok_j)
        assert ok_p.sum() > 20
        gap = _ulp_gap(t_p[ok_p], t_j[ok_j])
        print(f"packed_prim_test: {ok_p.sum()} hits, max ulp gap {gap}")
        assert gap == 0

        # intersect_rows is the same test over whole rows
        tr_j = np.asarray(JI.intersect_rows(jnp.asarray(ob), jnp.asarray(db),
                                            jnp.asarray(rows[None])))
        tr_p = PI.intersect_rows(torch.from_numpy(ob), torch.from_numpy(db),
                                 torch.from_numpy(rows[None])).numpy()
        assert np.array_equal(tr_p.view(np.int32), tr_j.view(np.int32))


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
