"""The port's native BVH builder (native/bvh_builder.cpp, built with g++
at first use) against its numpy builder and the JAX package's native
builder.

Cases: tests/test_bvh.py's (3,000 random boxes under max_leaf_size=4,
an empty and a one-prim scene) and terrain n=20 (722 triangles) under
leaf sizes 4 and 32.  Held: sorted_order and every node (bounds,
start, range, leaf or not), preorder, equal bit for bit.
"""

import numpy as np
import pytest

from cuda_raytracer_tpu.accel.bvh import BVHAccel as JaxBVH
from cuda_raytracer_tpu.native import load_library as jax_load_library

from cuda_raytracer_tpu_torch import native
from cuda_raytracer_tpu_torch.accel.bvh import BVHAccel
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from torch_threads import _one_torch_thread  # noqa: F401


def nodes(bvh):
    """Every node in preorder: (bounds, start, range, is_leaf)."""
    out, stack = [], [bvh.root]
    while stack:
        n = stack.pop()
        out.append((np.concatenate([n.bb_min, n.bb_max]), n.start, n.range,
                    n.is_leaf))
        if not n.is_leaf:
            stack += [n.r, n.l]
    return out


def assert_same_tree(a, b):
    np.testing.assert_array_equal(a.sorted_order, b.sorted_order)
    na, nb = nodes(a), nodes(b)
    assert len(na) == len(nb)
    for (ba, *ra), (bb, *rb) in zip(na, nb):
        np.testing.assert_array_equal(ba.view(np.int64), bb.view(np.int64))
        assert ra == rb


def random_boxes():
    rng = np.random.default_rng(7)
    c = rng.random((3000, 3)) * 10
    h = rng.random((3000, 3)) * 0.3
    return c - h, c + h, 4


def terrain_boxes(leaf):
    _, bvh = flatten_scene(terrain_scene(n=20), max_leaf_size=leaf,
                           device="cpu")
    return bvh.prim_min, bvh.prim_max, leaf


CASES = {
    "random3000_leaf4": random_boxes,
    "terrain20_leaf4": lambda: terrain_boxes(4),
    "terrain20_leaf32": lambda: terrain_boxes(32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_numpy_and_jax(case):
    pmin, pmax, leaf = CASES[case]()
    a = BVHAccel(pmin, pmax, max_leaf_size=leaf, backend="native")
    b = BVHAccel(pmin, pmax, max_leaf_size=leaf, backend="numpy")
    assert (a.backend_used, b.backend_used) == ("native", "numpy")
    assert a.build_s > 0 and b.build_s > 0
    assert_same_tree(a, b)
    assert jax_load_library() is not None
    c = JaxBVH(pmin, pmax, max_leaf_size=leaf, backend="native")
    assert c.backend_used == "native"
    assert_same_tree(a, c)
    auto = BVHAccel(pmin, pmax, max_leaf_size=leaf)
    assert auto.backend_used == "native"
    assert_same_tree(auto, a)


def test_native_empty_and_single():
    one = np.array([[0.0, 0.0, 0.0]])
    t = BVHAccel(one, one + 1, backend="native")
    assert t.backend_used == "native"
    assert t.root.is_leaf and t.root.range == 1
    assert_same_tree(t, BVHAccel(one, one + 1, backend="numpy"))
    empty = np.zeros((0, 3))
    e = BVHAccel(empty, empty, backend="native")
    assert e.root.range == 0 and e.sorted_order.size == 0


def test_flatten_uses_native_and_times_steps():
    times = {}
    scene, bvh = flatten_scene(terrain_scene(n=8), device="cpu", times=times)
    assert bvh.backend_used == "native"
    assert sorted(times) == ["bvh_build", "flatten", "upload"]
    assert all(v >= 0 for v in times.values())
    assert times["bvh_build"] == bvh.build_s


def test_missing_compiler(monkeypatch):
    """"native" raises with the compiler's failure; "auto" builds with
    numpy instead, the same tree."""
    monkeypatch.setattr(native.build, "COMPILER", "/nonexistent/g++")
    pmin, pmax, leaf = terrain_boxes(4)
    with pytest.raises(native.NativeBuildError, match="/nonexistent/g"):
        BVHAccel(pmin, pmax, max_leaf_size=leaf, backend="native")
    auto = BVHAccel(pmin, pmax, max_leaf_size=leaf)
    assert auto.backend_used == "numpy"
    monkeypatch.undo()
    assert_same_tree(auto, BVHAccel(pmin, pmax, max_leaf_size=leaf))
