"""The port's flatten_scene against the JAX package's, table for table.

Both build the same numpy tables from the same scene, so every array
field must be equal exactly, and so must the static metadata.
"""

import dataclasses

import numpy as np
import pytest

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.render.flatscene import (
    flatten_scene,
    from_jax_arrays,
)
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF
from torch_threads import _one_torch_thread  # noqa: F401


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


#: (port scene, JAX scene, tree_width, max_leaf)
CASES = {
    "cornell": (lambda: cornell_box_scene(with_spheres=True),
                lambda: jax_cornell(with_spheres=True), 4, 4),
    "cornell_rootleaf": (lambda: cornell_box_scene(with_spheres=True),
                         lambda: jax_cornell(with_spheres=True), 4, 32),
    "terrain20": (lambda: terrain_scene(n=20), lambda: jax_terrain(n=20),
                  4, 32),
    "soup_w8": (lambda: _soup(st, DiffuseBSDF),
                lambda: _soup(jst, JaxDiffuse), 8, 8),
}


def jax_fields(scene):
    """np.asarray of every FlatScene/FlatBVH leaf + the static fields,
    in from_jax_arrays' naming."""
    fields, static = {}, {}
    for prefix, obj in (("", scene), ("bvh.", scene.bvh)):
        for f in dataclasses.fields(obj):
            if f.name == "bvh":
                continue
            val = getattr(obj, f.name)
            if f.metadata.get("pytree_node", True):
                fields[prefix + f.name] = np.asarray(val)
            else:
                static[prefix + f.name] = val
    return fields, static


@pytest.mark.parametrize("case", sorted(CASES))
def test_flatten_tables_equal(case):
    mk_port, mk_jax, w, ml = CASES[case]
    ours, _ = flatten_scene(mk_port(), tree_width=w, max_leaf_size=ml,
                            device="cpu")
    ref, _ = jax_flatten(mk_jax(), tree_width=w, max_leaf_size=ml)
    fields, static = jax_fields(ref)
    for name, want in fields.items():
        obj = ours.bvh if name.startswith("bvh.") else ours
        got = getattr(obj, name.split(".")[-1]).numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    for name, want in static.items():
        obj = ours.bvh if name.startswith("bvh.") else ours
        assert getattr(obj, name.split(".")[-1]) == want, name

    # a JAX checkpoint of the tables loads into the port unchanged
    loaded = from_jax_arrays(fields, static, device="cpu")
    assert loaded.bvh.wf_sched == ours.bvh.wf_sched
    for f in dataclasses.fields(loaded.bvh):
        a = getattr(loaded.bvh, f.name)
        if hasattr(a, "numpy"):
            assert np.array_equal(a.numpy(), getattr(ours.bvh, f.name).numpy())
    assert np.array_equal(loaded.prim_packed.numpy(),
                          ours.prim_packed.numpy())


def test_dfs_compact_views():
    """The kernel's compact tables are views of the flatten tables."""
    ours, _ = flatten_scene(terrain_scene(n=20), device="cpu")
    rows = ours.bvh.dfs_node_rows
    assert rows.shape == (ours.bvh.node_dfs.shape[0], 8)
    assert np.array_equal(rows.numpy(), ours.bvh.node_dfs[:, :8].numpy())
    prims = ours.bvh.dfs_prim_rows
    assert prims.shape == (ours.bvh.prim_groups.shape[0] * 8, 16)
    assert prims.data_ptr() == ours.bvh.prim_groups.data_ptr()
