"""The port's session slots (scene/session.py) against the JAX package's,
on a document this test writes (test_torch_collada.py's ``document()``):
a save -> load round trip with a two-joint skeleton keyed on a mesh,
every mesh opened for editing first (the JAX session syncs each mesh
from its halfedge view, and raises without one).

Held, exactly: the saved COLLADA bytes; the loaded camera, static scene
and skeleton arrays; the loaded scene skinned at a keyed time and
between keys.  The empty and out-of-range slots raise in both.
"""

import types

import numpy as np
import pytest

from cuda_raytracer_tpu.scene import collada as jax_collada
from cuda_raytracer_tpu.scene import dynamic_scene as jax_dyn
from cuda_raytracer_tpu.scene import session as jax_session
from cuda_raytracer_tpu.scene import skeleton as jax_skeleton

from cuda_raytracer_tpu_torch import scene as port_scene
from cuda_raytracer_tpu_torch.scene import collada, dynamic_scene, skeleton

from test_torch_collada import assert_same, document
from torch_threads import _one_torch_thread  # noqa: F401

PACKAGES = {
    "port": types.SimpleNamespace(collada=collada, dyn=dynamic_scene,
                                  session=port_scene, sk=skeleton),
    "jax": types.SimpleNamespace(collada=jax_collada, dyn=jax_dyn,
                                 session=jax_session, sk=jax_skeleton),
}


def load(m, path, edit_view=True):
    """The document's dynamic scene; with ``edit_view``, every mesh opened
    for editing (its halfedge view built), as the JAX session needs."""
    scene = m.dyn.load_from_scene_info(m.collada.load_scene_info(path))[0]
    if edit_view:
        for o in scene.objects:
            if isinstance(o, m.dyn.Mesh):
                o.halfedge_mesh()
    return scene


def round_trip(m, path, directory):
    """Load the document, rig its first mesh, save it to slot 7, load it
    back.  Returns (the scene saved, load()'s tuple)."""
    scene = load(m, path)
    mesh = next(o for o in scene.objects if isinstance(o, m.dyn.Mesh))
    sk = m.sk.Skeleton(offset=(0, 0.2, 0))
    root = sk.create_joint([0, 0.5, 0])
    j = sk.create_joint([0.5, 0, 0], root)
    j.angle = np.array([10.0, 20.0, 30.0])
    mesh.skeleton = sk
    mesh.keyframe(0.0)
    j.angle = np.array([0.0, 0.0, -40.0])
    mesh.keyframe(2.0)

    mgr = m.session.SessionManager(directory)
    assert mgr.occupied() == []
    with pytest.raises(FileNotFoundError):
        mgr.load(3)  # the empty slot
    with pytest.raises(ValueError):
        mgr.save(10, scene)
    mgr.save(7, scene)
    assert mgr.occupied() == [7]
    return scene, mgr.load(7)


def test_round_trip_matches_jax(tmp_path):
    path = tmp_path / "scene.dae"
    path.write_text(document())
    got = round_trip(PACKAGES["port"], str(path), str(tmp_path / "port"))
    want = round_trip(PACKAGES["jax"], str(path), str(tmp_path / "jax"))
    assert (tmp_path / "port" / "Scene_7.dae").read_bytes() == \
        (tmp_path / "jax" / "Scene_7.dae").read_bytes()

    (saved, (scene, *camera)), (_, (jscene, *jcamera)) = got, want
    assert_same(camera, jcamera, "camera")
    assert len(scene.objects) == len(saved.objects)
    assert_same(scene.get_static_scene(), jscene.get_static_scene())
    rigged = [i for i, o in enumerate(scene.objects)
              if getattr(o, "skeleton", None) is not None]
    assert rigged == [0]
    arrays = scene.objects[0].skeleton.to_arrays()
    want_arrays = jscene.objects[0].skeleton.to_arrays()
    assert sorted(arrays) == sorted(want_arrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], want_arrays[k])
    np.testing.assert_array_equal(arrays["angles"][1], [0.0, 0.0, -40.0])
    for t in (0.0, 0.7, 2.0):
        assert_same(scene.get_transformed_static_scene(t),
                    jscene.get_transformed_static_scene(t), f"t={t}")
    # the round trip keeps the scene: same bounds as the scene saved
    for a, b in zip(scene.get_static_scene().bbox(),
                    saved.get_static_scene().bbox()):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_save_unedited_meshes(tmp_path):
    """A scene whose meshes were never opened for editing (a viewer's
    freshly loaded file) saves in the port, where the JAX package raises
    AttributeError; it loads back to the same static scene."""
    path = tmp_path / "scene.dae"
    path.write_text(document())
    jscene = load(PACKAGES["jax"], str(path), edit_view=False)
    with pytest.raises(AttributeError, match="_hm"):
        jax_session.SessionManager(str(tmp_path / "jax")).save(0, jscene)
    scene = load(PACKAGES["port"], str(path), edit_view=False)
    mgr = port_scene.SessionManager(str(tmp_path / "port"))
    mgr.save(0, scene)
    loaded = mgr.load(0)[0]
    a, b = loaded.get_static_scene(), scene.get_static_scene()
    assert [type(o).__name__ for o in a.objects] == \
        [type(o).__name__ for o in b.objects]
    for x, y in zip(a.objects, b.objects):
        if hasattr(x, "positions"):
            np.testing.assert_array_equal(x.positions, y.positions)
