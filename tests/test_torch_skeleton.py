"""The port's skeleton (FK, IK, skinning) and transform widget against the
JAX package's, on the cases of tests/test_skeleton.py.

Each case runs once on each package's modules, checks the JAX test's
own assertions on both, and returns the arrays it computed (joint
positions, IK distances, skinned vertices, widget-edited fields).
Held: the two packages' arrays equal, exactly (the port's modules are
copies, with their float64 arithmetic untouched).
"""

import types

import numpy as np
import pytest

from cuda_raytracer_tpu.scene import bsdf as jax_bsdf
from cuda_raytracer_tpu.scene import collada_info as jax_ci
from cuda_raytracer_tpu.scene import dynamic_scene as jax_dyn
from cuda_raytracer_tpu.scene import skeleton as jax_skeleton
from cuda_raytracer_tpu.scene import widgets as jax_widgets

from cuda_raytracer_tpu_torch.scene import bsdf, collada_info, dynamic_scene
from cuda_raytracer_tpu_torch.scene import skeleton, widgets
from torch_threads import _one_torch_thread  # noqa: F401

PACKAGES = {
    "port": types.SimpleNamespace(sk=skeleton, w=widgets, dyn=dynamic_scene,
                                  ci=collada_info, bsdf=bsdf),
    "jax": types.SimpleNamespace(sk=jax_skeleton, w=jax_widgets, dyn=jax_dyn,
                                 ci=jax_ci, bsdf=jax_bsdf),
}


def two_bone_arm(m):
    """Root at origin, two unit bones along +x."""
    sk = m.sk.Skeleton()
    j1 = sk.create_joint([1.0, 0.0, 0.0])
    j2 = sk.create_joint([1.0, 0.0, 0.0], parent=j1)
    return sk, j1, j2


def fk_rest_pose(m):
    sk, j1, j2 = two_bone_arm(m)
    out = [j1.get_base_pos_in_world(), j1.get_end_pos_in_world(),
           j2.get_base_pos_in_world(), j2.get_end_pos_in_world()]
    np.testing.assert_allclose(out, [[0, 0, 0], [1, 0, 0], [1, 0, 0],
                                     [2, 0, 0]])
    return out


def fk_rotation_chains(m):
    sk, j1, j2 = two_bone_arm(m)
    j1.angle = np.array([0.0, 0.0, 90.0])
    out = [j1.get_end_pos_in_world(), j2.get_base_pos_in_world(),
           j2.get_end_pos_in_world()]
    np.testing.assert_allclose(out, [[0, 1, 0], [0, 1, 0], [0, 2, 0]],
                               atol=1e-12)
    j2.angle = np.array([0.0, 0.0, -90.0])
    out.append(j2.get_end_pos_in_world())
    np.testing.assert_allclose(out[-1], [1, 1, 0], atol=1e-12)
    return out


def fk_offset_skeleton(m):
    sk = m.sk.Skeleton(offset=[5.0, 0.0, 0.0])
    j = sk.create_joint([0.0, 1.0, 0.0])
    out = [j.get_base_pos_in_world(), j.get_end_pos_in_world()]
    np.testing.assert_allclose(out, [[5, 0, 0], [5, 1, 0]])
    return out


def angle_keyframing(m):
    sk, j1, j2 = two_bone_arm(m)
    j1.angle = np.zeros(3)
    j1.keyframe(0.0)
    j1.angle = np.array([0.0, 0.0, 90.0])
    j1.keyframe(10.0)
    out = [j1.get_angle(t) for t in (0.0, 2.5, 5.0, 10.0)]
    out.append(j1.get_end_pos_in_world(time=10.0))
    np.testing.assert_allclose(out[0], [0, 0, 0], atol=1e-9)
    np.testing.assert_allclose(out[3], [0, 0, 90], atol=1e-9)
    assert 30.0 < out[2][2] < 60.0
    np.testing.assert_allclose(out[4], [0, 1, 0], atol=1e-9)
    return out


def ik_reaches_target(m):
    sk, j1, j2 = two_bone_arm(m)
    dist = sk.reach_for_target(j2, np.array([1.2, 1.2, 0.0]))
    assert dist < 0.05, f"IK did not converge: dist={dist}"
    return [np.array([dist]), j1.angle, j2.angle, j2.get_end_pos_in_world()]


def ik_unreachable(m):
    sk, j1, j2 = two_bone_arm(m)
    sk.reach_for_target(j2, np.array([0.0, 5.0, 0.0]), steps=400)
    end = j2.get_end_pos_in_world()
    np.testing.assert_allclose(end, [0, 2, 0], atol=0.1)
    return [j1.angle, j2.angle, end]


def skinning_rigid_follow(m):
    sk, j1, j2 = two_bone_arm(m)
    rest = np.array([[0.5, 0.01, 0.0], [1.5, 0.01, 0.0]])
    j1.angle = np.array([0.0, 0.0, 90.0])
    skinned = sk.skin_vertices(rest)
    np.testing.assert_allclose(skinned[0], [-0.01, 0.5, 0.0], atol=0.05)
    np.testing.assert_allclose(skinned[1], [-0.01, 1.5, 0.0], atol=0.05)
    return [skinned]


def _mesh(m, vertices, polygon):
    info = m.ci.PolymeshInfo(
        vertices=np.array(vertices, dtype=np.float64),
        polygons=[m.ci.Polygon(vertex_indices=polygon)],
        material=m.ci.MaterialInfo(
            bsdf=m.bsdf.DiffuseBSDF(np.array([0.6, 0.6, 0.6]))),
    )
    return info, m.dyn.Mesh(info, np.eye(4))


def skinned_mesh_render_conversion(m):
    info, mesh = _mesh(m, [[0, 0, 0], [1, 0, 0], [1, 0.2, 0], [0, 0.2, 0]],
                       [0, 1, 2, 3])
    sk = m.sk.Skeleton()
    j = sk.create_joint([1.0, 0.0, 0.0])
    mesh.skeleton = sk
    j.angle = np.zeros(3)
    mesh.keyframe(0.0)
    j.angle = np.array([0.0, 0.0, 90.0])
    mesh.keyframe(4.0)
    rest = mesh.get_transformed_static_object(0.0).positions
    bent = mesh.get_transformed_static_object(4.0).positions
    mid = mesh.get_transformed_static_object(1.5).positions
    np.testing.assert_allclose(rest, info.vertices, atol=1e-6)
    assert not np.allclose(bent, rest)
    assert bent[1][1] > 0.8
    return [rest, bent, mid]


def xform_widget(m):
    _, mesh = _mesh(m, [[0, 0, 0], [1, 0, 0], [0, 1, 0]], [0, 1, 2])
    w = m.w.XFormWidget()
    assert not w.drag(1.0, 0.0)
    w.set_target(mesh)
    w.set_translate()
    w.set_axis(0)
    assert w.drag(2.5, 0.0)
    out = [mesh.position.copy()]
    w.cycle_mode()
    assert w.mode is m.w.Mode.ROTATE
    w.set_axis(2)
    w.drag(45.0, 0.0)
    out.append(mesh.rotation.copy())
    w.cycle_mode()
    assert w.mode is m.w.Mode.SCALE
    w.set_axis(None)
    w.drag(0.5, 0.0)
    out.append(mesh.scale.copy())
    np.testing.assert_allclose(out, [[2.5, 0, 0], [0, 0, 45], [1.5] * 3])
    w.restore_last_mode()
    assert w.mode is m.w.Mode.ROTATE
    hm = mesh.halfedge_mesh()
    w.set_target(mesh, element=hm.vertices[1])
    w.set_translate()
    w.set_axis(1)
    w.drag(0.25, 0.0)
    assert mesh.mesh.vertices[1][1] == 0.25
    out.append(np.asarray(mesh.mesh.vertices, np.float64))
    out.append(mesh.get_transformed_static_object(0.0).positions)
    return out


CASES = [fk_rest_pose, fk_rotation_chains, fk_offset_skeleton,
         angle_keyframing, ik_reaches_target, ik_unreachable,
         skinning_rigid_follow, skinned_mesh_render_conversion,
         xform_widget]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_matches_jax(case):
    got = case(PACKAGES["port"])
    want = case(PACKAGES["jax"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rig_round_trip():
    """A skeleton saved to arrays (the session's sidecar format) loads the
    same in both packages, and skins alike."""
    sk, j1, j2 = two_bone_arm(PACKAGES["port"])
    j1.angle = np.array([10.0, 20.0, 30.0])
    sk.keyframe(0.0)
    j2.angle = np.array([0.0, 0.0, 45.0])
    sk.keyframe(3.0)
    arrays = sk.to_arrays()
    rest = np.random.default_rng(0).random((50, 3)) * [2, 0.2, 0.2]
    got = skeleton.Skeleton.from_arrays(arrays).skin_vertices(rest, 1.5)
    want = jax_skeleton.Skeleton.from_arrays(arrays).skin_vertices(rest, 1.5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sk.skin_vertices(rest, 1.5))
