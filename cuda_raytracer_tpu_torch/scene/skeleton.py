"""Skeleton / Joint animation rig.

The reference's skeletal-animation layer (src/dynamic_scene/
skeleton.{h,cpp}, joint.{h,cpp}): a tree of joints, each owning a rest
``axis`` vector from its base to its end, an Euler-angle rotation
spline, and a capsule radius.  World transforms chain as

    world(joint) = world(parent) @ R(parent.angle) @ T(parent.axis)

so ``getTransformation`` excludes the joint's own rotation
(joint.h:56-58) and the end position applies it.

Where the reference stops at stubs, this implements the real thing:
- ``reach_for_target`` — IK by Jacobian-transpose gradient descent
  (``reachForTarget`` TODO, src/dynamic_scene/skeleton.cpp:341-342)
- ``calculateAngleGradient`` (joint.h:93-95)
- linear-blend skinning (``Mesh::linearBlendSkinning`` stub,
  src/dynamic_scene/mesh.cpp:48-50)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .spline import Spline


def _rot_euler(angles: np.ndarray) -> np.ndarray:
    """Rotation matrix from XYZ Euler angles in degrees (the joint
    rotation convention, applied X then Y then Z)."""
    rx, ry, rz = np.radians(np.asarray(angles, dtype=np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _h(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = t
    return m


class Joint:
    """One joint: rest axis from base to end + Euler-angle spline."""

    def __init__(self, skeleton: "Skeleton", axis,
                 parent: Optional["Joint"] = None):
        self.skeleton = skeleton
        self.axis = np.asarray(axis, dtype=np.float64)
        self.parent = parent
        self.kids: List["Joint"] = []
        self.angle = np.zeros(3)  # current Euler XYZ, degrees
        self.rotations = Spline()
        self.capsule_radius = 0.05
        self.ik_angle_gradient = np.zeros(3)
        if parent is not None:
            parent.kids.append(self)
        skeleton.joints.append(self)

    # -- angles (joint.h:75-91) --------------------------------------------
    def get_angle(self, time: float) -> np.ndarray:
        if self.rotations.knots:
            return np.asarray(
                self.rotations.evaluate(time, default=self.angle),
                dtype=np.float64,
            )
        return self.angle

    def set_angle(self, time: float, value) -> None:
        value = np.asarray(value, dtype=np.float64)
        self.angle = value
        if self.rotations.knots:
            self.rotations.set_value(time, value)

    def remove_angle(self, time: float) -> bool:
        return self.rotations.remove_knot(time)

    def keyframe(self, t: float) -> None:
        self.rotations.set_value(t, np.array(self.angle))

    def unkeyframe(self, t: float) -> None:
        self.rotations.remove_knot(t, 0.1)

    # -- transforms (joint.h:56-61, joint.cpp) ----------------------------
    def get_transformation(self, time: Optional[float] = None) -> np.ndarray:
        """World transform up to this joint's BASE: ancestors' rotations
        and offsets applied, own rotation excluded."""
        if self.parent is None:
            return _h(np.eye(3), self.skeleton.offset)
        p = self.parent
        ang = p.get_angle(time) if time is not None else p.angle
        return p.get_transformation(time) @ _h(_rot_euler(ang), np.zeros(3)) \
            @ _h(np.eye(3), p.axis)

    def get_bind_transformation(self) -> np.ndarray:
        """World transform to the base with NO rotations (rest pose)."""
        if self.parent is None:
            return _h(np.eye(3), self.skeleton.offset)
        return self.parent.get_bind_transformation() @ _h(
            np.eye(3), self.parent.axis
        )

    def get_base_pos_in_world(self, time: Optional[float] = None) -> np.ndarray:
        return self.get_transformation(time)[:3, 3]

    def get_end_pos_in_world(self, time: Optional[float] = None) -> np.ndarray:
        ang = self.get_angle(time) if time is not None else self.angle
        m = self.get_transformation(time) @ _h(_rot_euler(ang), np.zeros(3))
        return (m @ np.append(self.axis, 1.0))[:3]

    # -- IK (calculateAngleGradient, joint.h:93-95) ------------------------
    def calculate_angle_gradient(self, goal: "Joint",
                                 ptilde: np.ndarray) -> None:
        """Gradient of 1/2 |p - ptilde|^2 w.r.t. this joint's angles,
        where p is ``goal``'s end position (Jacobian transpose)."""
        p = goal.get_end_pos_in_world()
        diff = p - ptilde
        base = self.get_base_pos_in_world()
        # rotation axes of this joint in world space: columns of the
        # accumulated frame (X applied first, then Y, then Z)
        frame = self.get_transformation()[:3, :3]
        grad = np.zeros(3)
        for k in range(3):
            axis_w = frame[:, k]
            jcol = np.cross(axis_w, p - base)  # dp/dtheta_k (radians)
            grad[k] = np.dot(jcol, diff)
        self.ik_angle_gradient = grad
        for kid in self.kids:
            kid.calculate_angle_gradient(goal, ptilde)


class Skeleton:
    """Joint tree + IK driver + linear-blend skinning
    (src/dynamic_scene/skeleton.h:26-110)."""

    def __init__(self, offset=(0.0, 0.0, 0.0)):
        self.offset = np.asarray(offset, dtype=np.float64)
        self.joints: List[Joint] = []
        self.root: Optional[Joint] = None

    def create_joint(self, axis, parent: Optional[Joint] = None) -> Joint:
        """createNewJoint (skeleton.h:66-69)."""
        j = Joint(self, axis, parent)
        if parent is None:
            self.root = j
        return j

    # -- serialization (the reference writes skeletons to side files
    # next to the scene save buffers, application.h:281-296) ----------
    def to_arrays(self) -> dict:
        """Flat numpy arrays capturing the rig: rest axes, current
        angles, parent links, capsule radii, and per-joint keyframes."""
        J = len(self.joints)
        idx = {j: i for i, j in enumerate(self.joints)}
        out = {
            "offset": self.offset,
            "axes": np.stack([j.axis for j in self.joints])
            if J else np.zeros((0, 3)),
            "angles": np.stack([j.angle for j in self.joints])
            if J else np.zeros((0, 3)),
            "parents": np.asarray(
                [idx.get(j.parent, -1) if j.parent else -1
                 for j in self.joints], np.int64
            ),
            "radii": np.asarray(
                [j.capsule_radius for j in self.joints], np.float64
            ),
        }
        for i, j in enumerate(self.joints):
            if j.rotations.knots:
                ts = sorted(j.rotations.knots)
                out[f"kt{i}"] = np.asarray(ts)
                out[f"kv{i}"] = np.stack(
                    [np.asarray(j.rotations.knots[t]) for t in ts]
                )
        return out

    @classmethod
    def from_arrays(cls, arrays: dict) -> "Skeleton":
        sk = cls(offset=np.asarray(arrays["offset"]))
        joints = []
        parents = np.asarray(arrays["parents"])
        for i in range(len(parents)):
            parent = joints[parents[i]] if parents[i] >= 0 else None
            j = sk.create_joint(arrays["axes"][i], parent)
            j.angle = np.asarray(arrays["angles"][i])
            j.capsule_radius = float(arrays["radii"][i])
            joints.append(j)
        for i, j in enumerate(joints):
            kt, kv = arrays.get(f"kt{i}"), arrays.get(f"kv{i}")
            if kt is not None:
                for t, v in zip(np.asarray(kt), np.asarray(kv)):
                    j.rotations.set_value(float(t), np.asarray(v))
        return sk

    def keyframe(self, t: float) -> None:
        for j in self.joints:
            j.keyframe(t)

    def unkeyframe(self, t: float) -> None:
        for j in self.joints:
            j.unkeyframe(t)

    # -- IK (reachForTarget stub, skeleton.cpp:341-342) --------------------
    def reach_for_target(self, goal: Joint, target,
                         steps: int = 500, tau: float = 0.2) -> float:
        """Move ``goal``'s end position toward ``target`` by gradient
        descent on the IK energy over ALL ancestor joint angles.
        Returns the final distance to the target."""
        target = np.asarray(target, dtype=np.float64)
        chain: List[Joint] = []
        j: Optional[Joint] = goal
        while j is not None:
            chain.append(j)
            j = j.parent
        for _ in range(steps):
            if self.root is not None:
                self.root.calculate_angle_gradient(goal, target)
            # normalize by the residual so far targets don't overshoot
            # (gradient magnitude scales with |p - target|)
            err = np.linalg.norm(goal.get_end_pos_in_world() - target)
            scale = tau / max(1.0, err)
            for j in chain:
                # gradient is w.r.t. radians; angles stored in degrees
                j.angle = j.angle - np.degrees(scale * j.ik_angle_gradient)
        return float(np.linalg.norm(goal.get_end_pos_in_world() - target))

    # -- skinning (linearBlendSkinning stub, mesh.cpp:48-50) ---------------
    def skin_vertices(self, rest_vertices: np.ndarray,
                      time: Optional[float] = None) -> np.ndarray:
        """Linear-blend skinning: weights are inverse squared distances
        from the rest vertex to each joint's rest capsule segment."""
        V = np.asarray(rest_vertices, dtype=np.float64)
        if not self.joints:
            return V
        n = len(V)
        acc = np.zeros((n, 3))
        wsum = np.zeros(n)
        for j in self.joints:
            bind = j.get_bind_transformation()
            a = bind[:3, 3]  # rest base
            b = (bind @ np.append(j.axis, 1.0))[:3]  # rest end
            ab = b - a
            denom = max(float(ab @ ab), 1e-12)
            t = np.clip(((V - a) @ ab) / denom, 0.0, 1.0)
            closest = a + t[:, None] * ab
            d2 = np.maximum(((V - closest) ** 2).sum(axis=1), 1e-8)
            w = 1.0 / d2
            ang = j.get_angle(time) if time is not None else j.angle
            cur = j.get_transformation(time) @ _h(_rot_euler(ang), np.zeros(3))
            rest_inv = np.linalg.inv(bind)
            M = cur @ rest_inv
            hom = np.concatenate([V, np.ones((n, 1))], axis=1)
            acc += w[:, None] * (hom @ M.T)[:, :3]
            wsum += w
        return acc / wsum[:, None]
