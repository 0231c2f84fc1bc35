"""Cameras.

``Camera`` mirrors the reference orbit camera (src/camera.cpp:15-108,
src/camera.h:17-105) with ``generate_ray`` — a TODO stub in the
reference (src/camera.cpp:110-116) — implemented with the standard
Scotty3D sensor-plane semantics.  ``CutracerCamera`` reproduces the CUDA
renderer's hand-rolled basis (src/cudaRenderer.cu:1590-1606) including
its fixed ±0.5 frustum (src/cudaRenderer.cu:334-349) for
reference-compat rendering.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EPS = 1e-8


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class Camera:
    """Orbit camera (src/camera.h:17-105)."""

    def __init__(self):
        self.hFov = 50.0
        self.vFov = 35.0
        self.ar = 1.0
        self.nClip = 0.001
        self.fClip = 1000.0
        self.pos = np.zeros(3)
        self.targetPos = np.zeros(3)
        self.phi = 0.0
        self.theta = 0.0
        self.r = 1.0
        self.minR = 0.1
        self.maxR = 10.0
        self.c2w = np.eye(3)  # columns: screenX, screenY, dirToCamera
        self.screenW = 0
        self.screenH = 0
        self.screenDist = 1.0

    # -- configure (src/camera.cpp:15-33) --------------------------------
    def configure(self, info, screenW: int, screenH: int) -> None:
        self.screenW, self.screenH = screenW, screenH
        self.nClip, self.fClip = info.nClip, info.fClip
        self.hFov, self.vFov = info.hFov, info.vFov
        ar1 = math.tan(math.radians(self.hFov) / 2) / math.tan(
            math.radians(self.vFov) / 2
        )
        self.ar = screenW / screenH
        if ar1 < self.ar:  # hFov too small
            self.hFov = 2 * math.degrees(
                math.atan(math.tan(math.radians(self.vFov) / 2) * self.ar)
            )
        elif ar1 > self.ar:  # vFov too small
            self.vFov = 2 * math.degrees(
                math.atan(math.tan(math.radians(self.hFov) / 2) / self.ar)
            )
        self.screenDist = screenH / (2.0 * math.tan(math.radians(self.vFov) / 2))

    # -- placement (src/camera.cpp:35-47,86-108) -------------------------
    def place(self, targetPos, phi, theta, r, minR, maxR) -> None:
        self.r = min(max(r, minR), maxR)
        self.phi = phi + EPS if math.sin(phi) == 0 else phi
        self.targetPos = np.asarray(targetPos, dtype=np.float64)
        self.theta = theta
        self.minR, self.maxR = minR, maxR
        self.compute_position()

    def copy_placement(self, other: "Camera") -> None:
        self.pos = other.pos.copy()
        self.targetPos = other.targetPos.copy()
        self.phi, self.theta = other.phi, other.theta
        self.minR, self.maxR = other.minR, other.maxR
        self.c2w = other.c2w.copy()

    def set_screen_size(self, screenW: int, screenH: int) -> None:
        self.screenW, self.screenH = screenW, screenH
        self.ar = screenW / screenH
        self.hFov = 2 * math.degrees(math.atan(screenW / (2 * self.screenDist)))
        self.vFov = 2 * math.degrees(math.atan(screenH / (2 * self.screenDist)))

    def move_by(self, dx: float, dy: float, d: float) -> None:
        scale = d / self.screenDist
        disp = self.c2w[:, 0] * (dx * scale) + self.c2w[:, 1] * (dy * scale)
        self.pos += disp
        self.targetPos += disp

    def move_forward(self, dist: float) -> None:
        newR = min(max(self.r - dist, self.minR), self.maxR)
        self.pos = self.targetPos + (self.pos - self.targetPos) * (newR / self.r)
        self.r = newR

    def rotate_by(self, dPhi: float, dTheta: float) -> None:
        self.phi = min(max(self.phi + dPhi, 0.0), math.pi)
        self.theta += dTheta
        self.compute_position()

    def compute_position(self) -> None:
        sinPhi = math.sin(self.phi)
        if sinPhi == 0:
            self.phi += EPS
            sinPhi = math.sin(self.phi)
        dirToCamera = np.array(
            [
                self.r * sinPhi * math.sin(self.theta),
                self.r * math.cos(self.phi),
                self.r * sinPhi * math.cos(self.theta),
            ]
        )
        self.pos = self.targetPos + dirToCamera
        upVec = np.array([0.0, 1.0 if sinPhi > 0 else -1.0, 0.0])
        screenXDir = _unit(np.cross(upVec, dirToCamera))
        screenYDir = _unit(np.cross(dirToCamera, screenXDir))
        self.c2w = np.stack([screenXDir, screenYDir, _unit(dirToCamera)], axis=1)

    def up_dir(self) -> np.ndarray:
        return self.c2w[:, 1]

    def view_point(self) -> np.ndarray:
        return self.pos

    # -- ray generation (stub at src/camera.cpp:110-116; implemented) ----
    def generate_ray(self, x: float, y: float):
        """Ray through normalized image coords (x, y) in [0,1]^2, y up.

        The sensor plane sits one unit along -z in camera space spanning
        ±tan(fov/2); camera space maps to world by ``c2w`` (whose z
        column is the *backward* direction, see src/camera.cpp:100-107).
        Returns (origin, unit direction) world-space float64 arrays.
        """
        sx = (2.0 * x - 1.0) * math.tan(math.radians(self.hFov) / 2)
        sy = (2.0 * y - 1.0) * math.tan(math.radians(self.vFov) / 2)
        d_cam = np.array([sx, sy, -1.0])
        d_world = _unit(self.c2w @ d_cam)
        return self.pos.copy(), d_world

    def generate_rays(self, xs: np.ndarray, ys: np.ndarray):
        """Vectorized generate_ray for arrays of normalized coords."""
        tx = math.tan(math.radians(self.hFov) / 2)
        ty = math.tan(math.radians(self.vFov) / 2)
        d_cam = np.stack(
            [(2.0 * xs - 1.0) * tx, (2.0 * ys - 1.0) * ty, -np.ones_like(xs)],
            axis=-1,
        )
        d_world = d_cam @ self.c2w.T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        return np.broadcast_to(self.pos, d_world.shape).copy(), d_world

    def place_canonical(self, bbox_min, bbox_max, c_dir) -> None:
        """Scotty3D Application camera placement: orbit around the scene
        bbox centroid at 2x the canonical view distance, oriented along
        the collada camera direction (src/application.cpp:396-409)."""
        centroid = (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2.0
        extent = np.asarray(bbox_max) - np.asarray(bbox_min)
        canonical = np.linalg.norm(extent) / 2 * 1.5
        view_distance = canonical * 2
        c_dir = _unit(np.asarray(c_dir, dtype=np.float64))
        self.place(
            centroid,
            math.acos(np.clip(c_dir[1], -1.0, 1.0)),
            math.atan2(c_dir[0], c_dir[2]),
            view_distance,
            canonical / 10.0,
            canonical * 20.0,
        )


@dataclasses.dataclass
class CutracerCamera:
    """The CUDA renderer's camera model (src/cudaRenderer.cu:1590-1606).

    ``origin = c_pos + (0, 0.75, 0)``; ``lookAt = -c_dir`` where c_dir is
    the collada view direction pushed through the node transform *with*
    translation (the reference's quirk); ``left = unit((0,1,0) x c_dir)``;
    ``up = unit(left x c_dir)``.  Ray directions use the fixed ±0.5
    frustum of kernelPrimaryRays (src/cudaRenderer.cu:334-349).
    """

    origin: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    left: np.ndarray

    @staticmethod
    def from_collada(camera_info, transform: np.ndarray, compat_fudge: bool = True):
        c_pos = (transform @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
        c_dir = _unit((transform @ np.append(camera_info.view_dir, 1.0))[:3])
        origin = c_pos + (np.array([0.0, 0.75, 0.0]) if compat_fudge else 0.0)
        look_at = -c_dir
        left = _unit(np.cross(np.array([0.0, 1.0, 0.0]), c_dir))
        up = _unit(np.cross(left, c_dir))
        return CutracerCamera(origin=origin, look_at=look_at, up=up, left=left)

    def as_arrays(self):
        return (
            self.origin.astype(np.float32),
            self.look_at.astype(np.float32),
            self.up.astype(np.float32),
            self.left.astype(np.float32),
        )
