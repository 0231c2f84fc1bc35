"""Render-ready ("static") scene.

Numpy-backed equivalents of src/static_scene/: Scene{objects, lights}
(scene.h:44-72), SceneObject/Mesh/SphereObject (object.{h,cpp}),
Triangle / Sphere primitives (triangle.cpp, sphere.cpp — the latter's
intersection was a reference TODO stub, implemented here), and the
SceneLight hierarchy with sample_L (light.{h,cpp}).

These host types carry dense arrays so that flattening to the device
scene (render/flatscene.py) and the CPU oracle stay vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .bsdf import BSDF

INF_D = np.inf


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


# ---------------------------------------------------------------------------
# objects
# ---------------------------------------------------------------------------


class SceneObject:
    """Renderable object interface (src/static_scene/scene.h:15-28)."""

    def get_bsdf(self) -> BSDF:
        raise NotImplementedError


class Mesh(SceneObject):
    """Triangle mesh with shared vertex positions/normals
    (src/static_scene/object.cpp:17-59)."""

    def __init__(self, positions: np.ndarray, normals: np.ndarray,
                 indices: np.ndarray, bsdf: BSDF):
        self.positions = np.asarray(positions, dtype=np.float64)
        self.normals = np.asarray(normals, dtype=np.float64)
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1, 3)
        self.bsdf = bsdf

    def get_bsdf(self) -> BSDF:
        return self.bsdf

    def num_triangles(self) -> int:
        return len(self.indices)

    def triangle_arrays(self):
        """(verts [T,3,3], normals [T,3,3]) per-triangle expanded arrays —
        what the CUDA uploader reads via Triangle::positions()/normals()
        (src/static_scene/triangle.cpp:223-233)."""
        return self.positions[self.indices], self.normals[self.indices]


class SphereObject(SceneObject):
    """Analytic sphere (src/static_scene/object.cpp:76-88)."""

    def __init__(self, o, r: float, bsdf: BSDF):
        self.o = np.asarray(o, dtype=np.float64)
        self.r = float(r)
        self.bsdf = bsdf

    def get_bsdf(self) -> BSDF:
        return self.bsdf


# ---------------------------------------------------------------------------
# primitives (API parity; bulk data lives in the owning objects)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Intersection:
    """Closest-hit record (companion of src/static_scene/primitive.h)."""

    t: float = INF_D
    primitive: object = None
    bsdf: Optional[BSDF] = None
    n: np.ndarray = None


class Primitive:
    """Single primitive interface (src/static_scene/primitive.h:15-67)."""

    def get_bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def intersect(self, o, d, isect: Optional[Intersection] = None) -> bool:
        raise NotImplementedError

    def get_bsdf(self) -> BSDF:
        raise NotImplementedError


class Triangle(Primitive):
    """Mesh triangle (src/static_scene/triangle.{h,cpp})."""

    #: bbox padding (src/static_scene/triangle.cpp:38-46 PADDING 1e-3).
    PADDING = 1e-3

    def __init__(self, mesh: Mesh, v1: int, v2: int, v3: int):
        self.mesh = mesh
        self.v = (v1, v2, v3)

    def positions(self):
        p = self.mesh.positions
        return p[self.v[0]], p[self.v[1]], p[self.v[2]]

    def normals(self):
        n = self.mesh.normals
        return n[self.v[0]], n[self.v[1]], n[self.v[2]]

    def get_bbox(self):
        p = np.stack(self.positions())
        return p.min(axis=0) - self.PADDING, p.max(axis=0) + self.PADDING

    def get_bsdf(self):
        return self.mesh.get_bsdf()

    def intersect(self, o, d, isect: Optional[Intersection] = None) -> bool:
        """Plane + inside-outside test with barycentric normal
        interpolation and two-sided flip (semantics of
        src/static_scene/triangle.cpp:119-209)."""
        a, b, c = self.positions()
        n_plane = np.cross(b - a, c - a)
        denom = np.dot(n_plane, d)
        if abs(denom) < 1e-12:
            return False
        t = (np.dot(n_plane, a) - np.dot(n_plane, o)) / denom
        if t < 0 or (isect is not None and t >= isect.t):
            return False
        p = o + t * d
        if np.dot(n_plane, np.cross(b - a, p - a)) < 0:
            return False
        if np.dot(n_plane, np.cross(c - b, p - b)) < 0:
            return False
        if np.dot(n_plane, np.cross(a - c, p - c)) < 0:
            return False
        if isect is not None:
            total = np.linalg.norm(n_plane)
            n0, n1, n2 = self.normals()
            bC = np.linalg.norm(np.cross(a - p, b - p)) / total
            bA = np.linalg.norm(np.cross(b - p, c - p)) / total
            bB = np.linalg.norm(np.cross(c - p, a - p)) / total
            n = _unit(bA * n0 + bB * n1 + bC * n2)
            if np.dot(n, d) > 0:
                n = -n
            isect.t = t
            isect.primitive = self
            isect.bsdf = self.get_bsdf()
            isect.n = n
        return True


class Sphere(Primitive):
    """Analytic sphere primitive.  The reference left every intersect
    method a TODO stub (src/static_scene/sphere.cpp:11-36); implemented
    here with the standard quadratic."""

    def __init__(self, obj: SphereObject, o, r: float):
        self.object = obj
        self.o = np.asarray(o, dtype=np.float64)
        self.r = float(r)

    def get_bbox(self):
        return self.o - self.r, self.o + self.r

    def get_bsdf(self):
        return self.object.get_bsdf()

    def _solve(self, o, d):
        oc = o - self.o
        a = np.dot(d, d)
        b = 2.0 * np.dot(oc, d)
        c = np.dot(oc, oc) - self.r * self.r
        disc = b * b - 4 * a * c
        if disc < 0:
            return None
        sq = np.sqrt(disc)
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
        return t1, t2

    def intersect(self, o, d, isect: Optional[Intersection] = None) -> bool:
        ts = self._solve(np.asarray(o), np.asarray(d))
        if ts is None:
            return False
        t = ts[0] if ts[0] > 0 else ts[1]
        if t <= 0 or (isect is not None and t >= isect.t):
            return False
        if isect is not None:
            p = np.asarray(o) + t * np.asarray(d)
            n = _unit(p - self.o)
            if np.dot(n, d) > 0:
                n = -n
            isect.t = t
            isect.primitive = self
            isect.bsdf = self.get_bsdf()
            isect.n = n
        return True


# ---------------------------------------------------------------------------
# lights (src/static_scene/light.{h,cpp})
# ---------------------------------------------------------------------------


class SceneLight:
    """Light interface: sample_L(p) -> (radiance, wi, distToLight, pdf)
    (src/static_scene/scene.h:33-38)."""

    def sample_L(self, p: np.ndarray, rng: np.random.Generator):
        raise NotImplementedError

    def is_delta_light(self) -> bool:
        raise NotImplementedError


class DirectionalLight(SceneLight):
    """(src/static_scene/light.cpp:12-24)"""

    def __init__(self, rad, lightDir):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.dirToLight = -_unit(np.asarray(lightDir, dtype=np.float64))

    def sample_L(self, p, rng):
        return self.radiance, self.dirToLight, INF_D, 1.0

    def is_delta_light(self):
        return True


class InfiniteHemisphereLight(SceneLight):
    """(src/static_scene/light.cpp:28-43)"""

    def __init__(self, rad):
        self.radiance = np.asarray(rad, dtype=np.float64)
        # sample-to-world: y-up hemisphere (light.cpp:30-32)
        self.sampleToWorld = np.array(
            [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
        ).T

    def sample_L(self, p, rng):
        # uniform hemisphere about +y
        u1, u2 = rng.random(), rng.random()
        z = u1
        r = np.sqrt(max(0.0, 1.0 - z * z))
        phi = 2 * np.pi * u2
        dir_local = np.array([r * np.cos(phi), r * np.sin(phi), z])
        wi = self.sampleToWorld @ dir_local
        return self.radiance, wi, INF_D, 1.0 / (2.0 * np.pi)

    def is_delta_light(self):
        return False


class PointLight(SceneLight):
    """(src/static_scene/light.cpp:47-57)"""

    def __init__(self, rad, pos):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.position = np.asarray(pos, dtype=np.float64)

    def sample_L(self, p, rng):
        d = self.position - p
        dist = np.linalg.norm(d)
        return self.radiance, d / dist, dist, 1.0

    def is_delta_light(self):
        return True


class SpotLight(SceneLight):
    """Spot light — empty in the reference (light.cpp:61-68); implemented
    as a point light with an angular cutoff."""

    def __init__(self, rad, pos, direction, angle_deg: float):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.position = np.asarray(pos, dtype=np.float64)
        self.direction = _unit(np.asarray(direction, dtype=np.float64))
        self.angle = np.radians(angle_deg)

    def sample_L(self, p, rng):
        d = self.position - p
        dist = np.linalg.norm(d)
        wi = d / dist
        inside = np.dot(-wi, self.direction) >= np.cos(self.angle / 2)
        rad = self.radiance if inside else np.zeros(3)
        return rad, wi, dist, 1.0

    def is_delta_light(self):
        return True


class AreaLight(SceneLight):
    """Rectangular one-sided area light (src/static_scene/light.cpp:72-93)."""

    def __init__(self, rad, pos, direction, dim_x, dim_y):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.position = np.asarray(pos, dtype=np.float64)
        self.direction = np.asarray(direction, dtype=np.float64)
        self.dim_x = np.asarray(dim_x, dtype=np.float64)
        self.dim_y = np.asarray(dim_y, dtype=np.float64)
        self.area = np.linalg.norm(dim_x) * np.linalg.norm(dim_y)

    def sample_L(self, p, rng):
        sample = rng.random(2) - 0.5
        d = self.position + sample[0] * self.dim_x + sample[1] * self.dim_y - p
        cosTheta = np.dot(d, self.direction)
        sqDist = np.dot(d, d)
        dist = np.sqrt(sqDist)
        wi = d / dist
        pdf = sqDist / (self.area * abs(cosTheta))
        rad = self.radiance if cosTheta < 0 else np.zeros(3)
        return rad, wi, dist, pdf

    def is_delta_light(self):
        return False


class SphereLight(SceneLight):
    """Sphere light — empty in the reference (light.cpp:97-103);
    implemented by uniform surface-area sampling."""

    def __init__(self, rad, sphere: SphereObject):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.sphere = sphere

    def sample_L(self, p, rng):
        u1, u2 = rng.random(), rng.random()
        z = 2 * u1 - 1
        r = np.sqrt(max(0.0, 1 - z * z))
        phi = 2 * np.pi * u2
        n = np.array([r * np.cos(phi), r * np.sin(phi), z])
        q = self.sphere.o + self.sphere.r * n
        d = q - p
        sqDist = np.dot(d, d)
        dist = np.sqrt(sqDist)
        wi = d / dist
        cosTheta = np.dot(-wi, n)
        area = 4 * np.pi * self.sphere.r ** 2
        if cosTheta <= 0:
            return np.zeros(3), wi, dist, 1.0
        pdf = sqDist / (area * cosTheta)
        return self.radiance, wi, dist, pdf

    def is_delta_light(self):
        return False


class MeshLight(SceneLight):
    """Mesh light — empty in the reference (light.cpp:107-113); kept as
    API surface, returns black."""

    def __init__(self, rad, mesh: Mesh):
        self.radiance = np.asarray(rad, dtype=np.float64)
        self.mesh = mesh

    def sample_L(self, p, rng):
        return np.zeros(3), np.array([0.0, 0.0, 1.0]), INF_D, 1.0

    def is_delta_light(self):
        return False


class EnvironmentLight(SceneLight):
    """Environment (IBL) light.  A TODO stub in the reference
    (src/static_scene/environment_light.cpp:6-21); implemented with
    luminance-weighted importance sampling over the lat-long map."""

    def __init__(self, envmap: np.ndarray):
        """envmap: [H, W, 3] float radiance map (equirectangular)."""
        self.envmap = np.asarray(envmap, dtype=np.float64)
        h, w, _ = self.envmap.shape
        lum = self.envmap @ np.array([0.2126, 0.7152, 0.0722])
        theta = (np.arange(h) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[:, None]
        flat = weights.reshape(-1)
        total = flat.sum()
        self._pdf = flat / total if total > 0 else np.full(flat.size, 1.0 / flat.size)
        self._cdf = np.cumsum(self._pdf)

    def _dir_from_pixel(self, iy, ix):
        h, w, _ = self.envmap.shape
        theta = (iy + 0.5) / h * np.pi
        phi = (ix + 0.5) / w * 2 * np.pi
        st = np.sin(theta)
        return np.array([st * np.cos(phi), np.cos(theta), st * np.sin(phi)])

    def sample_L(self, p, rng):
        h, w, _ = self.envmap.shape
        idx = int(np.searchsorted(self._cdf, rng.random()))
        idx = min(idx, h * w - 1)
        iy, ix = divmod(idx, w)
        wi = self._dir_from_pixel(iy, ix)
        theta = (iy + 0.5) / h * np.pi
        solid_angle = (2 * np.pi / w) * (np.pi / h) * max(np.sin(theta), 1e-8)
        pdf = self._pdf[idx] / solid_angle
        return self.envmap[iy, ix], wi, INF_D, max(pdf, 1e-12)

    def sample_dir(self, d: np.ndarray) -> np.ndarray:
        """Radiance looking along world direction d (y-up lat-long)."""
        h, w, _ = self.envmap.shape
        d = _unit(d)
        theta = np.arccos(np.clip(d[1], -1, 1))
        phi = np.arctan2(d[2], d[0]) % (2 * np.pi)
        iy = min(int(theta / np.pi * h), h - 1)
        ix = min(int(phi / (2 * np.pi) * w), w - 1)
        return self.envmap[iy, ix]

    def is_delta_light(self):
        return False


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------


class Scene:
    """objects + lights (src/static_scene/scene.h:44-72)."""

    def __init__(self, objects: List[SceneObject], lights: List[SceneLight]):
        self.objects = objects
        self.lights = lights

    def bbox(self):
        mins, maxs = [], []
        for obj in self.objects:
            if isinstance(obj, Mesh) and len(obj.positions):
                mins.append(obj.positions.min(axis=0))
                maxs.append(obj.positions.max(axis=0))
            elif isinstance(obj, SphereObject):
                mins.append(obj.o - obj.r)
                maxs.append(obj.o + obj.r)
        if not mins:
            return np.zeros(3), np.zeros(3)
        return np.min(mins, axis=0), np.max(maxs, axis=0)
