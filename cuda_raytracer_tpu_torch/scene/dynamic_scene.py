"""Editable ("dynamic") scene graph.

Python equivalents of src/dynamic_scene/: the Scene container
(scene.h:195-333), Mesh (mesh.cpp:21-46, 726-788), Sphere
(sphere.cpp:9-53), and the light wrappers (ambient_light.h,
directional_light.h, area_light.h, point_light.h, spot_light.h,
environment_light.h), plus the instance factories of
src/cudaRenderer.cu:40-78 (init_light / init_sphere / init_polymesh) and
Application::load's node walk (src/application.cpp:84-130).

``get_static_scene`` converts to the render-ready
:mod:`~cuda_raytracer_tpu_torch.scene.static_scene` form;
``get_transformed_static_scene(t)`` applies per-object animated TRS
splines first (semantics of src/dynamic_scene/mesh.cpp:746-788).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import static_scene
from .bsdf import BSDF, DiffuseBSDF
from .camera import Camera, CutracerCamera
from .collada_info import (
    CameraInfo,
    InstanceType,
    LightInfo,
    LightType,
    PolymeshInfo,
    SceneInfo,
    SphereInfo,
)
from .mesh import PolygonMesh
from .spline import Spline


def _xform_point(transform: np.ndarray, p) -> np.ndarray:
    out = transform @ np.append(np.asarray(p, dtype=np.float64), 1.0)
    return out[:3] / out[3] if out[3] != 0 else out[:3]


def _xform_point_h1(transform: np.ndarray, p) -> np.ndarray:
    """transform * (p, 1) truncated to 3D without the w divide — the
    reference's ``.to3D()`` used throughout the light wrappers."""
    return (transform @ np.append(np.asarray(p, dtype=np.float64), 1.0))[:3]


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class SceneObject:
    """Dynamic object interface (scene.h:37-149)."""

    def get_static_object(self) -> static_scene.SceneObject:
        raise NotImplementedError

    def get_transformed_static_object(self, t: float) -> static_scene.SceneObject:
        return self.get_static_object()

    def get_bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class SceneLight:
    """Dynamic light interface (scene.h:187-190)."""

    def get_static_light(self) -> static_scene.SceneLight:
        raise NotImplementedError


class Mesh(SceneObject):
    """Halfedge-backed mesh object (mesh.cpp:21-46).  Vertices are
    transformed into world space at construction; animated TRS keyframes
    live in position/rotation/scale splines (mesh.h keyframe fields)."""

    def __init__(self, polymesh: PolymeshInfo, transform: np.ndarray):
        polygons = [list(p.vertex_indices) for p in polymesh.polygons]
        mesh = PolygonMesh(np.asarray(polymesh.vertices, dtype=np.float64), polygons)
        self.mesh = mesh.transformed(transform)
        if polymesh.material is not None and polymesh.material.bsdf is not None:
            self.bsdf: BSDF = polymesh.material.bsdf
        else:
            # mesh.cpp:36-38 defaults to a white diffuse
            self.bsdf = DiffuseBSDF(np.array([1.0, 1.0, 1.0]))
        # animation channels (mesh.h; evaluated in
        # get_transformed_static_object, mesh.cpp:746-788)
        self.positions = Spline()
        self.rotations = Spline()
        self.scales = Spline()
        self.scales.set_value(0.0, np.array([1.0, 1.0, 1.0]))
        # current editable TRS, snapshotted into the splines by
        # keyframe() (mesh.cpp:67-72 reads these live fields)
        self.position = np.zeros(3)
        self.rotation = np.zeros(3)  # Euler XYZ, degrees
        self.scale = np.array([1.0, 1.0, 1.0])
        #: optional animation rig (mesh.h skeleton field)
        self.skeleton = None

    def keyframe(self, t: float) -> None:
        """Snapshot the current TRS into the splines (mesh.cpp:67-72);
        forwards to the skeleton when rigged."""
        self.positions.set_value(t, np.array(self.position, dtype=np.float64))
        self.rotations.set_value(t, np.array(self.rotation, dtype=np.float64))
        self.scales.set_value(t, np.array(self.scale, dtype=np.float64))
        if self.skeleton is not None:
            self.skeleton.keyframe(t)

    def unkeyframe(self, t: float) -> None:
        """Drop knots near ``t`` (mesh.cpp:74-79, tolerance 0.1)."""
        self.positions.remove_knot(t, 0.1)
        self.rotations.remove_knot(t, 0.1)
        self.scales.remove_knot(t, 0.1)
        if self.skeleton is not None:
            self.skeleton.unkeyframe(t)

    def get_bbox(self):
        return self.mesh.bbox()

    # -- wave simulation (forward_euler / symplectic_euler stubs at
    # src/dynamic_scene/mesh.cpp:48-66) ---------------------------------
    def _wave_state(self):
        n = len(self.mesh.vertices)
        if getattr(self, "_wave_off", None) is None or len(
            self._wave_off
        ) != n:
            self._wave_off = np.zeros(n)
            self._wave_vel = np.zeros(n)
            # vertex adjacency from the polygon rings
            nbr = [set() for _ in range(n)]
            for poly in self.mesh.polygons:
                for k, v in enumerate(poly):
                    nbr[v].add(poly[k - 1])
                    nbr[v].add(poly[(k + 1) % len(poly)])
            self._wave_nbrs = [sorted(s) for s in nbr]
        return self._wave_off, self._wave_vel

    def _wave_laplacian(self) -> np.ndarray:
        off, _ = self._wave_state()
        lap = np.zeros_like(off)
        for i, ns in enumerate(self._wave_nbrs):
            if ns:
                lap[i] = np.mean(off[ns]) - off[i]
        return lap

    def forward_euler(self, timestep: float, damping_factor: float) -> None:
        """u += dt*v; v += dt*laplace(u) using the OLD offsets, then
        damp (the explicit scheme of mesh.cpp:52-57)."""
        off, vel = self._wave_state()
        lap = self._wave_laplacian()
        off += timestep * vel
        vel += timestep * lap
        vel *= 1.0 - damping_factor
        self._wave_off, self._wave_vel = off, vel

    def symplectic_euler(self, timestep: float, damping_factor: float) -> None:
        """v += dt*laplace(u) first, then u += dt*v (the stable
        semi-implicit scheme of mesh.cpp:59-66)."""
        off, vel = self._wave_state()
        vel += timestep * self._wave_laplacian()
        vel *= 1.0 - damping_factor
        off += timestep * vel
        self._wave_off, self._wave_vel = off, vel

    def set_wave_offset(self, vertex: int, value: float) -> None:
        off, _ = self._wave_state()
        off[vertex] = value

    def wave_vertices(self) -> np.ndarray:
        """Current vertices displaced along vertex normals by the wave
        offsets (how the reference renders the simulation)."""
        off, _ = self._wave_state()
        normals = self.mesh.vertex_normals()
        return self.mesh.vertices + off[:, None] * normals

    def _to_static(self, verts: np.ndarray) -> static_scene.Mesh:
        m = PolygonMesh(verts, self.mesh.polygons)
        tris = m.triangulate()
        normals = m.vertex_normals(tris)
        return static_scene.Mesh(verts, normals, tris, self.bsdf)

    def get_static_object(self) -> static_scene.Mesh:
        return self._to_static(self.mesh.vertices)

    # -- halfedge editing (mesh.h local-op forwarding) ---------------------
    def halfedge_mesh(self):
        """Editable halfedge view of this mesh (built lazily; edits
        mutate it in place and are synced back via _sync_from_halfedge)."""
        from ..geometry import HalfedgeMesh

        if getattr(self, "_hm", None) is None:
            self._hm = HalfedgeMesh(
                [list(p) for p in self.mesh.polygons], self.mesh.vertices
            )
        return self._hm

    def _sync_from_halfedge(self) -> None:
        if getattr(self, "_hm", None) is None:
            # never opened for editing: the polygon mesh is current (the
            # JAX package raises AttributeError here, so its session
            # save fails on a mesh no edit has touched)
            return
        positions, polys = self._hm.to_polygon_soup()
        self.mesh = PolygonMesh(positions, polys)

    def get_transformed_static_object(self, t: float) -> static_scene.Mesh:
        """Apply the animated TRS at time ``t`` to every vertex
        (mesh.cpp:746-788)."""
        pos = self.positions.evaluate(t, default=np.zeros(3))
        rot = self.rotations.evaluate(t, default=np.zeros(3))
        scale = self.scales.evaluate(t, default=np.array([1.0, 1.0, 1.0]))
        transform = _trs_matrix(pos, rot, scale)
        base = self.mesh.vertices
        if self.skeleton is not None:
            # linear-blend skinning before the object TRS
            # (mesh.cpp:48-50 stub, implemented in scene/skeleton.py)
            base = self.skeleton.skin_vertices(base, t)
        hom = np.concatenate([base, np.ones((len(base), 1))], axis=1)
        verts = (hom @ transform.T)[:, :3]
        return self._to_static(verts)


class Sphere(SceneObject):
    """Analytic sphere object (sphere.cpp:9-17,51-53)."""

    def __init__(self, info: SphereInfo, position, scale: float):
        self.p = np.asarray(position, dtype=np.float64)
        self.r = info.radius * scale
        if info.material is not None and info.material.bsdf is not None:
            self.bsdf: BSDF = info.material.bsdf
        else:
            self.bsdf = DiffuseBSDF(np.array([0.5, 0.5, 0.5]))

    def get_bbox(self):
        return self.p - self.r, self.p + self.r

    def get_static_object(self) -> static_scene.SphereObject:
        return static_scene.SphereObject(self.p, self.r, self.bsdf)


class AmbientLight(SceneLight):
    """ambient_light.h:12-22 — becomes an infinite hemisphere light."""

    def __init__(self, light_info: LightInfo):
        self.spectrum = np.asarray(light_info.spectrum, dtype=np.float64)

    def get_static_light(self):
        return static_scene.InfiniteHemisphereLight(self.spectrum)


class DirectionalLight(SceneLight):
    """directional_light.h:12-24.

    Note the reference-faithful double negation: this negates
    (directional_light.h:15) and the static light negates again
    (light.cpp:15), so ``dirToLight`` ends up pointing ALONG the raw
    collada ``light_info.direction`` — scenes must author direction as
    surface-to-light."""

    def __init__(self, light_info: LightInfo, transform: np.ndarray):
        self.spectrum = np.asarray(light_info.spectrum, dtype=np.float64)
        self.direction = -_unit(_xform_point_h1(transform, light_info.direction))

    def get_static_light(self):
        return static_scene.DirectionalLight(self.spectrum, self.direction)


class AreaLight(SceneLight):
    """area_light.h:12-31 — position/direction/dim_x/dim_y pushed through
    the node transform."""

    def __init__(self, light_info: LightInfo, transform: np.ndarray):
        self.spectrum = np.asarray(light_info.spectrum, dtype=np.float64)
        self.position = _xform_point_h1(transform, light_info.position)
        self.direction = _unit(
            _xform_point_h1(transform, light_info.direction) - self.position
        )
        dim_y = light_info.up
        dim_x = np.cross(light_info.up, light_info.direction)
        self.dim_x = _xform_point_h1(transform, dim_x) - self.position
        self.dim_y = _xform_point_h1(transform, dim_y) - self.position

    def get_static_light(self):
        return static_scene.AreaLight(
            self.spectrum, self.position, self.direction, self.dim_x, self.dim_y
        )


class PointLight(SceneLight):
    """point_light.h:15-25."""

    def __init__(self, light_info: LightInfo, transform: np.ndarray):
        self.spectrum = np.asarray(light_info.spectrum, dtype=np.float64)
        self.position = _xform_point_h1(transform, light_info.position)

    def get_static_light(self):
        return static_scene.PointLight(self.spectrum, self.position)


class SpotLight(SceneLight):
    """spot_light.h:13-27 (fixed 90 degree cone as in the reference)."""

    def __init__(self, light_info: LightInfo, transform: np.ndarray):
        self.spectrum = np.asarray(light_info.spectrum, dtype=np.float64)
        self.position = _xform_point_h1(transform, light_info.position)
        self.direction = _unit(
            _xform_point_h1(transform, light_info.direction) - self.position
        )

    def get_static_light(self):
        return static_scene.SpotLight(
            self.spectrum, self.position, self.direction, 90.0
        )


class EnvironmentLight(SceneLight):
    """environment_light.h — wraps an HDR lat-long radiance map."""

    def __init__(self, envmap: np.ndarray):
        self.envmap = envmap

    def get_static_light(self):
        return static_scene.EnvironmentLight(self.envmap)


def init_light(light: LightInfo, transform: np.ndarray) -> Optional[SceneLight]:
    """Light factory (src/cudaRenderer.cu:40-59)."""
    if light.light_type == LightType.AMBIENT:
        return AmbientLight(light)
    if light.light_type == LightType.DIRECTIONAL:
        return DirectionalLight(light, transform)
    if light.light_type == LightType.AREA:
        return AreaLight(light, transform)
    if light.light_type == LightType.POINT:
        return PointLight(light, transform)
    if light.light_type == LightType.SPOT:
        return SpotLight(light, transform)
    return None


def init_sphere(sphere: SphereInfo, transform: np.ndarray) -> Sphere:
    """Sphere factory: translation from the transformed origin, uniform
    scale from a transformed unit vector (src/cudaRenderer.cu:61-73)."""
    position = _xform_point(transform, np.zeros(3))
    scale = np.linalg.norm((transform @ np.array([1.0, 0.0, 0.0, 0.0]))[:3])
    return Sphere(sphere, position, scale)


def init_polymesh(polymesh: PolymeshInfo, transform: np.ndarray) -> Mesh:
    return Mesh(polymesh, transform)


class Scene:
    """Dynamic scene container (scene.h:195-333, trimmed to the
    renderer-facing surface)."""

    def __init__(self, objects: List[SceneObject], lights: List[SceneLight]):
        self.objects = objects
        self.lights = lights
        #: current edit selection: (Mesh object, halfedge element) —
        #: element handles are invalidated by every edit, like the
        #: reference's Selection (scene.h:262-272)
        self.selected_object: Optional[Mesh] = None
        self.selected_element = None

    # -- mesh-edit dispatch (scene.h:275-290) ------------------------------
    def select(self, obj: "Mesh", element=None) -> None:
        self.selected_object = obj
        self.selected_element = element

    def _edit(self, op, element_types) -> bool:
        from ..geometry.halfedge import Edge, Face, Vertex  # noqa: F401

        obj, el = self.selected_object, self.selected_element
        if obj is None or el is None or not isinstance(el, element_types):
            return False
        result = op(obj.halfedge_mesh(), el)
        if result is None:
            return False
        obj._sync_from_halfedge()
        self.selected_element = result
        return True

    def collapse_selected_element(self) -> bool:
        from ..geometry.halfedge import Edge, Face
        from ..geometry.meshedit import collapse_edge, collapse_face

        if isinstance(self.selected_element, Face):
            return self._edit(collapse_face, Face)
        return self._edit(collapse_edge, Edge)

    def flip_selected_edge(self) -> bool:
        from ..geometry.halfedge import Edge
        from ..geometry.meshedit import flip_edge

        return self._edit(flip_edge, Edge)

    def split_selected_edge(self) -> bool:
        from ..geometry.halfedge import Edge
        from ..geometry.meshedit import split_edge

        return self._edit(split_edge, Edge)

    def erase_selected_element(self) -> bool:
        from ..geometry.halfedge import Edge, Vertex
        from ..geometry.meshedit import erase_edge, erase_vertex

        if isinstance(self.selected_element, Vertex):
            return self._edit(erase_vertex, Vertex)
        return self._edit(erase_edge, Edge)

    def _whole_mesh_edit(self, op) -> bool:
        obj = self.selected_object
        if obj is None:
            return False
        op(obj.halfedge_mesh())
        obj._sync_from_halfedge()
        self.selected_element = None
        return True

    def upsample_selected_mesh(self) -> bool:
        from ..geometry.meshedit import MeshResampler

        return self._whole_mesh_edit(MeshResampler.upsample)

    def downsample_selected_mesh(self) -> bool:
        from ..geometry.meshedit import MeshResampler

        return self._whole_mesh_edit(MeshResampler.downsample)

    def resample_selected_mesh(self) -> bool:
        from ..geometry.meshedit import MeshResampler

        return self._whole_mesh_edit(MeshResampler.resample)

    def triangulate_selection(self) -> bool:
        return self._whole_mesh_edit(lambda hm: hm.triangulate())

    def subdivide_selection(self, use_catmull_clark: bool = False) -> bool:
        from ..geometry.meshedit import subdivide

        return self._whole_mesh_edit(
            lambda hm: subdivide(hm, catmull_clark=use_catmull_clark)
        )

    def get_bbox(self):
        mins, maxs = [], []
        for o in self.objects:
            lo, hi = o.get_bbox()
            mins.append(lo)
            maxs.append(hi)
        if not mins:
            return np.zeros(3), np.zeros(3)
        return np.min(mins, axis=0), np.max(maxs, axis=0)

    def get_static_scene(self) -> static_scene.Scene:
        """scene.h:296 — convert every object/light to its static form."""
        return static_scene.Scene(
            [o.get_static_object() for o in self.objects],
            [l.get_static_light() for l in self.lights],
        )

    def get_transformed_static_scene(self, t: float) -> static_scene.Scene:
        """scene.h:301 — static scene with animated transforms at time t."""
        return static_scene.Scene(
            [o.get_transformed_static_object(t) for o in self.objects],
            [l.get_static_light() for l in self.lights],
        )


def _trs_matrix(pos, rot_deg, scale) -> np.ndarray:
    """TRS compose (rotation XYZ Euler, degrees) as mesh.cpp:756-772."""
    rx, ry, rz = np.radians(np.asarray(rot_deg, dtype=np.float64))

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    r = rot_z(rz) @ rot_y(ry) @ rot_x(rx)
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, dtype=np.float64)[None, :]
    m[:3, 3] = np.asarray(pos, dtype=np.float64)
    return m


def load_from_scene_info(scene_info: SceneInfo):
    """Build a dynamic scene + cameras from parsed COLLADA nodes.

    Combines CudaRenderer::loadFromSceneInfo (src/cudaRenderer.cu:1572-1677)
    and Application::load (src/application.cpp:84-130).  Returns
    (scene, camera_info, camera_transform, cutracer_camera) where the
    last is the CUDA renderer's camera basis.
    """
    lights: List[SceneLight] = []
    objects: List[SceneObject] = []
    camera_info: Optional[CameraInfo] = None
    camera_transform = np.eye(4)
    camera_node = None
    cutracer_camera: Optional[CutracerCamera] = None

    for node in scene_info.nodes:
        instance = node.instance
        if instance is None:
            continue
        transform = node.transform
        if instance.type == InstanceType.CAMERA:
            camera_info = instance
            camera_transform = transform
            camera_node = node
            cutracer_camera = CutracerCamera.from_collada(instance, transform)
        elif instance.type == InstanceType.LIGHT:
            light = init_light(instance, transform)
            if light is not None:
                light.source_node = node  # for session save round trips
                lights.append(light)
        elif instance.type == InstanceType.SPHERE:
            sph = init_sphere(instance, transform)
            sph.source_node = node
            objects.append(sph)
        elif instance.type == InstanceType.POLYMESH:
            msh = init_polymesh(instance, transform)
            msh.source_node = node
            objects.append(msh)

    if not lights:  # default ambient (cudaRenderer.cu:1629-1633)
        lights.append(AmbientLight(LightInfo()))
    scene = Scene(objects, lights)
    scene.camera_node = camera_node  # for session save round trips
    return scene, camera_info, camera_transform, cutracer_camera
