"""COLLADA (.dae) scene parser.

A from-scratch Python equivalent of the reference parser
(src/collada/collada.cpp:116-957) built on xml.etree.  Produces a
:class:`SceneInfo` — a flat list of (instance, transform) nodes — with
the same semantics the reference renderer depends on:

* up-axis correction: X_UP / Z_UP documents get a global change-of-basis
  transform (collada.cpp:146-188);
* node transforms: a ``<matrix>`` wins outright, otherwise
  rotate/translate/scale elements are combined in document order
  (collada.cpp:230-330).  Unlike the reference — whose rotate parser
  misreads axis-angle text (collada.cpp:261-289) and whose scale parser
  drops the z component (collada.cpp:311-321) — we apply the
  mathematically correct axis-angle rotation and full xyz scale; the
  shipped media/ scenes all use ``<matrix>`` so behavior is identical
  there;
* the CMU462 material profile: emission / mirror / refraction / glass
  override the common-profile phong diffuse color; otherwise a gray 0.5
  diffuse (collada.cpp:868-957);
* lights: ambient / directional / area / point / spot colors and
  attenuations (collada.cpp:473-575);
* cameras: xfov/yfov/znear/zfar with aspect-ratio fallback
  (collada.cpp:429-471);
* geometry: polylist and triangles primitives with POSITION and NORMAL
  sources (collada.cpp:601-866); spheres via the CMU462
  ``<sphere><radius>`` extra (collada.cpp:577-599).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional
from xml.etree import ElementTree

import numpy as np

from .bsdf import DiffuseBSDF, EmissionBSDF, GlassBSDF, MirrorBSDF, RefractionBSDF
from .collada_info import (
    CameraInfo,
    LightInfo,
    LightType,
    MaterialInfo,
    Node,
    Polygon,
    PolymeshInfo,
    SceneInfo,
    SphereInfo,
)

_TAG_NS = re.compile(r"\{[^}]*\}")


def _strip_ns(tree: ElementTree.Element) -> None:
    for el in tree.iter():
        el.tag = _TAG_NS.sub("", el.tag)


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.float64)


def _spectrum(text: str) -> np.ndarray:
    vals = [float(t) for t in text.split()]
    return np.array(vals[:3], dtype=np.float64)


class ColladaParser:
    """Stateful parser mirroring the reference's static-parser structure."""

    def __init__(self):
        self.scene: Optional[SceneInfo] = None
        self.up = np.array([0.0, 1.0, 0.0])
        self.transform = np.eye(4)
        self.sources: Dict[str, ElementTree.Element] = {}

    # -- public API (collada.h:33-34) ------------------------------------
    @staticmethod
    def load(filename: str, scene_info: SceneInfo) -> int:
        parser = ColladaParser()
        try:
            tree = ElementTree.parse(filename)
        except (ElementTree.ParseError, OSError):
            return -1
        root = tree.getroot()
        _strip_ns(root)
        if _TAG_NS.sub("", root.tag) != "COLLADA":
            return -1
        parser.scene = scene_info
        parser._uri_load(root)
        parser._load_asset(root)

        # A document has exactly one visual scene (collada.cpp:191-207).
        e_scene = parser._get_element(root, "scene/instance_visual_scene")
        if e_scene is None:
            return -1
        for e_node in e_scene.findall("node"):
            parser._parse_node(e_node)
        return 0

    @staticmethod
    def save(filename: str, scene_info: SceneInfo) -> int:
        from .collada_writer import write_scene

        return write_scene(filename, scene_info)

    # -- helpers (collada.cpp:51-114) ------------------------------------
    def _uri_load(self, el: ElementTree.Element) -> None:
        for child in el.iter():
            cid = child.get("id")
            if cid is not None:
                self.sources[cid] = child

    def _uri_find(self, cid: str) -> Optional[ElementTree.Element]:
        return self.sources.get(cid)

    def _get_element(self, el, query: str):
        """Path query with URL indirection on the final hop
        (collada.cpp:68-87)."""
        e = el
        for token in query.split("/"):
            if e is None:
                return None
            e = e.find(token)
        if e is not None:
            url = e.get("url")
            if url:
                e = self._uri_find(url[1:])
        return e

    def _get_technique_common(self, el):
        profile = el.find("profile_COMMON")
        if profile is not None:
            for technique in profile.findall("technique"):
                if technique.get("sid") == "common":
                    return technique
        return el.find("technique_common")

    def _get_technique_cmu462(self, el):
        extra = el.find("extra")
        if extra is None:
            return None
        for technique in extra.findall("technique"):
            if technique.get("profile") == "CMU462":
                return technique
        return None

    # -- asset / up axis (collada.cpp:146-188) ---------------------------
    def _load_asset(self, root) -> None:
        self.transform = np.eye(4)
        self.up = np.array([0.0, 1.0, 0.0])
        up_el = self._get_element(root, "asset/up_axis")
        if up_el is None:
            return
        up_dir = (up_el.text or "Y_UP").strip()
        if up_dir == "X_UP":
            t = np.eye(4)
            t[0, 0] = 0.0
            t[0, 1] = 1.0
            t[1, 0] = 1.0
            t[1, 1] = 0.0
            t[2, 2] = -1.0
            self.transform = t
            self.up = np.array([1.0, 0.0, 0.0])
        elif up_dir == "Z_UP":
            t = np.eye(4)
            t[1, 1] = 0.0
            t[1, 2] = 1.0
            t[2, 1] = 1.0
            t[2, 2] = 0.0
            t[0, 0] = -1.0
            self.transform = t
            self.up = np.array([0.0, 0.0, 1.0])

    # -- nodes (collada.cpp:217-427) -------------------------------------
    def _parse_node(self, xml) -> None:
        node = Node()
        node.id = xml.get("id", "")
        node.name = xml.get("name", "")
        node.transform = np.eye(4)

        for e in xml:
            tag = e.tag
            if tag == "matrix":
                vals = _floats(e.text)
                if len(vals) < 16:
                    # tolerate short rows (CBgems.dae ships a 15-float
                    # camera matrix); missing trailing entries fall back
                    # to the identity, like a partial stringstream read
                    full = np.eye(4).reshape(-1)
                    full[: len(vals)] = vals
                    vals = full
                node.transform = vals[:16].reshape(4, 4)
                break
            if tag == "rotate":
                vals = _floats(e.text)
                if len(vals) >= 4:
                    axis = vals[:3]
                    n = np.linalg.norm(axis)
                    if n > 0:
                        axis = axis / n
                        node.transform = _axis_angle(axis, math.radians(vals[3])) @ node.transform
            elif tag == "translate":
                vals = _floats(e.text)
                m = np.eye(4)
                m[:3, 3] = vals[:3]
                node.transform = m @ node.transform
            elif tag == "scale":
                vals = _floats(e.text)
                m = np.eye(4)
                m[0, 0], m[1, 1], m[2, 2] = vals[0], vals[1], vals[2]
                node.transform = m @ node.transform

        # push / combine / recurse / pop (collada.cpp:330-345)
        transform_save = self.transform
        node.transform = self.transform @ node.transform
        self.transform = node.transform
        for e_child in xml.findall("node"):
            self._parse_node(e_child)
        self.transform = transform_save

        # instances (collada.cpp:350-424)
        e_camera = self._get_element(xml, "instance_camera")
        e_light = self._get_element(xml, "instance_light")
        e_geometry = self._get_element(xml, "instance_geometry")

        if e_camera is not None:
            node.instance = self._parse_camera(e_camera)
        elif e_light is not None:
            node.instance = self._parse_light(e_light)
        elif e_geometry is not None:
            material = self._parse_bound_material(xml)
            if e_geometry.find("mesh") is not None:
                polymesh = self._parse_polymesh(e_geometry)
                polymesh.material = material
                node.instance = polymesh
            elif e_geometry.find("extra") is not None:
                sphere = self._parse_sphere(e_geometry)
                sphere.material = material
                node.instance = sphere

        self.scene.nodes.append(node)

    def _parse_bound_material(self, xml) -> Optional[MaterialInfo]:
        e_inst = self._get_element(
            xml, "instance_geometry/bind_material/technique_common/instance_material"
        )
        if e_inst is None:
            return None
        target = e_inst.get("target")
        if not target:
            return None
        e_material = self._uri_find(target[1:])
        if e_material is None:
            return None
        return self._parse_material(e_material)

    # -- camera (collada.cpp:429-471) ------------------------------------
    def _parse_camera(self, xml) -> CameraInfo:
        camera = CameraInfo()
        camera.id = xml.get("id", "")
        camera.name = xml.get("name", "")
        camera.up_dir = self.up.copy()
        camera.view_dir = np.array([0.0, 0.0, -1.0])

        persp = self._get_element(xml, "optics/technique_common/perspective")
        if persp is None:
            raise ValueError(f"no perspective defined in camera: {camera.id}")
        e_xfov = persp.find("xfov")
        e_yfov = persp.find("yfov")
        e_znear = persp.find("znear")
        e_zfar = persp.find("zfar")
        camera.hFov = float(e_xfov.text) if e_xfov is not None else 50.0
        camera.vFov = float(e_yfov.text) if e_yfov is not None else 35.0
        camera.nClip = float(e_znear.text) if e_znear is not None else 0.001
        camera.fClip = float(e_zfar.text) if e_zfar is not None else 1000.0
        if e_yfov is None:
            e_ar = persp.find("aspect_ratio")
            if e_ar is None:
                raise ValueError(f"incomplete perspective definition in: {camera.id}")
            ar = float(e_ar.text)
            camera.vFov = 2 * math.degrees(
                math.atan(math.tan(math.radians(0.5 * camera.hFov)) / ar)
            )
        return camera

    # -- light (collada.cpp:473-575) -------------------------------------
    def _parse_light(self, xml) -> LightInfo:
        light = LightInfo()
        light.id = xml.get("id", "")
        light.name = xml.get("name", "")

        technique = self._get_technique_cmu462(xml)
        if technique is None:
            technique = self._get_technique_common(xml)
        if technique is None:
            raise ValueError(f"no supported profile in light: {light.id}")

        e_light = technique[0] if len(technique) else None
        if e_light is None:
            return light
        kind = e_light.tag
        color_el = e_light.find("color")
        if color_el is not None:
            light.spectrum = _spectrum(color_el.text)
        if kind == "ambient":
            light.light_type = LightType.AMBIENT
        elif kind == "directional":
            light.light_type = LightType.DIRECTIONAL
        elif kind == "area":
            light.light_type = LightType.AREA
        elif kind == "point":
            light.light_type = LightType.POINT
            for name, attr in (
                ("constant_attenuation", "constant_att"),
                ("linear_attenuation", "linear_att"),
                ("quadratic_attenuation", "quadratic_att"),
            ):
                e = e_light.find(name)
                if e is not None:
                    setattr(light, attr, float(e.text))
        elif kind == "spot":
            light.light_type = LightType.SPOT
            for name, attr in (
                ("falloff_angle", "falloff_deg"),
                ("falloff_exponent", "falloff_exp"),
                ("constant_attenuation", "constant_att"),
                ("linear_attenuation", "linear_att"),
                ("quadratic_attenuation", "quadratic_att"),
            ):
                e = e_light.find(name)
                if e is not None:
                    setattr(light, attr, float(e.text))
        else:
            raise ValueError(f"light type {kind} not supported in {light.id}")
        return light

    # -- sphere (collada.cpp:577-599) ------------------------------------
    def _parse_sphere(self, xml) -> SphereInfo:
        sphere = SphereInfo()
        sphere.id = xml.get("id", "")
        sphere.name = xml.get("name", "")
        technique = self._get_technique_cmu462(xml)
        if technique is None:
            raise ValueError(f"no CMU462 technique in geometry: {sphere.id}")
        e_radius = self._get_element(technique, "sphere/radius")
        if e_radius is None:
            raise ValueError(f"invalid sphere definition in geometry: {sphere.id}")
        sphere.radius = float(e_radius.text)
        return sphere

    # -- polymesh (collada.cpp:601-866) ----------------------------------
    def _parse_polymesh(self, xml) -> PolymeshInfo:
        polymesh = PolymeshInfo()
        polymesh.id = xml.get("id", "")
        polymesh.name = xml.get("name", "")

        e_mesh = xml.find("mesh")
        if e_mesh is None:
            raise ValueError(f"no mesh data in geometry: {polymesh.id}")

        arr_sources: Dict[str, np.ndarray] = {}
        for e_source in e_mesh.findall("source"):
            sid = e_source.get("id")
            e_floats = e_source.find("float_array")
            if e_floats is not None and e_floats.text:
                arr_sources[sid] = _floats(e_floats.text)

        e_vertices = e_mesh.find("vertices")
        if e_vertices is None:
            raise ValueError(f"no vertices in geometry: {polymesh.id}")
        vertices_id = e_vertices.get("id")
        vertices = np.zeros((0, 3))
        for e_input in e_vertices.findall("input"):
            if e_input.get("semantic") == "POSITION":
                source = e_input.get("source")[1:]
                if source not in arr_sources:
                    raise ValueError(f"undefined input source: {source}")
                vertices = arr_sources[source].reshape(-1, 3)

        e_polylist = e_mesh.find("polylist")
        is_polylist = e_polylist is not None
        if e_polylist is None:
            e_polylist = e_mesh.find("triangles")
        if e_polylist is None:
            raise ValueError("mesh uses neither polylist nor triangles")

        vertex_offset = normal_offset = texcoord_offset = 0
        has_vertex = has_normal = has_texcoord = False
        stride = 0
        for e_input in e_polylist.findall("input"):
            semantic = e_input.get("semantic")
            source = e_input.get("source")[1:]
            offset = int(e_input.get("offset", "0"))
            stride = max(stride, offset + 1)
            if semantic == "VERTEX":
                has_vertex = True
                vertex_offset = offset
                if source != vertices_id:
                    raise ValueError(f"undefined VERTEX source: {source}")
                polymesh.vertices = vertices.copy()
            elif semantic == "NORMAL":
                has_normal = True
                normal_offset = offset
                if source in arr_sources:
                    polymesh.normals = arr_sources[source].reshape(-1, 3)
            elif semantic == "TEXCOORD":
                has_texcoord = True
                texcoord_offset = offset

        count = int(e_polylist.get("count", "0"))
        if is_polylist:
            e_vcount = e_polylist.find("vcount")
            sizes = (
                _floats(e_vcount.text).astype(np.int64)
                if e_vcount is not None and e_vcount.text
                else np.full(count, 3, dtype=np.int64)
            )
        else:
            sizes = np.full(count, 3, dtype=np.int64)

        e_p = e_polylist.find("p")
        indices = (
            _floats(e_p.text).astype(np.int64)
            if e_p is not None and e_p.text
            else np.zeros(0, dtype=np.int64)
        )
        if stride == 0:
            stride = 1
        indices = indices.reshape(-1, stride)

        k = 0
        for size in sizes:
            poly = Polygon()
            chunk = indices[k : k + size]
            if has_vertex:
                poly.vertex_indices = chunk[:, vertex_offset].tolist()
            if has_normal:
                poly.normal_indices = chunk[:, normal_offset].tolist()
            if has_texcoord:
                poly.texcoord_indices = chunk[:, texcoord_offset].tolist()
            polymesh.polygons.append(poly)
            k += size
        return polymesh

    # -- material factory (collada.cpp:868-957) --------------------------
    def _parse_material(self, xml) -> MaterialInfo:
        material = MaterialInfo()
        material.id = xml.get("id", "")
        material.name = xml.get("name", "")

        e_effect = self._get_element(xml, "instance_effect")
        if e_effect is None:
            raise ValueError(f"no target effects for material: {material.id}")

        tech_common = self._get_technique_common(e_effect)
        tech_cmu462 = self._get_technique_cmu462(e_effect)

        if tech_cmu462 is not None:
            for e_bsdf in tech_cmu462:
                kind = e_bsdf.tag
                if kind == "emission":
                    radiance = _spectrum(e_bsdf.find("radiance").text)
                    material.bsdf = EmissionBSDF(radiance)
                elif kind == "mirror":
                    reflectance = _spectrum(e_bsdf.find("reflectance").text)
                    material.bsdf = MirrorBSDF(reflectance)
                elif kind == "refraction":
                    transmittance = _spectrum(e_bsdf.find("transmittance").text)
                    roughness = float(e_bsdf.find("roughness").text)
                    ior = float(e_bsdf.find("ior").text)
                    material.bsdf = RefractionBSDF(transmittance, roughness, ior)
                elif kind == "glass":
                    transmittance = _spectrum(e_bsdf.find("transmittance").text)
                    reflectance = _spectrum(e_bsdf.find("reflectance").text)
                    roughness = float(e_bsdf.find("roughness").text)
                    ior = float(e_bsdf.find("ior").text)
                    material.bsdf = GlassBSDF(transmittance, reflectance, roughness, ior)
        elif tech_common is not None:
            e_diffuse = self._get_element(tech_common, "phong/diffuse/color")
            if e_diffuse is not None:
                material.bsdf = DiffuseBSDF(_spectrum(e_diffuse.text))
            else:
                material.bsdf = DiffuseBSDF(np.array([0.5, 0.5, 0.5]))
        if material.bsdf is None:
            material.bsdf = DiffuseBSDF(np.array([0.5, 0.5, 0.5]))
        return material


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    x, y, z = axis
    rot = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = rot
    return m


def load_scene_info(filename: str) -> SceneInfo:
    """Parse ``filename`` into a fresh :class:`SceneInfo` (raises on error)."""
    info = SceneInfo()
    if ColladaParser.load(filename, info) < 0:
        raise IOError(f"COLLADA parsing failed: {filename}")
    return info
