"""COLLADA (.dae) scene writer.

Equivalent of the reference's ColladaWriter::writeScene
(src/collada/collada.h:80-90, collada.cpp) used by the editor's
save-buffer feature (src/application.h:281-296).  Emits a minimal valid
COLLADA 1.4 document containing the scene's cameras, lights and meshes
that round-trips through :mod:`.collada`.
"""

from __future__ import annotations

from xml.etree import ElementTree as ET

import numpy as np

from .collada_info import InstanceType, LightType, SceneInfo


def _sub(parent, tag, text=None, **attrib):
    el = ET.SubElement(parent, tag, attrib)
    if text is not None:
        el.text = text
    return el


def _fmt(vals) -> str:
    return " ".join(repr(float(v)) for v in np.asarray(vals).reshape(-1))


def write_scene(filename: str, scene_info: SceneInfo) -> int:
    root = ET.Element(
        "COLLADA",
        {"xmlns": "http://www.collada.org/2005/11/COLLADASchema", "version": "1.4.1"},
    )
    asset = _sub(root, "asset")
    _sub(asset, "up_axis", "Y_UP")

    lib_cameras = _sub(root, "library_cameras")
    lib_lights = _sub(root, "library_lights")
    lib_geoms = _sub(root, "library_geometries")
    lib_scenes = _sub(root, "library_visual_scenes")
    vscene = _sub(lib_scenes, "visual_scene", id="Scene", name="Scene")

    for i, node in enumerate(scene_info.nodes):
        inst = node.instance
        if inst is None:
            continue
        nid = inst.id or f"node{i}"
        e_node = _sub(vscene, "node", id=f"{nid}-node", name=node.name or nid)
        _sub(e_node, "matrix", _fmt(node.transform), sid="transform")

        if inst.type == InstanceType.CAMERA:
            cam = _sub(lib_cameras, "camera", id=nid, name=inst.name or nid)
            persp = _sub(
                _sub(_sub(cam, "optics"), "technique_common"), "perspective"
            )
            _sub(persp, "xfov", repr(float(inst.hFov)), sid="xfov")
            _sub(persp, "yfov", repr(float(inst.vFov)), sid="yfov")
            _sub(persp, "znear", repr(float(inst.nClip)), sid="znear")
            _sub(persp, "zfar", repr(float(inst.fClip)), sid="zfar")
            _sub(e_node, "instance_camera", url=f"#{nid}")
        elif inst.type == InstanceType.LIGHT:
            light = _sub(lib_lights, "light", id=nid, name=inst.name or nid)
            extra = _sub(_sub(light, "extra"), "technique", profile="CMU462")
            kind = {
                LightType.AMBIENT: "ambient",
                LightType.DIRECTIONAL: "directional",
                LightType.AREA: "area",
                LightType.POINT: "point",
                LightType.SPOT: "spot",
            }.get(inst.light_type, "ambient")
            e_kind = _sub(extra, kind)
            _sub(e_kind, "color", _fmt(inst.spectrum), sid="color")
            _sub(e_node, "instance_light", url=f"#{nid}")
        elif inst.type == InstanceType.POLYMESH:
            geom = _sub(lib_geoms, "geometry", id=nid, name=inst.name or nid)
            mesh = _sub(geom, "mesh")
            src_id = f"{nid}-positions"
            src = _sub(mesh, "source", id=src_id)
            verts = np.asarray(inst.vertices, dtype=np.float64)
            _sub(
                src,
                "float_array",
                _fmt(verts),
                id=f"{src_id}-array",
                count=str(verts.size),
            )
            tc = _sub(_sub(src, "technique_common"), "accessor",
                      source=f"#{src_id}-array", count=str(len(verts)), stride="3")
            for axis in "XYZ":
                _sub(tc, "param", name=axis, type="float")
            v_id = f"{nid}-vertices"
            e_verts = _sub(mesh, "vertices", id=v_id)
            _sub(e_verts, "input", semantic="POSITION", source=f"#{src_id}")
            polys = inst.polygons
            e_poly = _sub(mesh, "polylist", count=str(len(polys)))
            _sub(e_poly, "input", semantic="VERTEX", source=f"#{v_id}", offset="0")
            _sub(e_poly, "vcount", " ".join(str(len(p.vertex_indices)) for p in polys))
            _sub(
                e_poly,
                "p",
                " ".join(str(i) for p in polys for i in p.vertex_indices),
            )
            _sub(e_node, "instance_geometry", url=f"#{nid}")
        elif inst.type == InstanceType.SPHERE:
            geom = _sub(lib_geoms, "geometry", id=nid, name=inst.name or nid)
            tech = _sub(_sub(geom, "extra"), "technique", profile="CMU462")
            _sub(_sub(tech, "sphere"), "radius", repr(float(inst.radius)))
            _sub(e_node, "instance_geometry", url=f"#{nid}")

    scene_el = _sub(root, "scene")
    _sub(scene_el, "instance_visual_scene", url="#Scene")

    ET.ElementTree(root).write(filename, xml_declaration=True, encoding="utf-8")
    return 0
