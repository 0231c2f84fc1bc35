"""Editor session save/load: ten numbered scene buffers.

The reference editor binds keys w/l plus digits 0-9 to save/load the
whole scene (COLLADA via ColladaWriter::writeScene) and the selected
skeleton to per-slot files (src/application.h:281-296,
Application::writeScene/loadScene).  This is the headless equivalent:

    mgr = SessionManager("/path/to/dir")
    mgr.save(3, dscene)          # key 'w' then '3'
    dscene2, ci, cx, cc = mgr.load(3)   # key 'l' then '3'

Saved state: every object's CURRENT geometry (mesh edits included —
meshes are re-exported from their live halfedge state), lights and
spheres as their original COLLADA nodes, plus per-mesh skeletons
(joint tree + keyframes) in a sidecar .npz like the reference's
side-by-side skeleton files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import dynamic_scene as ds
from .collada_info import (
    InstanceType,
    MaterialInfo,
    Node,
    Polygon,
    PolymeshInfo,
    SceneInfo,
    SphereInfo,
)
from .collada import load_scene_info
from .collada_writer import write_scene


def scene_to_info(scene: "ds.Scene") -> SceneInfo:
    """Re-export a dynamic scene as a SceneInfo: meshes from their
    current (possibly edited) world-space geometry, lights and spheres
    from the COLLADA nodes they were loaded from."""
    nodes = []
    for i, obj in enumerate(scene.objects):
        if isinstance(obj, ds.Mesh):
            obj._sync_from_halfedge()
            pm = obj.mesh
            info = PolymeshInfo(
                id=f"mesh{i}",
                name=f"mesh{i}",
                vertices=np.asarray(pm.vertices, np.float64),
                normals=pm.vertex_normals(),
                polygons=[
                    Polygon(vertex_indices=list(p)) for p in pm.polygons
                ],
                material=MaterialInfo(bsdf=obj.bsdf),
            )
            nodes.append(Node(instance=info, transform=np.eye(4)))
        elif isinstance(obj, ds.Sphere) and getattr(
            obj, "source_node", None
        ):
            nodes.append(obj.source_node)
        elif isinstance(obj, ds.Sphere):
            nodes.append(
                Node(
                    instance=SphereInfo(radius=float(obj.r)),
                    transform=np.eye(4),
                )
            )
    for light in scene.lights:
        node = getattr(light, "source_node", None)
        if node is not None:
            nodes.append(node)
    cam_node = getattr(scene, "camera_node", None)
    if cam_node is not None:
        nodes.append(cam_node)
    return SceneInfo(nodes=nodes)


class SessionManager:
    """Ten numbered save buffers (application.h:281-296)."""

    NUM_SLOTS = 10

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _paths(self, slot: int):
        if not 0 <= slot < self.NUM_SLOTS:
            raise ValueError(f"slot must be 0-{self.NUM_SLOTS - 1}")
        base = os.path.join(self.directory, f"Scene_{slot}")
        return base + ".dae", base + "_skel.npz"

    def save(self, slot: int, scene: "ds.Scene") -> str:
        """Key 'w' + digit: write the scene buffer (and skeletons)."""
        dae, skel = self._paths(slot)
        write_scene(dae, scene_to_info(scene))
        rigs = {}
        # key skeletons by the object's index in the EXPORTED scene
        # (scene_to_info drops anything that is not a Mesh/Sphere, so
        # the raw list index would misalign after a round trip)
        exported = 0
        for obj in scene.objects:
            if not isinstance(obj, (ds.Mesh, ds.Sphere)):
                continue
            sk = getattr(obj, "skeleton", None)
            if sk is not None:
                rigs.update(
                    {f"m{exported}_{k}": v
                     for k, v in sk.to_arrays().items()}
                )
            exported += 1
        if rigs:
            np.savez(skel, **rigs)
        elif os.path.exists(skel):
            os.remove(skel)
        return dae

    def load(self, slot: int):
        """Key 'l' + digit: load the scene buffer.  Returns the
        load_from_scene_info tuple (scene, camera_info,
        camera_transform, cutracer_camera)."""
        dae, skel = self._paths(slot)
        if not os.path.exists(dae):
            raise FileNotFoundError(f"no session in slot {slot}")
        result = ds.load_from_scene_info(load_scene_info(dae))
        scene = result[0]
        if os.path.exists(skel):
            from .skeleton import Skeleton

            data = np.load(skel, allow_pickle=True)
            by_mesh = {}
            for k in data.files:
                mid, field = k.split("_", 1)
                by_mesh.setdefault(int(mid[1:]), {})[field] = data[k]
            for i, arrays in by_mesh.items():
                if i < len(scene.objects):
                    scene.objects[i].skeleton = Skeleton.from_arrays(
                        arrays
                    )
        return result

    def occupied(self):
        """Which slots hold a saved session."""
        return [
            s
            for s in range(self.NUM_SLOTS)
            if os.path.exists(self._paths(s)[0])
        ]
