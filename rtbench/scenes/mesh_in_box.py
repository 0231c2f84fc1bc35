"""A mesh set inside a scene of quads and spheres, as the reference's
CBdragon sets its scanned dragon inside the Cornell box.

``build(cfg)`` reads what ``scenes/quads_spheres.py`` reads, and
``mesh``: the input of the scene builder it names (``builder``), the
name of its material among ``materials`` (``material``), and where it
stands: ``scale``, then ``tilt_deg`` (a turn about the x axis, which
takes +y toward +z), then ``offset``.
"""

from __future__ import annotations

import numpy as np

from rtb import catalog


def build(cfg: dict) -> dict:
    scene = catalog.scene_builder("quads_spheres")(cfg)
    spec = cfg["mesh"]
    inner = dict(spec, material=cfg["materials"][spec["material"]],
                 lights=[])
    part = catalog.scene_builder(spec["builder"])(inner)
    a = np.radians(float(spec.get("tilt_deg", 0.0)))
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    offset = np.asarray(spec.get("offset", [0.0, 0.0, 0.0]), np.float64)
    index = list(cfg["materials"]).index(spec["material"])
    for m in part["meshes"]:
        scene["meshes"].append(dict(
            m, positions=(m["positions"] * float(spec["scale"])) @ rot.T
            + offset, normals=m["normals"] @ rot.T, material=index))
    return scene
