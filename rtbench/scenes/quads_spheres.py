"""Scenes of quads and spheres, every number from the configuration.

``build(cfg)`` reads ``materials`` (name -> kind and its colours),
``quads`` (four corners and a material each: two triangles, vertex
normals from the face), ``spheres`` (centre, radius, material) and
``lights`` (area lights) and returns the scene as plain arrays.
"""

from __future__ import annotations

import numpy as np


def build(cfg: dict) -> dict:
    names = list(cfg["materials"])
    index = {name: i for i, name in enumerate(names)}
    meshes = []
    for q in cfg["quads"]:
        a, b, c, d = np.asarray(q["corners"], np.float64)
        n = np.cross(b - a, c - a)
        n = n / np.linalg.norm(n)
        meshes.append({
            "positions": np.stack([a, b, c, d]),
            "normals": np.tile(n, (4, 1)),
            "indices": np.array([[0, 1, 2], [0, 2, 3]], np.int64),
            "material": index[q["material"]],
        })
    spheres = [{"center": np.asarray(s["center"], np.float64),
                "radius": float(s["radius"]),
                "material": index[s["material"]]}
               for s in cfg.get("spheres", [])]
    return {"meshes": meshes, "spheres": spheres,
            "materials": [dict(cfg["materials"][n], name=n) for n in names],
            "lights": list(cfg["lights"])}
