"""Procedural Cornell-box scenes (no .dae needed).

Mirrors the layout of the shipped CBspheres scenes (red left wall, blue
right wall, area light in the ceiling, optional spheres) so tests and
benchmarks run without the reference media tree.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..scene import static_scene as st
from ..scene.bsdf import DiffuseBSDF, EmissionBSDF, GlassBSDF, MirrorBSDF


def _quad_mesh(corners: np.ndarray, bsdf) -> st.Mesh:
    """Two-triangle quad; vertex normals from the face."""
    a, b, c, d = corners
    n = np.cross(b - a, c - a)
    n = n / np.linalg.norm(n)
    positions = np.stack([a, b, c, d])
    normals = np.tile(n, (4, 1))
    indices = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return st.Mesh(positions, normals, indices, bsdf)


def cornell_box_scene(
    with_spheres: bool = True,
    sphere_bsdfs: str = "diffuse",
    light_radiance: float = 10.0,
) -> st.Scene:
    """A unit Cornell box: x in [-1, 1], y in [0, 1.5], z in [-1, 1],
    open toward +z like the shipped CBspheres scenes."""
    white = DiffuseBSDF([0.8, 0.8, 0.8])
    red = DiffuseBSDF([0.8, 0.1, 0.1])
    blue = DiffuseBSDF([0.1, 0.1, 0.8])
    emit = EmissionBSDF([light_radiance] * 3)

    v = lambda x, y, z: np.array([x, y, z], dtype=np.float64)  # noqa: E731
    objects: List[st.SceneObject] = [
        # floor (y=0, normal +y)
        _quad_mesh(np.stack([v(-1, 0, -1), v(1, 0, -1), v(1, 0, 1), v(-1, 0, 1)]), white),
        # ceiling (y=1.5, normal -y)
        _quad_mesh(np.stack([v(-1, 1.5, -1), v(-1, 1.5, 1), v(1, 1.5, 1), v(1, 1.5, -1)]), white),
        # back wall (z=-1, normal +z)
        _quad_mesh(np.stack([v(-1, 0, -1), v(-1, 1.5, -1), v(1, 1.5, -1), v(1, 0, -1)]), white),
        # left wall (x=-1, normal +x)
        _quad_mesh(np.stack([v(-1, 0, -1), v(-1, 0, 1), v(-1, 1.5, 1), v(-1, 1.5, -1)]), red),
        # right wall (x=1, normal -x)
        _quad_mesh(np.stack([v(1, 0, -1), v(1, 1.5, -1), v(1, 1.5, 1), v(1, 0, 1)]), blue),
        # light quad just below the ceiling
        _quad_mesh(
            np.stack(
                [v(-0.3, 1.49, -0.25), v(0.3, 1.49, -0.25), v(0.3, 1.49, 0.25), v(-0.3, 1.49, 0.25)]
            ),
            emit,
        ),
    ]
    if with_spheres:
        if sphere_bsdfs == "diffuse":
            b1 = b2 = DiffuseBSDF([0.8, 0.8, 0.8])
        elif sphere_bsdfs == "mirror":
            b1 = b2 = MirrorBSDF([0.9, 0.9, 0.9])
        else:  # classic: one mirror, one glass
            b1 = MirrorBSDF([0.9, 0.9, 0.9])
            b2 = GlassBSDF([0.9, 0.9, 0.9], [0.9, 0.9, 0.9], 0.0, 1.5)
        objects.append(st.SphereObject(v(-0.45, 0.3, -0.1), 0.3, b1))
        objects.append(st.SphereObject(v(0.45, 0.3, 0.2), 0.3, b2))

    lights = [
        st.AreaLight(
            rad=[light_radiance] * 3,
            pos=v(0, 1.49, 0),
            direction=v(0, -1, 0),
            dim_x=v(0.6, 0, 0),
            dim_y=v(0, 0, 0.5),
        )
    ]
    return st.Scene(objects, lights)
