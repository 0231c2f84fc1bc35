"""Polygon-mesh container with triangulation and vertex normals.

Array-based equivalent of the halfedge-mesh → static-mesh conversion the
renderer needs (reference: HalfedgeMesh::build / triangulate
src/halfEdgeMesh.cpp:47-504 feeding StaticScene::Mesh
src/static_scene/object.cpp:17-59).  The full editable halfedge
structure with local ops lives in scene/halfedge.py; this module is the
fast numpy path used for rendering.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class PolygonMesh:
    """Vertices + polygon index lists (a polygon soup that kept its
    connectivity through vertex sharing)."""

    vertices: np.ndarray  # [V, 3] float64
    polygons: List[List[int]]

    def transformed(self, transform: np.ndarray) -> "PolygonMesh":
        """Apply a 4x4 homogeneous transform to the vertices (semantics of
        DynamicScene::Mesh's constructor, src/dynamic_scene/mesh.cpp:27-30)."""
        hom = np.concatenate(
            [self.vertices, np.ones((len(self.vertices), 1))], axis=1
        )
        out = hom @ transform.T
        w = out[:, 3:4]
        return PolygonMesh(out[:, :3] / w, [list(p) for p in self.polygons])

    def triangulate(self) -> np.ndarray:
        """Fan-triangulate every polygon; returns [T, 3] int32 indices
        (HalfedgeMesh::triangulate via splitPolygon produces the same fan
        for convex faces, src/meshEdit.cpp:356-358)."""
        tris: List[Sequence[int]] = []
        for poly in self.polygons:
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
        if not tris:
            return np.zeros((0, 3), dtype=np.int32)
        return np.asarray(tris, dtype=np.int32)

    def vertex_normals(self, triangles: np.ndarray = None) -> np.ndarray:
        """Area-weighted vertex normals: each incident triangle adds its
        (unnormalized) 2*area*facet-normal cross product, then the sum is
        normalized — the semantics of Vertex::normal()
        (src/halfEdgeMesh.h:619-650) on a triangulated mesh."""
        if triangles is None:
            triangles = self.triangulate()
        v = self.vertices
        normals = np.zeros_like(v)
        if len(triangles):
            a, b, c = v[triangles[:, 0]], v[triangles[:, 1]], v[triangles[:, 2]]
            fn = np.cross(b - a, c - a)  # 2*area*unit_normal
            for col in range(3):
                np.add.at(normals, triangles[:, col], fn)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        lens[lens == 0] = 1.0
        return normals / lens

    def bbox(self):
        if len(self.vertices) == 0:
            return np.zeros(3), np.zeros(3)
        return self.vertices.min(axis=0), self.vertices.max(axis=0)
