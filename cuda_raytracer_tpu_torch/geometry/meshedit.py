"""Mesh editing operations on halfedge meshes.

The reference declares this whole surface and stubs nearly all of it
(src/meshEdit.cpp:9-60 local ops, :62-260 Catmull-Clark scaffold,
resampler stubs at :360-460).  This module implements the full set:

- local ops: flip/split/collapse edge, collapse face, erase
  vertex/edge (``HalfedgeMesh`` ops dispatched by the scene editor,
  src/dynamic_scene/scene.h:275-290)
- global ops: linear + Catmull-Clark subdivision (``subdivideQuad``)
- ``MeshResampler``: Loop upsample, edge-collapse downsample,
  isotropic resample

Ops mutate the mesh in place by rewriting the affected polygons and
rebuilding; an edit that would produce a non-manifold mesh is rolled
back and the op returns ``None`` (the reference pops an error dialog).
Editing is host-side interactive-rate work, so this is plain numpy —
the device never sees meshes until they are flattened for rendering.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .halfedge import Edge, Face, HalfedgeMesh, Vertex


# -- soup-rewrite machinery -----------------------------------------------

def _rebuild(mesh: HalfedgeMesh, polys: List[List[int]],
             positions: np.ndarray) -> bool:
    """Rebuild in place; on invalid topology restore and return False."""
    old_positions, old_polys = mesh.to_polygon_soup()
    # drop unreferenced vertices, remapping indices densely
    used = sorted({i for p in polys for i in p})
    remap = {old: new for new, old in enumerate(used)}
    polys = [[remap[i] for i in p] for p in polys]
    positions = positions[used]
    try:
        mesh.build(polys, positions)
        mesh.validate()
        return True
    except (ValueError, AssertionError):
        mesh.build(old_polys, old_positions)
        return False


def _face_cycle(face: Face) -> List[int]:
    return [v.id for v in face.vertices()]


def find_edge(mesh: HalfedgeMesh, i: int, j: int) -> Optional[Edge]:
    for e in mesh.edges:
        a, b = e.endpoints()
        if {a.id, b.id} == {i, j}:
            return e
    return None


# -- local operations ------------------------------------------------------

def flip_edge(mesh: HalfedgeMesh, e: Edge) -> Optional[Edge]:
    """Rotate an interior edge between two triangles
    (HalfedgeMesh::flipEdge, stub src/meshEdit.cpp:51-57)."""
    if e.on_boundary:
        return None
    h = e.halfedge
    f1, f2 = h.face, h.twin.face
    if f1.degree() != 3 or f2.degree() != 3:
        return None
    v0, v1 = h.vertex.id, h.twin.vertex.id
    u1 = h.next.target.id  # apex of f1
    u2 = h.twin.next.target.id  # apex of f2
    if u1 == u2 or find_edge(mesh, u1, u2) is not None:
        return None
    positions, polys = mesh.to_polygon_soup()
    new_polys = []
    for f, p in zip(mesh.faces, polys):
        if f is f1:
            new_polys.append([v0, u2, u1])
        elif f is f2:
            new_polys.append([v1, u1, u2])
        else:
            new_polys.append(p)
    if not _rebuild(mesh, new_polys, positions):
        return None
    return find_edge(mesh, u1, u2)


def split_edge(mesh: HalfedgeMesh, e: Edge) -> Optional[Vertex]:
    """Insert the edge midpoint, splitting each adjacent triangle in
    two (HalfedgeMesh::splitEdge, stub src/meshEdit.cpp:9-15)."""
    h = e.halfedge if not e.halfedge.is_boundary else e.halfedge.twin
    f1 = h.face
    if f1.degree() != 3:
        return None
    f2 = None if h.twin.is_boundary else h.twin.face
    if f2 is not None and f2.degree() != 3:
        return None
    v0, v1 = h.vertex.id, h.twin.vertex.id
    u1 = h.next.target.id
    positions, polys = mesh.to_polygon_soup()
    m = len(positions)
    positions = np.vstack([positions, e.midpoint()[None, :]])
    new_polys = []
    for f, p in zip(mesh.faces, polys):
        if f is f1:
            new_polys.append([v0, m, u1])
            new_polys.append([m, v1, u1])
        elif f2 is not None and f is f2:
            u2 = h.twin.next.target.id
            new_polys.append([v1, m, u2])
            new_polys.append([m, v0, u2])
        else:
            new_polys.append(p)
    if not _rebuild(mesh, new_polys, positions):
        return None
    return mesh.vertices[-1]


def _collapse_to_point(mesh: HalfedgeMesh, victim_ids: set,
                       point: np.ndarray) -> Optional[Vertex]:
    """Merge a set of vertices into one vertex at ``point``."""
    positions, polys = mesh.to_polygon_soup()
    keep = min(victim_ids)
    positions = positions.copy()
    positions[keep] = point

    def remap(i: int) -> int:
        return keep if i in victim_ids else i

    new_polys = []
    for p in polys:
        q: List[int] = []
        for i in p:
            r = remap(i)
            if not q or q[-1] != r:
                q.append(r)
        if len(q) > 1 and q[0] == q[-1]:
            q.pop()
        if len(q) >= 3 and len(set(q)) == len(q):
            new_polys.append(q)
    if not new_polys:
        return None
    if not _rebuild(mesh, new_polys, positions):
        return None
    # the kept index may have been remapped densely; locate by position
    for v in mesh.vertices:
        if np.allclose(v.position, point):
            return v
    return None


def collapse_edge(mesh: HalfedgeMesh, e: Edge) -> Optional[Vertex]:
    """Collapse an edge to its midpoint (HalfedgeMesh::collapseEdge,
    stub src/meshEdit.cpp:17-23)."""
    a, b = e.endpoints()
    return _collapse_to_point(mesh, {a.id, b.id}, e.midpoint())


def collapse_face(mesh: HalfedgeMesh, f: Face) -> Optional[Vertex]:
    """Collapse a face to its centroid (HalfedgeMesh::collapseFace,
    stub src/meshEdit.cpp:25-31)."""
    if f.is_boundary:
        return None
    ids = {v.id for v in f.vertices()}
    return _collapse_to_point(mesh, ids, f.centroid())


def erase_edge(mesh: HalfedgeMesh, e: Edge) -> Optional[Face]:
    """Merge the two faces adjacent to an interior edge
    (HalfedgeMesh::eraseEdge, stub src/meshEdit.cpp:41-49)."""
    if e.on_boundary:
        return None
    h = e.halfedge
    f1, f2 = h.face, h.twin.face
    if f1 is f2:
        return None
    verts1 = [hh.vertex.id for hh in f1.halfedges()]
    # rotate so the cycle starts with h (v0, v1, ...)
    idx = [hh for hh in f1.halfedges()].index(h)
    verts1 = verts1[idx:] + verts1[:idx]
    verts2 = [hh.vertex.id for hh in f2.halfedges()]
    idx2 = [hh for hh in f2.halfedges()].index(h.twin)
    verts2 = verts2[idx2:] + verts2[:idx2]
    # verts1 = [v0, v1, x...]; verts2 = [v1, v0, y...]
    merged = verts1[1:] + verts2[1:]  # [v1, x..., v0, y...]
    if len(set(merged)) != len(merged):
        return None  # faces share more than this edge
    positions, polys = mesh.to_polygon_soup()
    new_polys = [merged]
    for f, p in zip(mesh.faces, polys):
        if f is not f1 and f is not f2:
            new_polys.append(p)
    if not _rebuild(mesh, new_polys, positions):
        return None
    return mesh.faces[0]


def erase_vertex(mesh: HalfedgeMesh, v: Vertex) -> Optional[Face]:
    """Remove a vertex, merging its incident faces into one polygon
    (HalfedgeMesh::eraseVertex, stub src/meshEdit.cpp:33-39)."""
    if v.on_boundary:
        return None
    merged: List[int] = []
    h = v.halfedge
    while True:
        # contribution of h.face: its cycle minus v, starting at h.target
        cyc = [hh.vertex.id for hh in h.face.halfedges()]
        i = cyc.index(v.id)
        cyc = cyc[i + 1:] + cyc[:i]  # drop v, start at h.target
        merged.extend(cyc[:-1])  # last element repeats as next start
        h = h.prev().twin  # next face clockwise around v
        if h is v.halfedge:
            break
    if len(set(merged)) != len(merged) or len(merged) < 3:
        return None
    positions, polys = mesh.to_polygon_soup()
    gone = {f.id for f in (hh.face for hh in v.outgoing())}
    new_polys = [merged] + [p for f, p in zip(mesh.faces, polys)
                            if f.id not in gone]
    if not _rebuild(mesh, new_polys, positions):
        return None
    return mesh.faces[0]


# -- subdivision (subdivideQuad scaffold, src/meshEdit.cpp:62-260) ---------

def subdivide(mesh: HalfedgeMesh, catmull_clark: bool = False) -> None:
    """Quad subdivision: one new vertex per face/edge/vertex, one quad
    per face corner.  ``catmull_clark`` selects smooth rules; otherwise
    linear (positions interpolated).

    Mirrors HalfedgeMesh::subdivideQuad's pipeline — compute positions,
    assign indices, build the subdivided quad list, rebuild
    (src/meshEdit.cpp:62-110) — as one soup pass.
    """
    mesh._renumber()
    V, E, F = mesh.n_vertices, mesh.n_edges, mesh.n_faces

    face_pts = np.array([f.centroid() for f in mesh.faces])
    edge_pts = np.zeros((E, 3))
    vert_pts = np.zeros((V, 3))

    if not catmull_clark:
        for e in mesh.edges:
            edge_pts[e.id] = e.midpoint()
        for v in mesh.vertices:
            vert_pts[v.id] = v.position
    else:
        # Catmull-Clark rules (computeCatmullClarkPositions scaffold,
        # src/meshEdit.cpp:140-170)
        for e in mesh.edges:
            if e.on_boundary:
                edge_pts[e.id] = e.midpoint()
            else:
                f1 = e.halfedge.face.id
                f2 = e.halfedge.twin.face.id
                a, b = e.endpoints()
                edge_pts[e.id] = (
                    a.position + b.position + face_pts[f1] + face_pts[f2]
                ) / 4.0
        for v in mesh.vertices:
            if v.on_boundary:
                nbrs = [h.target.position for h in v.outgoing()
                        if h.edge.on_boundary]
                vert_pts[v.id] = 0.75 * v.position + 0.125 * np.sum(
                    nbrs, axis=0
                )
            else:
                hs = list(v.outgoing())
                n = len(hs)
                q = np.mean([face_pts[h.face.id] for h in hs], axis=0)
                r = np.mean([h.edge.midpoint() for h in hs], axis=0)
                vert_pts[v.id] = (q + 2.0 * r + (n - 3.0) * v.position) / n

    positions = np.vstack([vert_pts, edge_pts, face_pts])
    quads: List[List[int]] = []
    for f in mesh.faces:
        hs = list(f.halfedges())
        for i, h in enumerate(hs):
            prev_e = hs[i - 1].edge.id
            quads.append(
                [h.vertex.id, V + h.edge.id, V + E + f.id, V + prev_e]
            )
    mesh.build(quads, positions)


# -- resampling (MeshResampler, stubs src/meshEdit.cpp:360-460) ------------

class MeshResampler:
    """upsample/downsample/resample, dispatched by the scene editor."""

    @staticmethod
    def upsample(mesh: HalfedgeMesh) -> None:
        """Loop subdivision on a triangle mesh (MeshResampler::upsample
        stub).  Non-triangular faces are fan-triangulated first."""
        if any(f.degree() != 3 for f in mesh.faces):
            mesh.triangulate()
        mesh._renumber()
        V, E = mesh.n_vertices, mesh.n_edges

        vert_pts = np.zeros((V, 3))
        for v in mesh.vertices:
            if v.on_boundary:
                nbrs = [h.target.position for h in v.outgoing()
                        if h.edge.on_boundary]
                vert_pts[v.id] = 0.75 * v.position + 0.125 * np.sum(
                    nbrs, axis=0
                )
            else:
                nbrs = [h.target.position for h in v.outgoing()]
                n = len(nbrs)
                beta = 3.0 / 16.0 if n == 3 else 3.0 / (8.0 * n)
                vert_pts[v.id] = (1.0 - n * beta) * v.position \
                    + beta * np.sum(nbrs, axis=0)

        edge_pts = np.zeros((E, 3))
        for e in mesh.edges:
            a, b = e.endpoints()
            if e.on_boundary:
                edge_pts[e.id] = e.midpoint()
            else:
                c = e.halfedge.next.target.position
                d = e.halfedge.twin.next.target.position
                edge_pts[e.id] = 0.375 * (a.position + b.position) \
                    + 0.125 * (c + d)

        positions = np.vstack([vert_pts, edge_pts])
        tris: List[List[int]] = []
        for f in mesh.faces:
            hs = list(f.halfedges())
            v = [h.vertex.id for h in hs]
            e = [V + h.edge.id for h in hs]
            tris.append([v[0], e[0], e[2]])
            tris.append([v[1], e[1], e[0]])
            tris.append([v[2], e[2], e[1]])
            tris.append([e[0], e[1], e[2]])
        mesh.build(tris, positions)

    @staticmethod
    def downsample(mesh: HalfedgeMesh,
                   target_faces: Optional[int] = None) -> None:
        """Simplify by repeated shortest-edge collapse until the face
        count reaches ``target_faces`` (default: a quarter, matching the
        reference downsample goal).  Collapses that would break
        manifoldness are skipped."""
        if target_faces is None:
            target_faces = max(4, mesh.n_faces // 4)
        stuck = 0
        while mesh.n_faces > target_faces and stuck < 3:
            edges = sorted(mesh.edges, key=lambda e: e.length())
            before = mesh.n_faces
            for e in edges:
                if collapse_edge(mesh, e) is not None:
                    break
            stuck = stuck + 1 if mesh.n_faces == before else 0

    @staticmethod
    def resample(mesh: HalfedgeMesh, iterations: int = 3) -> None:
        """Isotropic remeshing (MeshResampler::resample stub): split
        long edges, collapse short ones, flip for valence, smooth."""
        if any(f.degree() != 3 for f in mesh.faces):
            mesh.triangulate()
        mean_len = np.mean([e.length() for e in mesh.edges])

        def first_and_apply(pick, op) -> bool:
            # every successful op rebuilds the mesh (stale handles), so
            # rescan fresh edges and apply at most one op per call
            for e in mesh.edges:
                if pick(e) and op(mesh, e) is not None:
                    return True
            return False

        for _ in range(iterations):
            while first_and_apply(
                lambda e: e.length() > 4.0 * mean_len / 3.0, split_edge
            ):
                pass
            def wants_collapse(e: Edge) -> bool:
                # short edge, and merging won't create an over-long edge
                # (the standard anti-cascade rule) or shrink the mesh
                # below a closed-surface floor
                if e.length() >= 0.8 * mean_len or mesh.n_faces <= 8:
                    return False
                a, b = e.endpoints()
                mid = e.midpoint()
                for v in (a, b):
                    for w in v.neighbors():
                        if w is a or w is b:
                            continue
                        if np.linalg.norm(mid - w.position) \
                                > 4.0 * mean_len / 3.0:
                            return False
                return True

            while first_and_apply(wants_collapse, collapse_edge):
                pass

            def wants_flip(e: Edge) -> bool:
                if e.on_boundary:
                    return False
                h = e.halfedge
                a, b = e.endpoints()
                c, d = h.next.target, h.twin.next.target

                def dev(v):
                    return v.degree() - (4 if v.on_boundary else 6)

                before = abs(dev(a)) + abs(dev(b)) + abs(dev(c)) + abs(dev(d))
                after = (abs(dev(a) - 1) + abs(dev(b) - 1)
                         + abs(dev(c) + 1) + abs(dev(d) + 1))
                return after < before

            for _ in range(mesh.n_edges):  # bounded flip passes
                if not first_and_apply(wants_flip, flip_edge):
                    break
            # tangential Laplacian smoothing (interior only)
            new_pos = {}
            for v in mesh.vertices:
                if v.on_boundary:
                    continue
                c = np.mean([n.position for n in v.neighbors()], axis=0)
                d = c - v.position
                nrm = v.normal()
                d -= nrm * np.dot(d, nrm)
                new_pos[v.id] = v.position + 0.5 * d
            for v in mesh.vertices:
                if v.id in new_pos:
                    v.position = new_pos[v.id]
