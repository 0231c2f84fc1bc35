"""Halfedge mesh data structure.

The editable-mesh core with the same model as the reference's
``HalfedgeMesh`` (src/halfEdgeMesh.h:170-1050): halfedges carry
twin/next/vertex/edge/face pointers, boundary loops are represented as
virtual faces with ``is_boundary`` set, and the mesh is (re)built from
a polygon soup (src/halfEdgeMesh.cpp:47-501).

Convention: ``h.vertex`` is the halfedge's *source* vertex, so ``h``
runs from ``h.vertex`` to ``h.twin.vertex`` — matching the reference's
``h->vertex()`` (src/halfEdgeMesh.h:330-340).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


class Halfedge:
    __slots__ = ("twin", "next", "vertex", "edge", "face", "id")

    def __init__(self):
        self.twin: "Halfedge" = None
        self.next: "Halfedge" = None
        self.vertex: "Vertex" = None
        self.edge: "Edge" = None
        self.face: "Face" = None
        self.id = -1

    @property
    def target(self) -> "Vertex":
        return self.twin.vertex

    @property
    def is_boundary(self) -> bool:
        return self.face.is_boundary

    def prev(self) -> "Halfedge":
        """Walk the face loop to the halfedge whose next is self."""
        h = self
        while h.next is not self:
            h = h.next
        return h

    def __repr__(self):
        return f"Halfedge({self.vertex.id}->{self.target.id})"


class Vertex:
    __slots__ = ("halfedge", "position", "id")

    def __init__(self, position):
        self.halfedge: Halfedge = None
        self.position = np.asarray(position, dtype=np.float64)
        self.id = -1

    def degree(self) -> int:
        """Number of incident (non-boundary-loop) edges — matches
        Vertex::degree counting real faces (src/halfEdgeMesh.h:560-575)."""
        return sum(1 for _ in self.outgoing())

    def outgoing(self) -> Iterator[Halfedge]:
        """All outgoing halfedges (including into boundary loops)."""
        h = self.halfedge
        while True:
            yield h
            h = h.twin.next
            if h is self.halfedge:
                return

    def neighbors(self) -> Iterator["Vertex"]:
        for h in self.outgoing():
            yield h.target

    @property
    def on_boundary(self) -> bool:
        return any(h.is_boundary for h in self.outgoing())

    def normal(self) -> np.ndarray:
        """Area-weighted pseudo-normal over incident faces."""
        n = np.zeros(3)
        for h in self.outgoing():
            if h.is_boundary:
                continue
            a = h.target.position - self.position
            b = h.prev().vertex.position - self.position
            n += np.cross(a, b)
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else np.array([0.0, 0.0, 1.0])

    def __repr__(self):
        return f"Vertex({self.id})"


class Edge:
    __slots__ = ("halfedge", "id")

    def __init__(self):
        self.halfedge: Halfedge = None
        self.id = -1

    @property
    def on_boundary(self) -> bool:
        return self.halfedge.is_boundary or self.halfedge.twin.is_boundary

    def endpoints(self) -> Tuple[Vertex, Vertex]:
        return self.halfedge.vertex, self.halfedge.twin.vertex

    def length(self) -> float:
        a, b = self.endpoints()
        return float(np.linalg.norm(a.position - b.position))

    def midpoint(self) -> np.ndarray:
        a, b = self.endpoints()
        return (a.position + b.position) / 2.0

    def __repr__(self):
        a, b = self.endpoints()
        return f"Edge({a.id},{b.id})"


class Face:
    __slots__ = ("halfedge", "is_boundary", "id")

    def __init__(self, is_boundary: bool = False):
        self.halfedge: Halfedge = None
        self.is_boundary = is_boundary
        self.id = -1

    def halfedges(self) -> Iterator[Halfedge]:
        h = self.halfedge
        while True:
            yield h
            h = h.next
            if h is self.halfedge:
                return

    def vertices(self) -> List[Vertex]:
        return [h.vertex for h in self.halfedges()]

    def degree(self) -> int:
        return sum(1 for _ in self.halfedges())

    def centroid(self) -> np.ndarray:
        vs = self.vertices()
        return np.mean([v.position for v in vs], axis=0)

    def normal(self) -> np.ndarray:
        """Newell's-method polygon normal."""
        n = np.zeros(3)
        vs = [v.position for v in self.vertices()]
        for i, p in enumerate(vs):
            q = vs[(i + 1) % len(vs)]
            n[0] += (p[1] - q[1]) * (p[2] + q[2])
            n[1] += (p[2] - q[2]) * (p[0] + q[0])
            n[2] += (p[0] - q[0]) * (p[1] + q[1])
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else np.array([0.0, 0.0, 1.0])

    def __repr__(self):
        kind = "Boundary" if self.is_boundary else "Face"
        return f"{kind}({[v.id for v in self.vertices()]})"


class HalfedgeMesh:
    """Halfedge mesh built from a polygon soup.

    Boundary edges get twin halfedges living in virtual boundary-loop
    faces (``face.is_boundary``), exactly like the reference build
    (src/halfEdgeMesh.cpp:47-501): every halfedge always has a valid
    twin/next/face, and iteration over ``faces`` excludes boundary
    loops (they live in ``boundaries``).
    """

    def __init__(self, polygons: Sequence[Sequence[int]] = (),
                 positions: Sequence = ()):
        self.vertices: List[Vertex] = []
        self.edges: List[Edge] = []
        self.faces: List[Face] = []
        self.boundaries: List[Face] = []
        self.halfedges: List[Halfedge] = []
        if len(polygons):
            self.build(polygons, positions)

    # -- construction ------------------------------------------------------
    def build(self, polygons: Sequence[Sequence[int]],
              positions: Sequence) -> None:
        """(Re)build from an indexed polygon soup.  Raises ValueError on
        non-manifold input (edge shared by >2 faces or inconsistent
        winding), mirroring the reference's build checks."""
        positions = np.asarray(positions, dtype=np.float64)
        self.vertices = [Vertex(p) for p in positions]
        for i, v in enumerate(self.vertices):
            v.id = i
        self.edges, self.faces, self.boundaries, self.halfedges = [], [], [], []

        pair_to_he: Dict[Tuple[int, int], Halfedge] = {}
        for poly in polygons:
            if len(poly) < 3:
                raise ValueError(f"polygon with degree {len(poly)} < 3")
            if len(set(poly)) != len(poly):
                raise ValueError(f"degenerate polygon {poly}")
            face = Face()
            self.faces.append(face)
            hes = []
            for i, vi in enumerate(poly):
                vj = poly[(i + 1) % len(poly)]
                if (vi, vj) in pair_to_he:
                    raise ValueError(
                        f"non-manifold or inconsistently wound edge ({vi},{vj})"
                    )
                h = Halfedge()
                h.vertex = self.vertices[vi]
                h.face = face
                pair_to_he[(vi, vj)] = h
                hes.append(h)
                self.halfedges.append(h)
            for i, h in enumerate(hes):
                h.next = hes[(i + 1) % len(hes)]
            face.halfedge = hes[0]

        # twin linking + edge records; collect unpaired (boundary) sides
        boundary_out: Dict[int, Halfedge] = {}
        for (vi, vj), h in pair_to_he.items():
            if h.twin is not None:
                continue
            other = pair_to_he.get((vj, vi))
            e = Edge()
            e.halfedge = h
            h.edge = e
            self.edges.append(e)
            if other is not None:
                h.twin = other
                other.twin = h
                other.edge = e
            else:
                b = Halfedge()  # boundary twin vj -> vi
                b.vertex = self.vertices[vj]
                b.twin = h
                b.edge = e
                h.twin = b
                self.halfedges.append(b)
                if vj in boundary_out:
                    raise ValueError(
                        f"non-manifold boundary at vertex {vj}"
                    )
                boundary_out[vj] = b

        # stitch boundary halfedges into loops (one virtual face each)
        visited = set()
        for start_v, b0 in boundary_out.items():
            if id(b0) in visited:
                continue
            loop = Face(is_boundary=True)
            loop.halfedge = b0
            self.boundaries.append(loop)
            b = b0
            while True:
                visited.add(id(b))
                b.face = loop
                # the next boundary halfedge starts where b ends
                b.next = boundary_out[b.twin.vertex.id]
                b = b.next
                if b is b0:
                    break

        # vertex halfedge pointers: prefer an interior outgoing halfedge
        for h in self.halfedges:
            v = h.vertex
            if v.halfedge is None or (v.halfedge.is_boundary
                                      and not h.is_boundary):
                v.halfedge = h
        for v in self.vertices:
            if v.halfedge is None:
                raise ValueError(f"isolated vertex {v.id}")

        self._renumber()

    def _renumber(self) -> None:
        for i, v in enumerate(self.vertices):
            v.id = i
        for i, e in enumerate(self.edges):
            e.id = i
        for i, f in enumerate(self.faces):
            f.id = i
        for i, h in enumerate(self.halfedges):
            h.id = i

    # -- conversion --------------------------------------------------------
    def to_polygon_soup(self) -> Tuple[np.ndarray, List[List[int]]]:
        self._renumber()
        positions = np.array([v.position for v in self.vertices])
        polys = [[v.id for v in f.vertices()] for f in self.faces]
        return positions, polys

    def triangulate(self) -> None:
        """Fan-triangulate every face in place (the reference's
        ``triangulate`` via splitPolygon, src/halfEdgeMesh.cpp:502-504)."""
        positions, polys = self.to_polygon_soup()
        tris: List[List[int]] = []
        for p in polys:
            for k in range(1, len(p) - 1):
                tris.append([p[0], p[k], p[k + 1]])
        self.build(tris, positions)

    # -- queries -----------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    @property
    def n_halfedges(self) -> int:
        return len(self.halfedges)

    def euler_characteristic(self) -> int:
        return self.n_vertices - self.n_edges + self.n_faces

    # -- consistency -------------------------------------------------------
    def validate(self) -> None:
        """Structural audit (the reference's sanity checks): twin
        involution, next-cycles, element back-pointers, vertex orbits."""
        for h in self.halfedges:
            assert h.twin is not None and h.twin.twin is h, f"{h} twin broken"
            assert h.twin is not h, f"{h} self-twin"
            assert h.next is not None, f"{h} missing next"
            assert h.edge is h.twin.edge, f"{h} edge mismatch"
            assert h.vertex is h.twin.target or True
            assert h.next.vertex is h.twin.vertex, f"{h} next origin mismatch"
            assert h.face is not None, f"{h} missing face"
        for e in self.edges:
            assert e.halfedge.edge is e, f"{e} halfedge backpointer"
        for f in self.faces + self.boundaries:
            n = 0
            for h in f.halfedges():
                assert h.face is f, f"{f} loop member {h} wrong face"
                n += 1
                assert n <= len(self.halfedges), f"{f} loop does not close"
            if not f.is_boundary:
                assert n >= 3, f"{f} degree {n} < 3"
        for v in self.vertices:
            assert v.halfedge.vertex is v, f"{v} halfedge backpointer"
            n = 0
            for _ in v.outgoing():
                n += 1
                assert n <= len(self.halfedges), f"{v} orbit does not close"
