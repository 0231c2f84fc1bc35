"""Editable mesh geometry: halfedge structure + local/global mesh ops."""

from .halfedge import Edge, Face, Halfedge, HalfedgeMesh, Vertex  # noqa: F401
