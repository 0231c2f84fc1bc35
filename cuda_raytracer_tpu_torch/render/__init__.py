"""Flat device scene, traversal backends, bounce loop, engine, and the
PathTracer oracle (render/pathtracer.py)."""

from .flatscene import FlatScene, FlatBVH, flatten_scene  # noqa: F401
