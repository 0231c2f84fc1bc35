"""Flat device scene, traversal backends, bounce loop, engine."""

from .flatscene import FlatScene, FlatBVH, flatten_scene  # noqa: F401
