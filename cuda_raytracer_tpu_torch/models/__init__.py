"""Procedural scene "model zoo" used by tests and benchmarks."""

from .cornell import cornell_box_scene  # noqa: F401
