"""Acceleration structures: host-side SAH BVH build + wide-tree flattening."""

from .bvh import BVHAccel, BVHNode  # noqa: F401
from .wide import FlatWideBVH, build_flat_wide_bvh  # noqa: F401
