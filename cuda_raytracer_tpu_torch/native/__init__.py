"""Native (C++) host code, compiled at first use and loaded via ctypes.

The SAH BVH builder (bvh_builder.cpp, a copy of the JAX package's) builds
the same tree as the numpy builder in accel/bvh.py, bit for bit, in a
fraction of its time.
"""

from .build import NativeBuildError, load_library  # noqa: F401
