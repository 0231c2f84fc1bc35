"""Scene layer: static scene graph, camera, BSDFs (numpy host types).

Copies of the JAX package's jax-free scene modules; COLLADA loading and
the dynamic scene are not ported yet (ROADMAP queue 1).
"""

from .bsdf import (  # noqa: F401
    BSDF,
    DiffuseBSDF,
    EmissionBSDF,
    GlassBSDF,
    MirrorBSDF,
    RefractionBSDF,
)
from .camera import Camera  # noqa: F401
from . import static_scene  # noqa: F401
