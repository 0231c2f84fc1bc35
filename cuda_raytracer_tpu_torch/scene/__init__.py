"""Scene layer: COLLADA I/O, scene graph, camera, BSDFs (numpy host types).

Copies of the JAX package's jax-free scene modules, with its exports.
The interactive session (``session``, ``skeleton``, ``widgets``) is not
ported yet (ROADMAP queue 1).
"""

from .collada_info import (  # noqa: F401
    CameraInfo,
    Instance,
    LightInfo,
    LightType,
    MaterialInfo,
    Node,
    PolymeshInfo,
    Polygon,
    SceneInfo,
    SphereInfo,
)
from .collada import ColladaParser, load_scene_info  # noqa: F401
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
from . import dynamic_scene  # noqa: F401
