"""Scene layer: COLLADA I/O, scene graph, camera, BSDFs, the editor's
session slots, skeletons and widgets (numpy host types).

Copies of the JAX package's jax-free scene modules, with its exports,
plus the session manager (``SessionManager``, ``scene_to_info``).
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
from .session import SessionManager, scene_to_info  # noqa: F401
