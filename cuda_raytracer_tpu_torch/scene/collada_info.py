"""Typed COLLADA scene-info records.

Python equivalents of the reference's Collada info types
(src/collada/collada_info.h:18-52, camera_info.h, light_info.h,
sphere_info.h, polymesh_info.h, material_info.h).  All vectors are
numpy float64 arrays; transforms are 4x4 numpy matrices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class InstanceType(enum.Enum):
    CAMERA = "camera"
    LIGHT = "light"
    SPHERE = "sphere"
    POLYMESH = "polymesh"
    MATERIAL = "material"


@dataclasses.dataclass
class Instance:
    """Base of every typed scene instance (collada_info.h:18-34)."""

    type: InstanceType = None  # type: ignore[assignment]
    id: str = ""
    name: str = ""


class LightType(enum.Enum):
    """Light kinds (light_info.h:12-14)."""

    NONE = 0
    AMBIENT = 1
    DIRECTIONAL = 2
    AREA = 3
    POINT = 4
    SPOT = 5


def _v3(x, y, z):
    return np.array([x, y, z], dtype=np.float64)


@dataclasses.dataclass
class CameraInfo(Instance):
    """Perspective camera parameters (camera_info.h; parsed at
    collada.cpp:429-471)."""

    hFov: float = 50.0
    vFov: float = 35.0
    nClip: float = 0.001
    fClip: float = 1000.0
    # default view direction is -z; up from the document's up axis
    # (collada.cpp:436-438).
    view_dir: np.ndarray = dataclasses.field(default_factory=lambda: _v3(0, 0, -1))
    up_dir: np.ndarray = dataclasses.field(default_factory=lambda: _v3(0, 1, 0))

    def __post_init__(self):
        self.type = InstanceType.CAMERA


@dataclasses.dataclass
class LightInfo(Instance):
    """Light parameters (light_info.h:16-35; defaults light_info.cpp:8-21)."""

    light_type: LightType = LightType.NONE
    spectrum: np.ndarray = dataclasses.field(default_factory=lambda: _v3(1, 1, 1))
    position: np.ndarray = dataclasses.field(default_factory=lambda: _v3(0, 0, 0))
    direction: np.ndarray = dataclasses.field(default_factory=lambda: _v3(0, 0, -1))
    up: np.ndarray = dataclasses.field(default_factory=lambda: _v3(0, 1, 0))
    falloff_deg: float = 45.0
    falloff_exp: float = 0.15
    constant_att: float = 1.0
    linear_att: float = 0.0
    quadratic_att: float = 0.0

    def __post_init__(self):
        self.type = InstanceType.LIGHT


@dataclasses.dataclass
class MaterialInfo(Instance):
    """Material holding a BSDF built by the material factory
    (collada.cpp:868-957)."""

    bsdf: object = None  # scene.bsdf.BSDF

    def __post_init__(self):
        self.type = InstanceType.MATERIAL


@dataclasses.dataclass
class SphereInfo(Instance):
    """Analytic sphere geometry (sphere_info.h; parsed collada.cpp:577-599)."""

    radius: float = 1.0
    material: Optional[MaterialInfo] = None

    def __post_init__(self):
        self.type = InstanceType.SPHERE


@dataclasses.dataclass
class Polygon:
    """One polygon of a polymesh (polymesh_info.h)."""

    vertex_indices: List[int] = dataclasses.field(default_factory=list)
    normal_indices: List[int] = dataclasses.field(default_factory=list)
    texcoord_indices: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PolymeshInfo(Instance):
    """Polygon-mesh geometry (polymesh_info.h; parsed collada.cpp:601-866)."""

    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float64)
    )
    normals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float64)
    )
    polygons: List[Polygon] = dataclasses.field(default_factory=list)
    material: Optional[MaterialInfo] = None

    def __post_init__(self):
        self.type = InstanceType.POLYMESH


@dataclasses.dataclass
class Node:
    """A scene node: one instance plus its world transform
    (collada_info.h:44-52)."""

    instance: Instance = None  # type: ignore[assignment]
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    id: str = ""
    name: str = ""


@dataclasses.dataclass
class SceneInfo:
    """Parsed scene: a flat list of nodes (collada_info.h:55-60)."""

    nodes: List[Node] = dataclasses.field(default_factory=list)
