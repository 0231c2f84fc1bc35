"""Transformation widget (headless XFormWidget).

The reference's translate/rotate/scale gizmo
(src/dynamic_scene/widgets.{h,cpp}) minus the GL drawing: mode state
machine (Translate/Rotate/Scale + cycle/restore, widgets.h:36-54) and
axis-constrained drag application onto the target's TRS fields — the
same fields ``keyframe()`` snapshots for animation.

Vertex-level targeting (widgets.h:75-77) moves an individual halfedge
vertex instead of the whole object.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np


class Mode(enum.Enum):
    TRANSLATE = 0
    ROTATE = 1
    SCALE = 2


class XFormWidget:
    """Applies axis-constrained TRS edits to a dynamic Mesh (or one of
    its halfedge vertices)."""

    def __init__(self):
        self.target = None  # dynamic_scene.Mesh
        self.target_element = None  # geometry.halfedge.Vertex or None
        self.mode = Mode.TRANSLATE
        self._last_mode = Mode.TRANSLATE
        self.axis: Optional[int] = None  # 0/1/2 or None = screen-space
        self.click_position = np.zeros(2)

    # -- target / mode (widgets.h:38-54) -----------------------------------
    def set_target(self, obj, element=None) -> None:
        self.target = obj
        self.target_element = element

    def set_translate(self) -> None:
        self._remember()
        self.mode = Mode.TRANSLATE

    def set_rotate(self) -> None:
        self._remember()
        self.mode = Mode.ROTATE

    def set_scale(self) -> None:
        self._remember()
        self.mode = Mode.SCALE

    def cycle_mode(self) -> None:
        self._remember()
        self.mode = Mode((self.mode.value + 1) % 3)

    def restore_last_mode(self) -> None:
        self.mode, self._last_mode = self._last_mode, self.mode

    def _remember(self) -> None:
        self._last_mode = self.mode

    def set_click_position(self, position) -> None:
        self.click_position = np.asarray(position, dtype=np.float64)

    def set_axis(self, axis: Optional[int]) -> None:
        self.axis = axis

    # -- drag application (widgets.cpp drag handling) -----------------------
    def drag(self, dx: float, dy: float) -> bool:
        """Apply a drag delta.  Translate moves along the constrained
        axis by dx; rotate adds dx degrees about it; scale multiplies
        by (1 + dx).  With no axis constraint, translate uses (dx, dy)
        in the XY plane.  Returns False with no target."""
        if self.target is None:
            return False
        if self.target_element is not None and self.mode is Mode.TRANSLATE:
            delta = np.zeros(3)
            if self.axis is None:
                delta[0], delta[1] = dx, dy
            else:
                delta[self.axis] = dx
            self.target_element.position = (
                self.target_element.position + delta
            )
            self.target._sync_from_halfedge()
            return True
        if self.mode is Mode.TRANSLATE:
            delta = np.zeros(3)
            if self.axis is None:
                delta[0], delta[1] = dx, dy
            else:
                delta[self.axis] = dx
            self.target.position = np.asarray(self.target.position) + delta
        elif self.mode is Mode.ROTATE:
            rot = np.asarray(self.target.rotation, dtype=np.float64).copy()
            rot[self.axis if self.axis is not None else 1] += dx
            self.target.rotation = rot
        else:  # SCALE
            scale = np.asarray(self.target.scale, dtype=np.float64).copy()
            factor = 1.0 + dx
            if self.axis is None:
                scale *= factor
            else:
                scale[self.axis] *= factor
            self.target.scale = scale
        return True
