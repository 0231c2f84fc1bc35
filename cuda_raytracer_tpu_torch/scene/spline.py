"""Catmull-Rom keyframe splines.

The reference declares ``Spline<T>`` over a ``map<double, T>`` of knots
(src/spline.h) but leaves ``evaluate`` / ``cubicSplineUnitInterval`` as
TODO stubs (src/spline.inl:6-22).  This implements the intended
Catmull-Rom interpolation: cubic Hermite blending with tangents from
central differences of neighboring knots, with virtual mirrored knots at
the boundaries.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional

import numpy as np


def cubic_spline_unit_interval(p0, p1, p2, p3, t: float, derivative: int = 0):
    """Evaluate the Catmull-Rom segment between p1 and p2 at normalized
    time t in [0, 1] (or its 1st/2nd derivative)."""
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float64) for p in (p0, p1, p2, p3))
    m1 = (p2 - p0) / 2.0
    m2 = (p3 - p1) / 2.0
    t2, t3 = t * t, t * t * t
    if derivative == 0:
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
    elif derivative == 1:
        h00 = 6 * t2 - 6 * t
        h10 = 3 * t2 - 4 * t + 1
        h01 = -6 * t2 + 6 * t
        h11 = 3 * t2 - 2 * t
    else:
        h00 = 12 * t - 6
        h10 = 6 * t - 4
        h01 = -12 * t + 6
        h11 = 6 * t - 2
    return h00 * p1 + h10 * m1 + h01 * p2 + h11 * m2


class Spline:
    """Keyframe spline over sorted knot times (src/spline.h API)."""

    def __init__(self):
        self.knots: Dict[float, np.ndarray] = {}

    # -- knot management (spline.h setValue/removeKnot) -------------------
    def set_value(self, time: float, value) -> None:
        self.knots[float(time)] = np.asarray(value, dtype=np.float64)

    # reference-style alias
    setValue = set_value

    def remove_knot(self, time: float, tolerance: float = 1e-3) -> bool:
        """Remove the knot nearest ``time`` within tolerance
        (src/spline.inl:27-)."""
        for t in list(self.knots):
            if abs(t - time) <= tolerance:
                del self.knots[t]
                return True
        return False

    removeKnot = remove_knot

    def _times(self) -> List[float]:
        return sorted(self.knots)

    # -- evaluation (stub at src/spline.inl:6-22; implemented) ------------
    def evaluate(self, time: float, derivative: int = 0,
                 default: Optional[np.ndarray] = None):
        times = self._times()
        if not times:
            if default is not None:
                return np.asarray(default, dtype=np.float64)
            raise ValueError("empty spline")
        if len(times) == 1:
            v = self.knots[times[0]]
            return np.zeros_like(v) if derivative else v

        t0, tn = times[0], times[-1]
        if time <= t0:
            v = self.knots[t0]
            return np.zeros_like(v) if derivative else v
        if time >= tn:
            v = self.knots[tn]
            return np.zeros_like(v) if derivative else v

        i = bisect_right(times, time) - 1
        i = min(max(i, 0), len(times) - 2)
        t1, t2 = times[i], times[i + 1]
        p1, p2 = self.knots[t1], self.knots[t2]
        # virtual boundary knots by mirroring (standard Catmull-Rom
        # boundary handling)
        p0 = self.knots[times[i - 1]] if i - 1 >= 0 else p1 + (p1 - p2)
        p3 = self.knots[times[i + 2]] if i + 2 < len(times) else p2 + (p2 - p1)
        span = t2 - t1
        u = (time - t1) / span
        out = cubic_spline_unit_interval(p0, p1, p2, p3, u, derivative)
        if derivative == 1:
            out = out / span
        elif derivative == 2:
            out = out / (span * span)
        return out

    def __call__(self, time: float):
        return self.evaluate(time)
