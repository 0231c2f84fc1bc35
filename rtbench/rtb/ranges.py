"""The port's own host ranges in a profiled span: the renderer opens
ranges named ``crt.*`` while a profiler records (its utils/timing.span;
render/engine.py lists them), on the clock of the device trace.  A
reader sums the host time inside the ranges it names."""

from __future__ import annotations

import re
from typing import Optional

from . import stats

#: the first characters of every range the port opens
PREFIX = "crt."


def host_ms(trace, pattern: str) -> Optional[float]:
    """Host ms per profiled frame inside the ranges whose whole name
    matches ``pattern``, each instant counted once (a range inside
    another of them counts as the outer one); None where the span holds
    no ``crt.`` range (a program that opens none) or no frame."""
    if trace.frames == 0 or not any(h.name.startswith(PREFIX)
                                    for h in trace.host):
        return None
    named = re.compile(pattern)
    mine = [(h.start, h.end) for h in trace.host if named.fullmatch(h.name)]
    return stats.covered(mine, trace.start, trace.end) * 1e3 / trace.frames
