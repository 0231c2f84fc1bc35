"""The generic metric readers that ``metrics/<name>.json`` files name
(``"reader"``).  Each takes the metric's spec and the run's context and
returns the metric's value, or None where the run has nothing for it
to read (the run then leaves the metric out).

The context holds ``load_times`` (the scene load's stage times),
``host_s`` (host-clock seconds by name: ``first_frame``), ``trace``
(trace.Trace of the profiled span) and ``port_kernels`` (the names of
the kernels in the port's CUDA sources)."""

from __future__ import annotations

import re
from typing import Dict, Optional


def stage_times(spec: Dict, ctx: Dict) -> Optional[float]:
    """The sum of the load's ``stage_times`` entries ``keys``."""
    times = ctx["load_times"]
    if not all(k in times for k in spec["keys"]):
        return None
    return sum(times[k] for k in spec["keys"]) * spec.get("scale", 1.0)


def host_seconds(spec: Dict, ctx: Dict) -> Optional[float]:
    """A host-clock reading of the run (``key``), scaled."""
    value = ctx["host_s"].get(spec["key"])
    return None if value is None else value * spec.get("scale", 1.0)


def _named(name: str, words) -> bool:
    return any(re.search(rf"\b{re.escape(w)}\b", name) for w in words)


def kernel_ms(spec: Dict, ctx: Dict) -> Optional[float]:
    """Device ms per profiled frame of the kernels named in ``kernels``
    (a word of the profiler's kernel name), or, with ``"others": true``,
    of every kernel not defined in the port's CUDA sources."""
    tr = ctx["trace"]
    if spec.get("others"):
        ops = [k for k in tr.kernels()
               if not _named(k.name, ctx["port_kernels"])]
    else:
        ops = [k for k in tr.kernels() if _named(k.name, spec["kernels"])]
    if not ops or tr.frames == 0:
        return None
    return sum(k.end - k.start for k in ops) * 1e3 / tr.frames


def idle_share(spec: Dict, ctx: Dict) -> Optional[float]:
    """The share of the profiled span in which no device operation
    ran."""
    tr = ctx["trace"]
    if not tr.device:
        return None
    return 1.0 - tr.busy_s() / tr.window_s


READERS = {"stage_times": stage_times, "host_seconds": host_seconds,
           "kernel_ms": kernel_ms, "idle_share": idle_share}
