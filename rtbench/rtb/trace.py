"""One profiled span of the window, reduced in memory.

``profile(fn)`` runs ``fn`` under torch.profiler (host and device
activity; no trace file is written) inside a host range named
``rtbench.span`` and returns a ``Trace``: every device operation
(kernel, copy, fill) as (name, start, end) in seconds on the profiler's
clock, the host ranges likewise, and the span's own start and end on
that clock."""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

from . import stats

SPAN = "rtbench.span"
#: device operations that are not kernels
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset|memcpy|memset)")


class Op(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    device: List[Op]
    host: List[Op]
    start: float
    end: float
    frames: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> List[Op]:
        return [op for op in self.device if not _NOT_KERNEL.match(op.name)]

    def busy_s(self) -> float:
        """Seconds of the span in which some device operation ran."""
        return stats.covered([(o.start, o.end) for o in self.device],
                             self.start, self.end)

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time, summed by name."""
        total: Dict[str, float] = defaultdict(float)
        for op in self.device:
            total[op.name] += op.end - op.start
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with no device operation, each named by
        what the host was doing at its middle: the benchmark's range and
        the innermost host range there."""
        out = []
        for s, e in stats.gaps([(o.start, o.end) for o in self.device],
                               self.start, self.end):
            mid = (s + e) / 2
            around = [h for h in self.host
                      if h.start <= mid <= h.end and h.name != SPAN]
            outer = [h.name for h in around if h.name.startswith("rtbench.")]
            inner = min(around, key=lambda h: h.end - h.start,
                        default=None)
            parts = outer[-1:] + ([inner.name] if inner is not None
                                  and inner.name not in outer else [])
            out.append((" > ".join(parts) or "host idle", e - s))
        return sorted(out, key=lambda kv: -kv[1])[:top]


def profile(fn: Callable[[], int]) -> Trace:
    """Run ``fn`` (which returns the frames it rendered) under the
    profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            frames = fn()
            sync()
    device, host, span = [], [], None
    for e in prof.events():
        op = Op(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # a host range shows on the device's timeline too: not an
            # operation of the device
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("rtbench.")):
                device.append(op)
        elif e.device_type == DeviceType.CPU:
            if e.name == SPAN:
                span = op
            host.append(op)
    if span is None:
        raise RuntimeError("the profiler recorded no span")
    return Trace(device, host, span.start, span.end, frames)


def host_range(name: str):
    """A named host range that the profiler records (``rtbench.<name>``);
    it costs next to nothing when no profiler runs."""
    from torch.profiler import record_function

    return record_function(f"rtbench.{name}")
