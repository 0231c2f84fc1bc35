"""Timing and throughput instrumentation.

The port of ``cuda_raytracer_tpu/utils/timing.py``: wall-clock lap
timers with device fencing, per-stage accumulation, and Mrays/s
accounting.  Where the JAX module waits with ``jax.block_until_ready``,
this one synchronises the CUDA devices its fence tensors live on;
tensors on the CPU need no fence.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def block_until_ready(tree) -> None:
    """Wait for the device work behind every tensor in ``tree`` (a tensor,
    or nested tuples, lists and dicts of them): one synchronize per CUDA
    device among them."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class LapTimer:
    """Per-stage lap timer (startTimer/lapTimer equivalent).

    >>> timer = LapTimer(verbose=True)
    >>> timer.start()
    >>> ... run stage ...
    >>> timer.lap("trace", out)   # prints "[LapTimer] trace : 12.3 ms"
    """

    def __init__(self, verbose: bool = False, sync: bool = True):
        self.verbose = verbose
        #: fence device work before reading the clock (CUDA launches are
        #: asynchronous; without this, laps measure enqueue time)
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self, name: str, fence=None) -> float:
        if fence is not None and self.sync:
            block_until_ready(fence)
        now = time.perf_counter()
        dt = now - (self._t0 if self._t0 is not None else now)
        self._t0 = now
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if self.verbose:
            print(f"[LapTimer] {name} : {dt * 1e3:.3f} ms")
        return dt

    @contextlib.contextmanager
    def stage(self, name: str, fence_value=None):
        self.start()
        holder = {}
        try:
            yield holder
        finally:
            self.lap(name, holder.get("fence", fence_value))

    def report(self) -> str:
        lines = ["stage                     total_ms    calls   avg_ms"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(
                f"{name:24s} {total * 1e3:9.2f} {c:8d} {total / c * 1e3:8.2f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class RayThroughput:
    """Mrays/s accounting across frames."""

    def __init__(self):
        self.rays = 0.0
        self.seconds = 0.0

    def add(self, rays: float, seconds: float) -> None:
        self.rays += rays
        self.seconds += seconds

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0
