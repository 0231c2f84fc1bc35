"""The port's instrumentation: named host ranges on the profiler's clock,
and the device fence.

``span(name)`` is a host range that a running ``torch.profiler`` session
records (``record_function``), on the same clock as the device trace it
takes, so the device's idle stretches can be put down to the range the
host was in.  With no profiler running it is one shared null context:
a range then costs a flag read and a ``with``, and changes nothing that
runs (no sync, no allocation).  The renderer's ranges
(render/engine.py) are named ``crt.*``.

``block_until_ready`` is ``jax.block_until_ready``'s counterpart: it
synchronises the CUDA devices its tensors live on; tensors on the CPU
need no fence.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A host range named ``name`` while a profiler records, else the
    shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


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
