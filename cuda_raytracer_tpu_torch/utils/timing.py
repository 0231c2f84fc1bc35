"""The port's instrumentation: named host ranges on the profiler's clock,
and the device fence.

``span(name)`` is a host range that a running ``torch.profiler`` session
records (``record_function``), on the same clock as the device trace it
takes, so the device's idle stretches can be put down to the range the
host was in.  With no profiler running it is one shared null context:
a range then costs a flag read and a ``with``, and changes nothing that
runs (no sync, no allocation).  The renderer's ranges
(render/engine.py) are named ``crt.*``.

A tally is a set of counters on the device that a kernel adds into
while the tally's device flag is on (``tally(name, keys, device,
slots)``: one int64 row of the keys per slot, so that a kernel can
spread its atomics over the slots, and the flag).  A CUDA graph that
holds the kernel holds the tally's addresses, so the flag, not the
graph, decides whether a frame counts.  Counting costs device time (the
DFS tally walks its rays a second time), so no profiled frame counts:
the frames after a profiled span stand in for the span's own, whose
device time the profile then holds without the tally's.
``frame_start``, which the renderer calls at render()'s entry, zeroes
the tallies and turns them on at the first frame after a profiler
stopped recording, and turns them off once they have counted as many
frames as the span held, or when a profiler records again (a device
copy or fill, no sync, only then).  ``counters()`` reads back what they
counted, with the number of frames it covers, and turns them off.  A
plain version counts on the host (``add``) under the same rule
(``counting()``).

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


class Tally:
    """One tally on one device, in one int64 tensor ``state``: the live
    counters ``live`` ([slots, len(keys)]) and, last, the flag ``on`` (1
    while it counts), so that one device copy from ``armed`` zeroes the
    counters and turns counting on."""

    def __init__(self, keys, device, slots):
        self.keys = tuple(keys)
        size = slots * len(self.keys)
        self.state = torch.zeros((size + 1,), dtype=torch.int64,
                                 device=device)
        self.live = self.state[:size].view(slots, len(self.keys))
        self.on = self.state[size:]
        self.armed = torch.zeros_like(self.state)
        self.armed[size] = 1
        self.on.fill_(int(_counting))


#: (name, device) -> Tally
_TALLIES = {}
#: whether the last frame_start saw a profiler recording, and the frames
#: of the last profiled span
_recorded = False
_span = 0
#: whether the tallies count, and the frames they counted since armed
_counting = False
_frames = 0


def recording() -> bool:
    """Whether a profiler records now."""
    return _profiler._is_profiler_enabled


def counting() -> bool:
    """Whether the tallies count this frame."""
    return _counting


def tally(name: str, keys, device, slots: int = 1) -> Tally:
    """Tally ``name`` on ``device``, made at the first call (outside any
    graph capture: a capture would record its zeroing) and the same
    tensors after it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _TALLIES.get((name, dev))
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"tally {name!r} on {dev} made inside a "
                               "graph capture: run the work eagerly first")
        t = _TALLIES[(name, dev)] = Tally(keys, dev, slots)
    elif t.keys != tuple(keys) or t.live.shape[0] != slots:
        raise ValueError(f"tally {name!r} was made with keys {t.keys} and "
                         f"{t.live.shape[0]} slots")
    return t


def add(name: str, keys, device, values) -> None:
    """Add ``values`` (key -> count) into tally ``name``'s first slot on
    ``device``: a plain version's host counts."""
    live = tally(name, keys, device).live
    live[0] += torch.tensor([int(values.get(k, 0)) for k in keys],
                            dtype=torch.int64, device=live.device)


def _turn(on: bool) -> None:
    global _counting, _frames
    _counting = on
    for t in _TALLIES.values():
        if on:
            t.state.copy_(t.armed)
        else:
            t.on.fill_(0)
    if on:
        _frames = 0


def frame_start() -> None:
    """At a frame's start: where a profiler records, no tally counts
    and the span's frames are counted; at the first frame after it
    stopped, zero every tally and turn it on (one device copy each);
    after as many frames as the span held, turn it off."""
    global _recorded, _span, _frames
    rec = recording()
    if rec:
        if _counting:
            _turn(False)
        _span = _span + 1 if _recorded else 1
    elif _recorded:
        _turn(True)
    elif _counting and _frames >= _span:
        _turn(False)
    _recorded = rec
    _frames += _counting


def counters():
    """name -> {key: count, "frames": frames}: what each tally counted
    over the ``frames`` frames since the last profiled span ended,
    summed over its slots and devices; read back here, after which no
    tally counts (until the next span has ended)."""
    out = {}
    for (name, _), t in _TALLIES.items():
        got = t.live.sum(0).tolist()
        mine = out.setdefault(name, dict.fromkeys(t.keys, 0))
        for k, v in zip(t.keys, got):
            mine[k] += int(v)
        mine["frames"] = _frames
    if _counting:
        _turn(False)
    return out


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
