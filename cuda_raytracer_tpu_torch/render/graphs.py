"""A frame's programs as captured CUDA graphs.

The JAX engine never runs a frame op by op: it dispatches one compiled
executable per depth, plus raygen and the film, and its
ShardedRenderer one per frame (render/engine.py, parallel/shard.py of
the JAX package), because a dispatch per stage costs too much.  The
port's counterpart is a CUDA graph per program: ``FrameGraphs.run(key,
fn, device)`` captures ``fn()`` on the first call for ``key`` and
replays it from then on, so the few thousand kernel launches of a frame
become a few graph launches.  A replay runs the kernels the program
launched while it was captured, in the same order on the same
addresses, so it gives the eager program's bits.

What a caller keeps to:

* **Static inputs.**  What changes from frame to frame (the keys, the
  camera, the sample count) lives in buffers made before any capture;
  the caller rewrites them before a replay.  Nothing in a program copies
  from the host, reads a value back to it or sizes work from data:
  capture raises on each (``torch.cuda.graph`` reports the CUDA error),
  and nothing here falls back to running eagerly.
* **One pool.**  All graphs on one device share one memory pool and
  replay in the order they were captured, each frame.  A program's
  outputs stay alive with its graph, so no later capture reuses their
  memory; a program reads only the outputs of programs captured before
  it, and what must outlive the frame is copied out of the pool by the
  caller.  A program may update in place a tensor that an earlier
  program of the same frame made, never a buffer that outlives the
  frame: ``warm_up`` runs the programs once more.
* **Warm-up.**  Before its first capture the caller runs the programs
  once eagerly on a side stream (``warm_up``): the kernels' libraries
  are built and loaded and torch's caches filled outside any capture.
* **Launch counts.**  The kernel wrappers count launches in Python,
  which a replay does not run.  A capture records how far each counter
  moved (the launches it recorded) and sets it back; each replay adds
  that much, inside the caller's host range of the program (the
  engine's ``crt.frame.*``), so a profile charges it to the launch.  The
  warm-up's launches are real and stay counted; they are also added up
  in ``warmup_launches``.

On the CPU, or with ``enabled`` False, ``run`` calls the program.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Tuple

import torch

from .. import rng
from ..ops import filters, packet_dfs, partition, shade, shade_stages
from ..ops import wavefront2

#: the kernel wrappers' launch counters: (module, attribute)
COUNTERS = (
    (rng, "launches"),
    (packet_dfs, "launches"),
    (packet_dfs, "bf16_launches"),
    (packet_dfs, "tally_launches"),
    (partition, "launches"),
    (partition, "ray_launches"),
    (wavefront2, "count_launches"),
    (wavefront2, "count_bf16_launches"),
    (wavefront2, "pack_launches"),
    (wavefront2, "pack_bf16_launches"),
    (wavefront2, "pack_dyn_launches"),
    (wavefront2, "pack_dyn_bf16_launches"),
    (wavefront2, "decode_launches"),
    (shade_stages, "shade_hit_launches"),
    (shade_stages, "nee_prep_launches"),
    (shade_stages, "nee_accum_launches"),
    (shade_stages, "scatter_launches"),
    *((shade_stages, f"{g}_launches") for g in shade_stages.GAPS),
    (shade, "raygen_launches"),
    (filters, "film_launches"),
    (filters, "median_launches"),
)

#: launches made by warm-up runs since last set to 0, by (module's short
#: name, counter): "packet_dfs", "launches" and so on
warmup_launches: Dict[Tuple[str, str], int] = {}


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(mod, attr) for mod, attr in COUNTERS)


def _add(delta) -> None:
    for (mod, attr), n in zip(COUNTERS, delta):
        if n:
            setattr(mod, attr, getattr(mod, attr) + n)


def _short(mod) -> str:
    return mod.__name__.rsplit(".", 1)[-1]


class FrameGraphs:
    """The captured programs of one renderer: a graph per key, one memory
    pool and one capture stream per device.  ``captures`` counts the
    graphs captured, ``capture_s`` the host seconds their captures took
    and ``warmup_s`` those of the warm-ups; they grow only when
    ``reset`` has dropped the graphs (a scene load or a config change)
    or a new key arrives (a new compaction bucket, the other film)."""

    def __init__(self, enabled: bool = True):
        #: capture and replay; False: ``run`` calls the program
        self.enabled = enabled
        self.captures = 0
        self.capture_s = 0.0
        self.warmup_s = 0.0
        self._graphs: Dict[Hashable, tuple] = {}
        self._pools: Dict[torch.device, tuple] = {}

    def reset(self) -> None:
        """Drop every graph and pool: the next frame captures anew."""
        self._graphs = {}
        self._pools = {}

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __iter__(self):
        """The keys of the graphs captured, in capture order."""
        return iter(list(self._graphs))

    def __len__(self) -> int:
        return len(self._graphs)

    def warm_up(self, fn: Callable, device) -> None:
        """Run ``fn()`` eagerly on a side stream of ``device`` (the
        result is dropped), then free the blocks it left cached, which
        the graphs' pool cannot use."""
        device = torch.device(device)
        t0 = time.perf_counter()
        before = _counts()
        with torch.cuda.device(device):
            main = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn()
            main.wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        for (mod, attr), a, b in zip(COUNTERS, before, _counts()):
            if b != a:
                k = (_short(mod), attr)
                warmup_launches[k] = warmup_launches.get(k, 0) + b - a
        self.warmup_s += time.perf_counter() - t0

    def run(self, key: Hashable, fn: Callable, device):
        """``fn()``'s outputs: captured as a graph on the first call for
        ``key``, replayed on the current stream of ``device`` on every
        call; the graph's outputs are the same tensors each time."""
        if not self.enabled:
            return fn()
        device = torch.device(device)
        entry = self._graphs.get(key)
        with torch.cuda.device(device):
            if entry is None:
                entry = self._capture(fn, device)
                self._graphs[key] = entry
            graph, out, delta = entry
            graph.replay()
        _add(delta)
        return out

    def _capture(self, fn: Callable, device):
        t0 = time.perf_counter()
        if device not in self._pools:
            self._pools[device] = (torch.cuda.graph_pool_handle(),
                                   torch.cuda.Stream(device))
        pool, stream = self._pools[device]
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # capture_begin/capture_end, not torch.cuda.graph, which also
        # collects garbage and empties the allocator's cache at every
        # capture; capture_end raises what the capture met
        torch.cuda.synchronize(device)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        after = _counts()
        # the capture ran no kernel: the replays count its launches
        _add(tuple(b - a for a, b in zip(after, before)))
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, out, tuple(a - b for a, b in zip(after, before))
