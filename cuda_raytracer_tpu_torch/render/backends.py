"""Traversal-backend factory for the bounce loop.

The port of ``cuda_raytracer_tpu/render/backends.py``.  This slice ports
the packet-DFS traversal only: ``"dfs"`` and ``"auto"`` resolve to
``ops.packet_dfs.trace_closest_packets`` (its CUDA kernel on the GPU,
its plain version on the CPU).  ``"pallas"`` (the wavefront2 segment
kernels + partition) and ``"xla"`` (ops/traverse.py) are valid config
values that raise until they are ported, as do the options that need
unported modules.  With the fast preset and ``traversal_rr="dfs"`` the
JAX package's ``seeds_for`` never seeds a DFS pass (seed_primary is
False), so nothing on that path is lost.
"""

from __future__ import annotations

from ..config import RenderConfig
from ..ops.packet_dfs import trace_closest_packets

_NOT_PORTED = {
    "pallas": "ROADMAP queue 2 items 2-4 (partition, wavefront2 count/pack "
              "kernels and the hit-log merge)",
    "xla": "ROADMAP queue 1 item 3 (ops/traverse.py trace_closest)",
}


def make_trace_fn(cfg: RenderConfig, secondary: bool = False,
                  compact: bool = False, rr_dense: bool = False):
    """The traversal for one class of pass: the camera pass
    (cfg.traversal), bounce and depth>0 shadow passes
    (cfg.traversal_secondary) or RR-thinned depths (cfg.traversal_rr).
    Returns trace(scene, o, d, valid, t_limit=None) -> WaveTraceResult.
    """
    if compact or rr_dense:
        kind = cfg.traversal_rr or cfg.traversal_secondary or cfg.traversal
    elif secondary:
        kind = cfg.traversal_secondary or cfg.traversal
    else:
        kind = cfg.traversal
    if kind == "auto":
        kind = "dfs"
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"traversal backend {kind!r} is not ported to "
            f"cuda_raytracer_tpu_torch yet: {_NOT_PORTED[kind]}"
        )
    if kind != "dfs":
        raise ValueError(f"unknown traversal backend {kind!r}")
    if cfg.seed_primary:
        raise NotImplementedError(
            "seed_primary=True needs ops/seeds.py, not ported yet "
            "(ROADMAP queue 1 item 9)"
        )
    if cfg.slab_bf16:
        raise NotImplementedError(
            "slab_bf16=True is not ported (the DFS kernel runs f32 slabs)"
        )
    psize = ((cfg.packet_size_secondary or cfg.packet_size)
             if secondary else cfg.packet_size)

    def trace_dfs(scene, o, d, valid, t_limit=None):
        tl = None if cfg.reference_compat else t_limit
        return trace_closest_packets(
            scene, o, d, valid, tl, kill_eps=cfg.shadow_eps,
            packet_size=psize,
        )

    return trace_dfs
