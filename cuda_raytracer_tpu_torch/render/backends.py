"""Traversal-backend factory for the bounce loop.

The port of ``cuda_raytracer_tpu/render/backends.py``.  ``"dfs"`` and
``"auto"`` resolve to ``ops.packet_dfs.trace_closest_packets``,
``"pallas"`` (the JAX package's name for its wavefront2 kernels, kept so
configs carry over) to ``ops.wavefront2.trace_closest_wavefront``: each
runs its CUDA kernels on the GPU and its plain versions on the CPU.
``"xla"`` (ops/traverse.py) is a valid config value that raises until
it is ported, as do the options that need unported modules.

Seeded bounds (ops/seeds.py) are not ported.  The JAX package seeds a
wavefront pass only when it is a secondary, non-compacted pass (or the
camera pass under ``seed_primary``) with ``seed_k > 0`` on a scene that
has seed rows; such a pass raises here instead of running unseeded
unasked.  The fast preset reaches the wavefront only through compacted
passes, which the JAX package never seeds, so nothing on that path is
lost.
"""

from __future__ import annotations

from ..config import RenderConfig
from ..ops.packet_dfs import trace_closest_packets
from ..ops.wavefront2 import trace_closest_wavefront

_NOT_PORTED = {
    "xla": "ROADMAP queue 1 item 3 (ops/traverse.py trace_closest)",
}
_SEEDS = "needs ops/seeds.py, not ported yet (ROADMAP queue 1 item 9)"


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
    if kind not in ("dfs", "pallas"):
        raise ValueError(f"unknown traversal backend {kind!r}")
    if cfg.slab_bf16:
        raise NotImplementedError(
            "slab_bf16=True is not ported (the kernels run f32 box tests; "
            "ROADMAP queue 2)"
        )

    if kind == "dfs":
        if cfg.seed_primary:
            raise NotImplementedError(f"seed_primary=True {_SEEDS}")
        psize = ((cfg.packet_size_secondary or cfg.packet_size)
                 if secondary else cfg.packet_size)

        def trace_dfs(scene, o, d, valid, t_limit=None):
            tl = None if cfg.reference_compat else t_limit
            return trace_closest_packets(
                scene, o, d, valid, tl, kill_eps=cfg.shadow_eps,
                packet_size=psize,
            )

        return trace_dfs

    # compaction only pays on RR-thinned populations: the caller passes
    # compact=True for depths past rr_start_depth.  rr_dense populations
    # arrive compacted, so no partition inside the trace.
    do_compact = compact and cfg.compact_secondary and not rr_dense
    # the passes the JAX package would seed (its seeds_for)
    may_seed = bool(cfg.seed_k) and not compact and not rr_dense and (
        secondary or cfg.seed_primary)

    def trace_wf2(scene, o, d, valid, t_limit=None):
        if may_seed and scene.seed_rows is not None:
            raise NotImplementedError(
                f"a seeded wavefront pass (seed_k={cfg.seed_k}) {_SEEDS}; "
                "set seed_k=0 to trace it unseeded"
            )
        # reference-compat shadow semantics need hits beyond maxT, so
        # only prune/kill by t_limit in the default mode
        tl = None if cfg.reference_compat else t_limit
        return trace_closest_wavefront(
            scene, o, d, valid, tl, cfg.queue_multiplier,
            kill_eps=cfg.shadow_eps, compact=do_compact,
            # shadow passes only consume the t > maxT - eps comparison
            # (nee_accum), so their prim ids are not decoded
            want_prim=tl is None,
        )

    return trace_wf2
