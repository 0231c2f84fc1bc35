"""Traversal-backend factory for the bounce loop.

The port of ``cuda_raytracer_tpu/render/backends.py``.  ``"dfs"``
resolves to ``ops.packet_dfs.trace_closest_packets``, ``"pallas"`` (the
JAX package's name for its wavefront2 kernels, kept so configs carry
over) to ``ops.wavefront2.trace_closest_wavefront``: each runs its CUDA
kernels on the GPU and its plain versions on the CPU, for trees up to
width 8.  ``"xla"`` is ``ops.traverse.trace_closest``, torch ops on
either device, at any width.  ``"auto"`` is the DFS, and sends a scene
whose tree is wider than 8 to ``"xla"`` (decided per scene, where the
JAX package sends such a tree from its DFS to its wavefront).

Both kernel backends take ``cfg.slab_bf16`` (bf16 box tests) and the
seeded bounds of ``seeds_for``; ``"xla"`` takes neither, as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

from ..config import RenderConfig
from ..ops.packet_dfs import trace_closest_packets
from ..ops.seeds import seed_hits
from ..ops.traverse import trace_closest
from ..ops.wavefront2 import trace_closest_wavefront


def make_trace_fn(cfg: RenderConfig, secondary: bool = False,
                  compact: bool = False, rr_dense: bool = False):
    """The traversal for one class of pass: the camera pass
    (cfg.traversal), bounce and depth>0 shadow passes
    (cfg.traversal_secondary) or RR-thinned depths (cfg.traversal_rr;
    ``rr_dense``: a whole-depth-compacted population, which arrives
    compacted, so the wavefront runs without its partition).
    Returns trace(scene, o, d, valid, t_limit=None) -> WaveTraceResult.
    """
    if compact or rr_dense:
        kind = cfg.traversal_rr or cfg.traversal_secondary or cfg.traversal
    elif secondary:
        kind = cfg.traversal_secondary or cfg.traversal
    else:
        kind = cfg.traversal
    auto = kind == "auto"
    if auto:
        kind = "dfs"
    if kind == "xla":

        def trace_xla(scene, o, d, valid, t_limit=None):
            # the JAX signature: shadow passes trace to the closest hit
            return trace_closest(scene, o, d, valid, cfg.queue_multiplier)

        return trace_xla
    if kind not in ("dfs", "pallas"):
        raise ValueError(f"unknown traversal backend {kind!r}")

    def seeds_for(scene, o, d, valid, backend):
        """Conservative per-ray upper bounds from the seed_k largest prims
        (ops/seeds.py), or (None, None), by the JAX package's rules:
        never for compacted or rr_dense passes (the sweep covers every
        lane while the saving scales with the live ones), nor for DFS
        passes or the camera pass unless cfg.seed_primary."""
        use = (cfg.seed_k and scene.seed_rows is not None
               and not compact and not rr_dense)
        if use and backend == "dfs" and not cfg.seed_primary:
            use = False
        if use and not secondary and not cfg.seed_primary:
            use = False
        if use:
            sd = seed_hits(scene, o, d, valid, k=cfg.seed_k)
            return sd.t, sd.prim
        return None, None

    if kind == "dfs":
        psize = ((cfg.packet_size_secondary or cfg.packet_size)
                 if secondary else cfg.packet_size)

        def trace_dfs(scene, o, d, valid, t_limit=None):
            if auto and scene.bvh.width > 8:
                # trees wider than the kernels take: the torch traversal
                return trace_closest(scene, o, d, valid, cfg.queue_multiplier)
            tl = None if cfg.reference_compat else t_limit
            st, sp = seeds_for(scene, o, d, valid, "dfs")
            return trace_closest_packets(
                scene, o, d, valid, tl, kill_eps=cfg.shadow_eps,
                packet_size=psize, slab_bf16=cfg.slab_bf16,
                seed_t=st, seed_prim=sp,
            )

        return trace_dfs

    # compaction only pays on RR-thinned populations: the caller passes
    # compact=True for depths past rr_start_depth.  rr_dense populations
    # arrive compacted, so no partition inside the trace.
    do_compact = compact and cfg.compact_secondary and not rr_dense

    def trace_wf2(scene, o, d, valid, t_limit=None):
        # reference-compat shadow semantics need hits beyond maxT, so
        # only prune/kill by t_limit in the default mode
        tl = None if cfg.reference_compat else t_limit
        st, sp = seeds_for(scene, o, d, valid, "pallas")
        return trace_closest_wavefront(
            scene, o, d, valid, tl, cfg.queue_multiplier,
            kill_eps=cfg.shadow_eps, compact=do_compact,
            box_bf16=cfg.slab_bf16,
            # shadow passes only consume the t > maxT - eps comparison
            # (nee_accum), so their prim ids are not decoded
            want_prim=tl is None,
            seed_t=st, seed_prim=sp,
        )

    return trace_wf2


def xla_passes(cfg: RenderConfig, width: int) -> Tuple[str, ...]:
    """The pass classes of ``cfg`` that trace through ``"xla"`` on a tree
    of ``width`` ("camera", "secondary", and "roulette" where
    rr_start_depth is set; ``"auto"`` takes "xla" for trees wider than
    8).  That traversal sizes its queues on the host (ops/traverse.py
    reads each compaction's count), so a frame that runs it cannot be
    captured as a CUDA graph."""
    secondary = cfg.traversal_secondary or cfg.traversal
    kinds = {"camera": cfg.traversal, "secondary": secondary}
    if cfg.rr_start_depth:
        kinds["roulette"] = cfg.traversal_rr or secondary
    return tuple(name for name, kind in kinds.items()
                 if kind == "xla" or (kind == "auto" and width > 8))
