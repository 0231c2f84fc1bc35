"""Renderer configuration.

One dataclass replaces the reference's compile-time ``#define`` lattice
(reference: src/cudaRenderer.h:58-83 — TREE_WIDTH, RAYS_PER_BLOCK,
QUEUE_LENGTH_LOG2, MAX_TRIANGLES, SAMPLES_PER_PIXEL, ... — plus
TREE_BRANCHES/DEPTH in src/bvh.cpp:9-10 and the hard-coded bounce
schedule at src/cudaRenderer.cu:2515-2534).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # ---- image / sampling (src/cudaRenderer.h:72-74) ----
    width: int = 512
    height: int = 512
    #: samples per pixel traced per frame (chunked accumulation).
    samples_per_frame: int = 2
    #: total samples per pixel after full accumulation.
    total_samples: int = 512

    # ---- wide BVH (src/cudaRenderer.h:58, src/bvh.cpp:9-10, src/bvh.h:9) ----
    #: arity of the wide tree (reference TREE_WIDTH=4, supports up to 16).
    tree_width: int = 4
    #: maximum primitives per leaf (reference max_leaf_size=32, bvh.h:111).
    max_leaf_size: int = 32
    #: number of SAH partition planes (reference numparts=12, bvh.cpp:104).
    sah_bins: int = 12

    # ---- wavefront queues ----
    #: queue capacity multiplier for the wavefront backends: per-level
    #: entry capacity = multiplier * num rays (reference queueSize =
    #: numRays*TREE_WIDTH*4, cudaRenderer.cu:1920).  2 is ample in
    #: practice; overflows are counted and reported as dropped rays.
    #: The packet-DFS backend has no queues and ignores this.
    queue_multiplier: int = 2
    #: traversal backend: "auto" = packet-DFS Pallas kernel on TPU, XLA
    #: scan elsewhere; "dfs" / "pallas" (wavefront2 segment kernels) /
    #: "xla" force one.  (The round-1 "pallas1" kernels were retired in
    #: round 4; their comparison numbers are frozen in BENCHNOTES.md.)
    traversal: str = "auto"
    #: sample order for camera rays: "raster" = pixel-major rows (the
    #: reference's (x*H+y)*spp+s layout), "tiles8" = 8x8-pixel tiles
    #: with a pixel's samples consecutive.  Tiles make each 1024-ray
    #: traversal packet cover one image tile, which shrinks the
    #: packet-union working set 3-6x at 16 spp (tools/sim_spp.py).
    #: "tiles32s" = SAMPLE-major 32x32-pixel tiles: slot = s*(W*H) +
    #: tile-rank, so a 1024-slot packet holds one sample index of one
    #: tile — required by rng_granule (a pixel's spp samples land in
    #: spp different packets, so packet-shared draws stay independent
    #: per sample).
    sample_order: str = "raster"
    #: draw secondary-sampling uniforms (hemisphere scatter + NEE light
    #: point) once per `rng_granule` consecutive ray slots instead of
    #: per ray.  With the tiles32s layout and granule=packet size,
    #: every ray in a traversal packet leaving a flat surface shares an
    #: exact direction (or aims at one light point) — bounce/shadow
    #: packets become coherent BY CONSTRUCTION, the regime packet-DFS
    #: is ~7x faster in (tools/probe_shared_u.py).  Unbiased, and
    #: per-pixel variance is unchanged (each pixel's spp samples use
    #: spp distinct draws — only cross-pixel noise correlation within a
    #: tile appears, i.e. blotch-shaped instead of white noise at low
    #: spp).  1 = independent per-ray draws (the reference's cuRAND
    #: behavior, src/samplers.cu_inl).
    rng_granule: int = 1
    #: with rng_granule > 1 and uniform hemisphere sampling, share one
    #: uniform-SPHERE direction per granule and antithetically fold it
    #: into each lane's hemisphere (d = sign(dot(w, n)) * w) instead of
    #: sharing the local-frame uniforms: per-lane marginals are
    #: identical (exact 1/2pi hemisphere pdf), but a packet then emits
    #: at most TWO directions even across curved geometry, where
    #: shared local uniforms still diverge (direction depends on the
    #: lane's normal).  See ops/shade.scatter w_shared.
    rng_fold_dirs: bool = True
    #: traversal backend for RR-thinned depths (>= rr_start_depth);
    #: "" = same as traversal_secondary.  Compacted wavefront2 beats
    #: packet-DFS there even under shared-u coherence (the partition
    #: packs live lanes densely; tools/probe_shared_u2.py: d3 149 vs
    #: 317 ms).
    traversal_rr: str = ""
    #: fuse the whole frame into one jit executable: "auto" = yes on
    #: TPU (each separate dispatch through the runtime costs ~10-30 ms;
    #: a frame makes 30+), no elsewhere (per-stage jits compile much
    #: faster and CPU dispatch is cheap).
    fuse_frame: str = "auto"
    #: rays per packet-DFS traversal packet (the analog of the
    #: reference's RAYS_PER_BLOCK=64, cudaRenderer.h:59, sized for the
    #: 8x128 VPU instead of a 2-warp CUDA block).  Smaller packets
    #: shrink the union a divergent packet traverses; larger packets
    #: amortize per-visit control flow on coherent passes.
    packet_size: int = 1024
    #: packet size for secondary (bounce / depth>0 shadow) passes;
    #: 0 = same as packet_size.
    packet_size_secondary: int = 0
    #: traversal backend for secondary passes (bounce and depth>0
    #: shadow rays); "" = same as `traversal`.  The backends have
    #: opposite strengths: packet-DFS collapses to near-single-ray cost
    #: on coherent packets, wavefront2's queue design is coherence-
    #: insensitive — mixing them per pass beats either alone.
    traversal_secondary: str = ""
    #: compact dead lanes (invalid / RR-killed / decided shadow rays)
    #: out of the queue before secondary wavefront traversals.  The
    #: wavefront merge scatters by ray id, so compaction needs no
    #: inverse permutation; with rr_start_depth=2 the depth-2/3 sweeps
    #: shrink 4-10x.  The reference's scan-compaction serves the same
    #: role (src/exclusiveScan.cu_inl:73-110).  Ignored by non-pallas
    #: backends.
    compact_secondary: bool = True
    #: compact the WHOLE depth (traversal + compute_hits + NEE + BSDF
    #: scatter) at RR-thinned depths, not just the traversal sweep:
    #: the engine packs the per-lane path state into a [16, N] payload,
    #: stable-compacts live lanes (ops/pallas/partition.py), reads the
    #: live count on the host, and dispatches a per-(depth, capacity)
    #: executable over the live prefix only — radiance scatters back by
    #: ray id (sorted + unique, the same trick wavefront2's merge
    #: uses).  At 25%/11% liveness this removes the full-size XLA
    #: shading sweeps that dominated depths 2/3 (VERDICT r3 weak 2:
    #: 988 ms/frame of dead-lane shading).  Only takes effect in the
    #: engine's fused per-depth path with rr_start_depth > 0; the
    #: sharded paths keep dense masking (one jit under shard_map).
    compact_depths: bool = False
    #: conservative bf16 AABB slab tests in the packet-DFS kernel (2x
    #: vector throughput on the dominant per-visit math; outward
    #: rounding makes false positives only, so results are unchanged).
    slab_bf16: bool = False
    #: seed every Pallas-backend ray's carried upper bound with a
    #: dense brute-force hit against the seed_k largest-area prims
    #: (ops/seeds.py): boxes beyond the seed are pruned from the root
    #: down and rays whose seed is final log nothing, shrinking both
    #: the queues and the hit-log merge.  0 disables.  Measured on
    #: CBbunny (tools/ab_interleave.py seed/seed16/seed8 variants):
    #: K=16 covers every wall/light panel at a 96 ms sweep and wins
    #: end-to-end (bounce-d1 937 -> 586 ms); K=32 pays 272 ms of sweep
    #: for no extra pruning; K=8 loses walls and regresses shadows.
    seed_k: int = 16
    #: also seed the depth-0 (primary + camera-hit shadow) passes.
    #: Those run the packet-DFS backend, which is already near-optimal
    #: on coherent rays: seeding them measured a NET LOSS on the bench
    #: frame (engine A/B: 41.85 Mrays/s secondary-only vs 37.34 with
    #: depth-0 seeded vs 38.02 unseeded) — the two 96 ms sweeps buy no
    #: union shrink the coherent packets weren't already getting from
    #: their own evolving bounds.
    seed_primary: bool = False

    # ---- path schedule ----
    #: number of path vertices (camera hit = depth 1). The reference hard
    #: codes 3 (2 scatter bounces, cudaRenderer.cu:2515-2534).
    max_depth: int = 3
    #: per-depth NEE schedule: (num_samples, weight_per_sample). The
    #: reference uses 2 samples x 0.5 at depths 0 and 1 and 1 x 1.0 at
    #: depth 2 (cudaRenderer.cu:2515-2534).
    nee_schedule: Tuple[Tuple[int, float], ...] = ((2, 0.5), (2, 0.5), (1, 1.0))
    #: "uniform" hemisphere sampling (matches the reference's spherical
    #: sample folded to the upper hemisphere, samplers.cu_inl:11-30) or
    #: "cosine" importance sampling (lower variance, same expectation).
    hemisphere_sampling: str = "uniform"
    #: Russian roulette: scatter rays entering depth >= this survive
    #: with p = max(importance) (importance /= p) and die otherwise —
    #: unbiased, and dead lanes collapse bounce-packet unions.  0 = off
    #: (the reference never terminates early).
    rr_start_depth: int = 0

    # ---- film / post ----
    #: apply the 3x3 per-channel median filter while accumulated samples
    #: < this threshold (reference POST_PROCESS_THRESHOLD=32,
    #: cudaRenderer.h:70, applied at cudaRenderer.cu:2447-2449).
    post_process_threshold: int = 32

    # ---- numerics ----
    #: shadow-ray pass tolerance: a shadow ray "reaches" the light when its
    #: closest hit t > maxT - eps (reference 1e-3, cudaRenderer.cu:1279).
    shadow_eps: float = 1e-3
    #: scatter-ray origin offset along the normal (cudaRenderer.cu:599).
    origin_eps: float = 1e-3

    # ---- compat ----
    #: replicate the reference GPU renderer's intentional quirks
    #: (fixed 53.13deg camera frustum ignoring the COLLADA fov, the camera
    #: origin fudge +(0, 0.75, 0) at cudaRenderer.cu:1596, shadow rays that
    #: hit nothing contribute nothing). Default False = physically
    #: correct / Scotty3D-CPU-matching behavior.
    reference_compat: bool = False

    # ---- multi-chip ----
    #: how to shard rays across chips: "samples" (each chip traces a
    #: disjoint subset of the spp with its own RNG stream; final psum
    #: mean) or "tiles" (each chip owns a framebuffer slab).
    shard_mode: str = "samples"

    # ---- rng ----
    seed: int = 15618  # reference cuRAND seed (src/samplers.cu_inl:8).

    def __post_init__(self):
        if self.hemisphere_sampling not in ("uniform", "cosine"):
            raise ValueError(
                "hemisphere_sampling must be 'uniform' or 'cosine', got "
                f"{self.hemisphere_sampling!r}"
            )
        if self.traversal not in ("auto", "dfs", "pallas", "xla"):
            raise ValueError(f"unknown traversal {self.traversal!r}")
        if self.shard_mode not in ("samples", "tiles"):
            raise ValueError(f"unknown shard_mode {self.shard_mode!r}")
        if self.sample_order not in ("raster", "tiles8", "tiles32s"):
            raise ValueError(f"unknown sample_order {self.sample_order!r}")
        if self.sample_order == "tiles32s" and self.width % 32:
            raise ValueError(
                "sample_order='tiles32s' requires width to be a "
                f"multiple of 32, got {self.width} (height may be "
                "arbitrary; the last tile row packs densely)"
            )
        if self.rng_granule < 1 or (
            self.rng_granule > 1 and self.rng_granule % 128
        ):
            raise ValueError(
                f"rng_granule must be 1 or a multiple of 128, got "
                f"{self.rng_granule}"
            )
        if self.rng_granule > 1 and self.sample_order != "tiles32s":
            # pixel-major orders put a pixel's spp samples in the SAME
            # granule, so sharing draws across a granule would correlate
            # them and per-pixel variance would stop shrinking with spp
            raise ValueError(
                "rng_granule > 1 requires the sample-major "
                "sample_order='tiles32s' (pixel-major orders would "
                "share draws between a pixel's own samples)"
            )
        if self.traversal_rr not in ("", "auto", "dfs", "pallas", "xla"):
            raise ValueError(f"unknown traversal_rr {self.traversal_rr!r}")
        if self.fuse_frame not in ("auto", "yes", "no"):
            raise ValueError(f"unknown fuse_frame {self.fuse_frame!r}")
        if self.traversal_secondary not in (
            "", "auto", "dfs", "pallas", "xla"
        ):
            raise ValueError(
                f"unknown traversal_secondary {self.traversal_secondary!r}"
            )
        if self.sample_order == "tiles8" and (
            self.width % 8 or self.height % 8
        ):
            # tiles8 raygen/reconstruction use closed-form 8x8-tile
            # arithmetic that is only a bijection when both dims are
            # multiples of 8; anything else scatters samples to
            # out-of-range pixels.
            raise ValueError(
                "sample_order='tiles8' requires width and height to be "
                f"multiples of 8, got {self.width}x{self.height}; use "
                "sample_order='raster'"
            )
        for ps in (self.packet_size, self.packet_size_secondary):
            if ps and (ps % 128 or ps < 128):
                raise ValueError(
                    f"packet sizes must be positive multiples of 128 "
                    f"(TPU lane width), got {ps}"
                )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def rays_per_frame(self) -> int:
        return self.width * self.height * self.samples_per_frame


DEFAULT_CONFIG = RenderConfig()


def fast_preset_kwargs(width: int, height: int, spp: int = 64) -> dict:
    """RenderConfig kwargs for the measured-fastest TPU operating point
    (the bench.py settings; BENCHNOTES round-3/4 sweeps).  Defaults are
    reference-faithful (raster order, per-ray RNG, no RR, one backend)
    and run ~8x slower; this preset is how a CLI user reaches the
    benchmarked throughput (VERDICT r3 weak 3 / task 6):

    * sample-major 32x32-tile order + packet-granule shared-u sampling
      with antithetic folding (coherent secondary packets),
    * Russian roulette from depth 2,
    * per-pass hybrid backends (packet-DFS coherent passes, compacted
      wavefront2 on RR-thinned depths),
    * the sweep-winning W=4 / max_leaf=32 tree and 32 spp per pass,
    * K=16 seeded conservative bounds on secondary passes.

    Whole-depth compaction stays OFF: BENCHNOTES r4 measured it as a
    net loss at this operating point (best compacted frame 3.21 s vs
    2.57 s dense — wavefront2's internal compaction already bounds
    every sweep by the live count).  bench.py builds its config FROM
    these kwargs, and tests/test_bench_config.py asserts the two agree
    field for field (VERDICT r4 weak 2: the r4 preset silently shipped
    compact_depths=True, ~25%% below the advertised number).

    Falls back (with a warning) to raster order / per-ray RNG when the
    image width is not a multiple of 32 (tiles32s needs it).
    """
    kw = dict(
        tree_width=4,
        max_leaf_size=32,
        rr_start_depth=2,
        traversal="dfs",
        traversal_secondary="dfs",
        traversal_rr="pallas",
        compact_depths=False,
        seed_k=16,
        samples_per_frame=min(32, spp),
    )
    if width % 32 == 0:
        kw.update(sample_order="tiles32s", rng_granule=1024)
    else:
        import warnings

        warnings.warn(
            f"fast preset: width {width} is not a multiple of 32; "
            "keeping raster sample order (no shared-u packet "
            "coherence — expect lower throughput)",
            stacklevel=2,
        )
    return kw
