"""The one bounce loop.

The port of ``cuda_raytracer_tpu/render/bounce.py``: one depth is
closest-hit trace -> emission -> NEE shadow passes -> BSDF scatter +
Russian roulette, with the same fold_in key tree (1000+depth for NEE,
2000+depth for scatter, 3000+depth for roulette, 17 for shared scatter
draws), so the port draws the JAX package's noise.  The keys of a frame
are derived on the host, all at once, by ``frame_keys``; a depth reads
its own from that table (host keys, or a ``rng.KeyTable`` on the device
for a captured frame), so nothing in a depth changes from frame to
frame but the table's contents.

Whole-depth compaction (cfg.compact_depths): at the roulette-thinned
depths the engine packs the per-lane path state (``pack_state``),
compacts the live lanes to a prefix (ops/partition.py), reads the live
count on the host and runs the whole depth (trace, shading, NEE,
scatter and roulette) over a capacity bucket of ``m`` lanes
(``run_depth_compacted``, which takes the live count as the partition's
0-d tensor: the host count only picks ``m``); radiance goes back to the
full-size ``light`` by ray id.  Draws over ``m`` lanes are the JAX
package's draws over the same ``m``, so the compacted frame is the JAX
package's compacted frame.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from .. import rng
from ..config import RenderConfig
from ..ops import shade_stages as SS
from ..render.flatscene import FlatScene
from ..utils.timing import span
from .backends import make_trace_fn


def make_stage_fns(cfg: RenderConfig):
    """The per-frame stage functions."""
    trace = make_trace_fn(cfg)
    same_secondary = (
        (cfg.traversal_secondary in ("", cfg.traversal))
        and not cfg.packet_size_secondary
    )
    trace_secondary = trace if same_secondary else make_trace_fn(
        cfg, secondary=True
    )
    trace_secondary_compact = make_trace_fn(
        cfg, secondary=True, compact=True
    ) if cfg.compact_secondary else trace_secondary

    def draw_u2(key, n, device):
        """[n, 2] uniforms, shared by every ray slot of a granule when
        rng_granule > 1 (see cfg.rng_granule)."""
        g = cfg.rng_granule
        if g > 1 and n % g == 0:
            return rng.uniform(key, (n // g, 2), device, repeat=g)
        if g > 1:
            warnings.warn(
                f"rng_granule={g} does not divide the {n}-lane "
                f"population; falling back to per-ray draws (packet "
                f"coherence lost)",
                stacklevel=2,
            )
        return rng.uniform(key, (n, 2), device)

    def shade_hit(scene, o, d, t, prim, valid, importance, light,
                  count_emission):
        return SS.shade_hit(scene, o, d, t, prim, valid, importance, light,
                            count_emission, cfg.origin_eps,
                            cfg.reference_compat)

    def nee_prep(scene, hit, importance, key, li, weight):
        u = draw_u2(key, hit.t.shape[0], hit.t.device)
        return SS.nee_prep(scene, hit, importance, li, u, weight,
                           compat_two_sided=cfg.reference_compat)

    def nee_accum(light, t_s, prim_s, max_t, li_imp, ok):
        return SS.nee_accum(light, t_s, prim_s, max_t, li_imp, ok,
                            cfg.shadow_eps, cfg.reference_compat)

    def scatter_spec(keys, n, device):
        """scatter's (keys, u, fold, rr_key) from ``keys``: (shared,
        hemisphere, fresnel, roulette), the depth's scatter keys
        (frame_keys); roulette None where the depth runs none."""
        k_shared, k_hemi, k_fresnel, k_rr = keys
        u, fold = None, False
        if cfg.rng_granule > 1:
            u = draw_u2(k_shared, n, device)
            # antithetic fold: one uniform sphere direction per granule
            fold = cfg.rng_fold_dirs and cfg.hemisphere_sampling == "uniform"
        return (k_hemi, k_fresnel), u, fold, k_rr

    def scatter(scene, hit, importance, keys):
        spec = scatter_spec(keys, hit.t.shape[0], hit.t.device)
        return SS.scatter(scene, hit, importance, *spec, cfg.origin_eps,
                          cfg.hemisphere_sampling)

    def shade_gap(scene, o, d, t, prim, importance, light, **kw):
        return SS.shade_gap(scene, o, d, t, prim, importance, light,
                            origin_eps=cfg.origin_eps,
                            shadow_eps=cfg.shadow_eps,
                            reference_compat=cfg.reference_compat,
                            hemisphere_sampling=cfg.hemisphere_sampling, **kw)

    return {
        "trace": trace,
        "trace_secondary": trace_secondary,
        "trace_secondary_compact": trace_secondary_compact,
        "trace_rr_dense": make_trace_fn(cfg, secondary=True, rr_dense=True),
        "shade_hit": shade_hit,
        "nee_prep": nee_prep,
        "nee_accum": nee_accum,
        "scatter": scatter,
        "nee_u": draw_u2,
        "scatter_spec": scatter_spec,
        "shade_gap": shade_gap,
    }


def frame_keys(cfg: RenderConfig, num_lights: int, key) -> dict:
    """Every key a frame of ``cfg`` draws from, derived on the host from
    the frame's key: ``"raygen"`` (fold_in(key, 0)); per depth
    ``("nee", depth, s, light)`` (fold_in of fold_in(key, 1000 + depth)
    by NEE sample, then by light) and, below max depth, ``("shared",
    depth)``, ``("hemi", depth)`` and ``("fresnel", depth)`` (of k_b =
    fold_in(key, 2000 + depth): fold_in(k_b, 17), then split(k_b)) and
    ``("rr", depth)`` (fold_in(key, 3000 + depth)).  The JAX package
    derives the same keys inside its bounce loop."""
    keys = {"raygen": rng.fold_in(key, 0)}
    schedule = list(cfg.nee_schedule)
    for depth in range(cfg.max_depth):
        num_nee = schedule[depth][0] if depth < len(schedule) else 0
        k_d = rng.fold_in(key, 1000 + depth)
        for s in range(num_nee):
            k_s = rng.fold_in(k_d, s)
            for li in range(num_lights):
                keys["nee", depth, s, li] = rng.fold_in(k_s, li)
        if depth + 1 < cfg.max_depth:
            k_b = rng.fold_in(key, 2000 + depth)
            keys["shared", depth] = rng.fold_in(k_b, 17)
            keys["hemi", depth], keys["fresnel", depth] = rng.split(k_b)
            keys["rr", depth] = rng.fold_in(key, 3000 + depth)
    return keys


def initial_carry(o, d, valid=None):
    """The carry of camera rays before depth 0: (o, d, valid,
    importance, light, count_emission, dropped)."""
    n = o.shape[0]
    dev = o.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    importance = torch.ones((n, 3), dtype=torch.float32, device=dev)
    light = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    count_emission = torch.ones((n,), dtype=torch.bool, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    return (o, d, valid, importance, light, count_emission, dropped)


def run_bounce_loop(J, cfg: RenderConfig, scene: FlatScene, o, d, keys,
                    valid=None, spans=None):
    """Trace and shade the camera rays through the full depth/NEE
    schedule, drawing from ``keys`` (frame_keys).  Returns (light
    [N, 3], dropped).  ``spans``, when given, names each depth's host
    range (utils/timing.span; the engine's ``crt.frame.depth{i}``)."""
    carry = initial_carry(o, d, valid)
    for depth in range(cfg.max_depth):
        with span(spans[depth]) if spans else contextlib.nullcontext():
            carry = run_depth(J, cfg, scene, carry, keys, depth)
    return carry[4], carry[6]


def run_depth(J, cfg: RenderConfig, scene: FlatScene, carry, keys, depth):
    """One depth: closest-hit trace, emission, NEE shadow passes, and
    (below max depth) BSDF scatter + optional Russian roulette.  On the
    card (``SS.chained``) the shading is one kernel after each trace
    (``_shade_chain``); on the CPU each stage is its plain version
    (ops/shade_stages.py).  ``carry`` is (o, d, valid, importance, light,
    count_emission, dropped); ``keys`` the frame's key table
    (frame_keys)."""
    (o, d, valid, importance, light, count_emission, dropped) = carry
    schedule = list(cfg.nee_schedule)
    if depth == 0:
        tr = J["trace"]
    elif cfg.rr_start_depth and depth >= cfg.rr_start_depth:
        tr = J.get("trace_secondary_compact",
                   J.get("trace_secondary", J["trace"]))
    else:
        tr = J.get("trace_secondary", J["trace"])
    res = tr(scene, o, d, valid)
    dropped = dropped + res.dropped
    num_nee, weight = schedule[depth] if depth < len(schedule) else (0, 0.0)
    if SS.chained(importance):
        return _shade_chain(J, cfg, scene, tr, (o, d, res.t, res.prim),
                            (valid, importance, light, count_emission,
                             dropped), keys, depth, num_nee, float(weight))
    hit, light = J["shade_hit"](
        scene, o, d, res.t, res.prim, valid, importance, light,
        count_emission,
    )
    for s in range(num_nee):
        for li in range(scene.num_lights):
            o_s, d_s, max_t, li_imp, ok = J["nee_prep"](
                scene, hit, importance, keys["nee", depth, s, li], li,
                float(weight)
            )
            res_s = tr(scene, o_s, d_s, ok, max_t)
            dropped = dropped + res_s.dropped
            light = J["nee_accum"](
                light, res_s.t, res_s.prim, max_t, li_imp, ok
            )
    if depth + 1 < cfg.max_depth:
        # Russian roulette (in the scatter stage): survive with p =
        # max(importance), reweight by 1/p (unbiased)
        rr = cfg.rr_start_depth and depth + 1 >= cfg.rr_start_depth
        o, d, importance, valid, count_emission = J["scatter"](
            scene, hit, importance,
            (keys["shared", depth], keys["hemi", depth],
             keys["fresnel", depth], keys["rr", depth] if rr else None)
        )
    return (o, d, valid, importance, light, count_emission, dropped)


def _shade_chain(J, cfg: RenderConfig, scene: FlatScene, tr, ray, carry,
                 keys, depth, num_nee, weight):
    """``run_depth``'s shading on the card after its closest-hit trace
    ``ray`` = (o, d, t, prim): one ``shade_gap`` kernel after each trace,
    the shadow traces between them (every NEE sample and light in
    ``run_depth``'s order); the hit record and each sample are recomputed
    inside the kernels, never stored, but for the li of the last sample
    of a depth that does not scatter.  ``carry``: (valid, importance,
    light, count_emission, dropped)."""
    o, d, t, prim = ray
    valid, importance, light, count_emission, dropped = carry
    n, dev = t.shape[0], t.device
    samples = [(s, li) for s in range(num_nee)
               for li in range(scene.num_lights)]
    scatters = depth + 1 < cfg.max_depth
    acc = None
    for k in range(len(samples) + 1):
        nee = None
        if k < len(samples):
            s, li = samples[k]
            nee = SS.Nee(li, J["nee_u"](keys["nee", depth, s, li], n, dev),
                         weight)
        sc = None
        if nee is None and scatters:
            rr = cfg.rr_start_depth and depth + 1 >= cfg.rr_start_depth
            sc = J["scatter_spec"](
                (keys["shared", depth], keys["hemi", depth],
                 keys["fresnel", depth], keys["rr", depth] if rr else None),
                n, dev)
        light, shadow, path = J["shade_gap"](
            scene, o, d, t, prim, importance, light,
            opened=(valid, count_emission) if k == 0 else None, accum=acc,
            sample=nee, store=not scatters and k == len(samples) - 1,
            scatter=sc)
        if nee is None:
            break
        res_s = tr(scene, shadow.o, shadow.d, shadow.ok, shadow.max_t)
        dropped = dropped + res_s.dropped
        acc = (nee, shadow, res_s.t, res_s.prim)
    if scatters:
        o, d, importance, valid, count_emission = path
    return (o, d, valid, importance, light, count_emission, dropped)


# ---------------------------------------------------------------------------
# whole-depth compaction (cfg.compact_depths)
# ---------------------------------------------------------------------------

#: fields of a lane's path state: o.xyz, d.xyz, ray id (an int32 bit
#: pattern), live flag (1 or -1: ops/partition.py's liveness field 7),
#: importance.xyz, count_emission, 4 pad fields
STATE_ROWS = 16
#: lanes of the JAX package's partition block, to which the state pads
_BLOCK = 1024


def pack_state(o, d, valid, importance, count_emission, ray_id):
    """Pack per-lane path state into an entry-major [N', 16] payload for
    ops/partition.compact_live_payload, N' = N padded to the 1024-lane
    partition block (pad lanes are dead, zero elsewhere): the JAX
    package's [16, N'] payload, transposed."""
    n = o.shape[0]
    n_pad = n + (-n) % _BLOCK
    payload = torch.zeros((n_pad, STATE_ROWS), dtype=torch.float32,
                          device=o.device)
    payload[:n, 0:3] = o
    payload[:n, 3:6] = d
    payload.view(torch.int32)[:n, 6] = ray_id.to(torch.int32)
    payload[:, 7] = -1.0
    payload[:n, 7] = torch.where(valid, 1.0, -1.0)
    payload[:n, 8:11] = importance
    payload[:n, 11] = count_emission.to(torch.float32)
    return payload


def unpack_state(packed, n_live):
    """Inverse of pack_state over a live prefix: (o, d, alive,
    importance, count_emission, ray_id).  Lanes at or past ``n_live`` (a
    0-d tensor or an int) are dead, whatever they hold: the partition
    leaves them undefined."""
    m = packed.shape[0]
    lane = torch.arange(m, device=packed.device)
    alive = (lane < n_live) & (packed[:, 7] >= 0.0)
    o = packed[:, 0:3].contiguous()
    d = packed[:, 3:6].contiguous()
    ids = packed.view(torch.int32)[:, 6]
    imp = packed[:, 8:11]
    ce = packed[:, 11] > 0.5
    return o, d, alive, imp, ce, ids


def run_depth_compacted(J, cfg: RenderConfig, scene: FlatScene,
                        packed, n_live, light, keys, depth, m):
    """One roulette depth over the compacted live prefix packed[:m]
    (``n_live`` the partition's 0-d count, at most m; a host int works
    too): ``run_depth`` on those lanes, every trace through the
    ``trace_rr_dense`` stage.  The radiance it earns is added to the
    full-size ``light`` in place, by ray id (live ids are unique, so
    each pixel sample gets one addition: the JAX package's scatter-add,
    exactly).  Returns (packed' [m, 16], light, dropped); below max
    depth packed' is the state after scatter and roulette, else the
    prefix itself."""
    sl = packed[:m]
    o, d, alive, importance, ce, ids = unpack_state(sl, n_live)
    # the population arrives compacted: as in the JAX package, the
    # wavefront runs without its own partition
    tr = J["trace_rr_dense"]
    Jd = dict(J, trace=tr, trace_secondary=tr, trace_secondary_compact=tr)
    light_m = torch.zeros((m, 3), dtype=torch.float32, device=o.device)
    zero = torch.zeros((), dtype=torch.int64, device=o.device)
    o, d, valid, importance, light_m, ce, dropped = run_depth(
        Jd, cfg, scene, (o, d, alive, importance, light_m, ce, zero),
        keys, depth)
    if depth + 1 < cfg.max_depth:
        packed_new = pack_state(o, d, valid & alive, importance, ce, ids)
    else:
        packed_new = sl
    # the live lanes are the prefix; every other lane adds +0 to row 0,
    # which leaves it as it is (light holds no -0).  No slice at the
    # live count and no boolean-mask select: either would need the count
    # on the host
    light.index_add_(0, torch.where(alive, ids, 0).long(),
                     torch.where(alive[:, None], light_m, 0.0))
    return packed_new, light, dropped
