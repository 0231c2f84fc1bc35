"""The one bounce loop.

The port of ``cuda_raytracer_tpu/render/bounce.py``: one depth is
closest-hit trace -> emission -> NEE shadow passes -> BSDF scatter +
Russian roulette, with the same fold_in key tree (1000+depth for NEE,
2000+depth for scatter, 3000+depth for roulette, 17 for shared scatter
draws), so the port draws the JAX package's noise.  Whole-depth
compaction (cfg.compact_depths) is not ported yet.
"""

from __future__ import annotations

import warnings

import torch

from .. import rng
from ..config import RenderConfig
from ..ops import shade as S
from ..render.flatscene import FlatScene
from .backends import make_trace_fn


def make_stage_fns(cfg: RenderConfig):
    """The per-frame stage functions."""
    if cfg.compact_depths:
        raise NotImplementedError(
            "compact_depths=True (whole-depth compaction) is not ported "
            "yet (ROADMAP queue 1 item 10)"
        )
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
            u = rng.uniform(key, (n // g, 2), device)
            return torch.repeat_interleave(u, g, dim=0)
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
        hit = S.compute_hits(scene, o, d, t, prim, cfg.origin_eps)
        if not cfg.reference_compat:
            light = light + S.emission_at_hits(
                scene, hit, importance, count_emission
            )
            if scene.has_env:
                miss = valid & (prim < 0)
                light = light + S.env_miss_radiance(
                    scene, d, importance, miss, count_emission
                )
        return hit, light

    def nee_prep(scene, hit, importance, key, li, weight):
        u = draw_u2(key, hit.t.shape[0], hit.t.device)
        return S.nee_shadow_rays(
            scene, hit, importance, li, u, weight,
            compat_two_sided=cfg.reference_compat,
        )

    def nee_accum(light, t_s, prim_s, max_t, li_imp, ok):
        passes = t_s > max_t - cfg.shadow_eps
        if cfg.reference_compat:
            passes = passes & (prim_s >= 0)
        return light + torch.where((ok & passes)[:, None], li_imp, 0.0)

    def scatter(scene, hit, importance, key):
        u = w = None
        if cfg.rng_granule > 1:
            u = draw_u2(rng.fold_in(key, 17), hit.t.shape[0], hit.t.device)
            if cfg.rng_fold_dirs and cfg.hemisphere_sampling == "uniform":
                # antithetic fold: one uniform sphere direction per granule
                u, w = None, S._spherical_sample(u)
        return S.scatter(scene, hit, importance, key,
                         cfg.origin_eps, cfg.hemisphere_sampling,
                         u=u, w_shared=w)

    return {
        "trace": trace,
        "trace_secondary": trace_secondary,
        "trace_secondary_compact": trace_secondary_compact,
        "shade_hit": shade_hit,
        "nee_prep": nee_prep,
        "nee_accum": nee_accum,
        "scatter": scatter,
    }


def run_bounce_loop(J, cfg: RenderConfig, scene: FlatScene, o, d, key,
                    valid=None):
    """Trace and shade the camera rays through the full depth/NEE
    schedule.  Returns (light [N, 3], dropped)."""
    n = o.shape[0]
    dev = o.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    importance = torch.ones((n, 3), dtype=torch.float32, device=dev)
    light = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    count_emission = torch.ones((n,), dtype=torch.bool, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)

    carry = (o, d, valid, importance, light, count_emission, dropped)
    for depth in range(cfg.max_depth):
        carry = run_depth(J, cfg, scene, carry, key, depth)
    return carry[4], carry[6]


def run_depth(J, cfg: RenderConfig, scene: FlatScene, carry, key, depth):
    """One depth: closest-hit trace, emission, NEE shadow passes, and
    (below max depth) BSDF scatter + optional Russian roulette.
    ``carry`` is (o, d, valid, importance, light, count_emission,
    dropped)."""
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
    hit, light = J["shade_hit"](
        scene, o, d, res.t, res.prim, valid, importance, light,
        count_emission,
    )
    num_nee, weight = schedule[depth] if depth < len(schedule) else (0, 0.0)
    k_d = rng.fold_in(key, 1000 + depth)
    for s in range(num_nee):
        k_s = rng.fold_in(k_d, s)
        for li in range(scene.num_lights):
            k_u = rng.fold_in(k_s, li)
            o_s, d_s, max_t, li_imp, ok = J["nee_prep"](
                scene, hit, importance, k_u, li, float(weight)
            )
            res_s = tr(scene, o_s, d_s, ok, max_t)
            dropped = dropped + res_s.dropped
            light = J["nee_accum"](
                light, res_s.t, res_s.prim, max_t, li_imp, ok
            )
    if depth + 1 < cfg.max_depth:
        k_b = rng.fold_in(key, 2000 + depth)
        o, d, importance, valid, count_emission = J["scatter"](
            scene, hit, importance, k_b
        )
        if cfg.rr_start_depth and depth + 1 >= cfg.rr_start_depth:
            # Russian roulette: survive with p = max(importance),
            # reweight by 1/p (unbiased)
            p = torch.clamp(importance.amax(-1), 0.05, 1.0)
            u_rr = rng.uniform(rng.fold_in(key, 3000 + depth),
                               tuple(p.shape), p.device)
            valid = valid & (u_rr < p)
            importance = importance / p[:, None]
    return (o, d, valid, importance, light, count_emission, dropped)
