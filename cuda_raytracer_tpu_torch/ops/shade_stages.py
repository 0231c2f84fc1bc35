"""The shading of a depth as kernels: the four stages (shade_hit,
nee_prep, nee_accum and scatter + Russian roulette), and the fused chain
of one kernel between two traces that a frame runs on the card.

The JAX engine compiles every stage (its per-depth jit, or one jit per
stage), and XLA fuses each stage's elementwise chain into a few loop
fusions that read each lane's inputs once.  Here each stage is one
hand-written kernel of ``ops/csrc/shade.cu`` (one thread per lane, one
pass, no temporaries in device memory).  On CUDA tensors a stage
launches its kernel or raises; on CPU tensors it runs its plain version
(``*_plain``: the op chain of ``ops/shade.py`` that the stage composes);
any other device is refused.  A configuration a kernel does not cover
raises on the card, naming it.

On the card a depth does not run the stages one by one: it runs
``shade_gap`` after each of its traces (``chained``; render/bounce.py
``run_depth``), one kernel that recomputes the hit record, and the NEE
sample it accumulates, in registers from what the traces read and wrote,
so neither reaches device memory.  Its variants (``GAPS``) are the
stages' bodies (the same ``__device__`` functions) chained as the gap
needs them; ``shade_gap_plain`` chains the plain stages the same way.

The draws are not part of a kernel: ``nee_prep`` and a gap take their
NEE uniforms, and ``scatter`` (and a scattering gap) draws the
hemisphere (where not given), Fresnel and roulette uniforms through
``rng.uniform`` before its launch, with the keys and shapes the plain
version draws with, so both see the same bits.  Each wrapper counts its
launches (``*_launches``, a gap's by variant, in
``render/graphs.COUNTERS``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .. import rng
from ..render.flatscene import (
    FlatScene,
    LIGHT_AREA,
    LIGHT_DIRECTIONAL,
    LIGHT_ENV,
    LIGHT_HEMISPHERE,
    LIGHT_POINT,
    LIGHT_SPOT,
)
from . import shade as S

#: launches of each kernel since the count was last set to 0
shade_hit_launches = 0
nee_prep_launches = 0
nee_accum_launches = 0
scatter_launches = 0

#: the fused chain's variants (GAP_VARIANTS in shade.cu, by index): after
#: the closest-hit trace ("open": emission) drawing the first sample, the
#: same storing its li, scattering (no sample at the depth), or nothing
#: more; after a shadow trace ("step", "close": accumulate the sample)
#: drawing the next sample, the same storing its li, scattering, or
#: (at a depth that does not scatter) adding the stored li alone
GAPS = ("open_nee", "open_nee_store", "open_scatter", "open", "step",
        "step_store", "close_scatter", "close_stored")
#: launches of each variant since the count was last set to 0
open_nee_launches = 0
open_nee_store_launches = 0
open_scatter_launches = 0
open_launches = 0
step_launches = 0
step_store_launches = 0
close_scatter_launches = 0
close_stored_launches = 0

#: light kinds nee_prep's kernel samples
LIGHT_KINDS = (LIGHT_AREA, LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE,
               LIGHT_SPOT, LIGHT_ENV)
#: hemisphere sampling modes of scatter's kernel (SAMPLE_* in shade.cu):
#: uniform, cosine, and the antithetic fold of a shared direction
_SAMPLE = {"uniform": 0, "cosine": 1, "fold": 2}

_lib = None


def _on(x: torch.Tensor) -> str:
    """The path for tensors on x's device: "cuda" or "cpu"."""
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no shading path for device {x.device}")
    return kind


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------


def shade_hit(scene: FlatScene, o, d, t, prim, valid, importance, light,
              count_emission, origin_eps: float, reference_compat: bool):
    """Hit records of a depth's closest-hit trace, and ``light`` plus
    the emission of counted paths that hit an emitter and, under an
    environment map, the map along counted paths that escaped (neither
    under ``reference_compat``, which returns ``light`` as it is).
    Returns (HitRecord, light)."""
    if _on(importance) == "cuda":
        return shade_hit_cuda(scene, o, d, t, prim, valid, importance, light,
                              count_emission, origin_eps, reference_compat)
    return shade_hit_plain(scene, o, d, t, prim, valid, importance, light,
                           count_emission, origin_eps, reference_compat)


def shade_hit_plain(scene: FlatScene, o, d, t, prim, valid, importance,
                    light, count_emission, origin_eps: float,
                    reference_compat: bool):
    """``shade_hit`` in torch ops (any device)."""
    hit = S.compute_hits(scene, o, d, t, prim, origin_eps)
    if not reference_compat:
        light = light + S.emission_at_hits(
            scene, hit, importance, count_emission
        )
        if scene.has_env:
            miss = valid & (prim < 0)
            light = light + S.env_miss_radiance(
                scene, d, importance, miss, count_emission
            )
    return hit, light


def nee_prep(scene: FlatScene, hit: S.HitRecord, importance,
             light_idx: int, u, weight: float,
             compat_two_sided: bool = False):
    """One NEE shadow ray per path vertex toward light ``light_idx``
    from the uniforms ``u`` [N, 2]: (o, d, max_t, light_importance, ok);
    ``o`` is ``hit.pt`` itself."""
    if _on(importance) == "cuda":
        return nee_prep_cuda(scene, hit, importance, light_idx, u, weight,
                             compat_two_sided)
    return nee_prep_plain(scene, hit, importance, light_idx, u, weight,
                          compat_two_sided)


def nee_prep_plain(scene: FlatScene, hit: S.HitRecord, importance,
                   light_idx: int, u, weight: float,
                   compat_two_sided: bool = False):
    """``nee_prep`` in torch ops (any device)."""
    return S.nee_shadow_rays(scene, hit, importance, light_idx, u, weight,
                             compat_two_sided=compat_two_sided)


def nee_accum(light, t_s, prim_s, max_t, li_imp, ok, shadow_eps: float,
              reference_compat: bool):
    """``light`` plus each NEE sample whose shadow ray reached its light
    (under ``reference_compat`` only where the shadow ray hit a prim)."""
    if _on(light) == "cuda":
        return nee_accum_cuda(light, t_s, prim_s, max_t, li_imp, ok,
                              shadow_eps, reference_compat)
    return nee_accum_plain(light, t_s, prim_s, max_t, li_imp, ok, shadow_eps,
                           reference_compat)


def nee_accum_plain(light, t_s, prim_s, max_t, li_imp, ok, shadow_eps: float,
                    reference_compat: bool):
    """``nee_accum`` in torch ops (any device)."""
    passes = t_s > max_t - shadow_eps
    if reference_compat:
        passes = passes & (prim_s >= 0)
    return light + torch.where((ok & passes)[:, None], li_imp, 0.0)


def scatter(scene: FlatScene, hit: S.HitRecord, importance, keys, u,
            fold: bool, rr_key, origin_eps: float,
            hemisphere_sampling: str):
    """The next path direction at every vertex, then Russian roulette
    where ``rr_key`` is given (survive with p = clamp(max importance,
    0.05, 1), reweight by 1/p).  ``keys``: the (hemisphere, Fresnel)
    keys; ``u``: the [N, 2] hemisphere uniforms, or None to draw them
    from the hemisphere key; ``fold``: ``u`` is a shared draw whose
    uniform sphere direction each lane folds into its hemisphere.
    Returns (o, d, importance', valid, count_emission)."""
    if _on(importance) == "cuda":
        return scatter_cuda(scene, hit, importance, keys, u, fold, rr_key,
                            origin_eps, hemisphere_sampling)
    return scatter_plain(scene, hit, importance, keys, u, fold, rr_key,
                         origin_eps, hemisphere_sampling)


def scatter_plain(scene: FlatScene, hit: S.HitRecord, importance, keys, u,
                  fold: bool, rr_key, origin_eps: float,
                  hemisphere_sampling: str):
    """``scatter`` in torch ops (any device)."""
    w = None
    if fold:
        u, w = None, S._spherical_sample(u)
    o, d, importance, valid, count_emission = S.scatter(
        scene, hit, importance, None, origin_eps, hemisphere_sampling,
        u=u, w_shared=w, split_keys=tuple(keys))
    if rr_key is not None:
        p = torch.clamp(importance.amax(-1), 0.05, 1.0)
        u_rr = rng.uniform(rr_key, tuple(p.shape), p.device)
        valid = valid & (u_rr < p)
        importance = importance / p[:, None]
    return o, d, importance, valid, count_emission


# ---------------------------------------------------------------------------
# the fused chain
# ---------------------------------------------------------------------------


class Nee(NamedTuple):
    """One NEE sample of a depth: toward light ``light`` (its index) from
    the uniforms ``u`` [N, 2], weighted by ``weight``."""
    light: int
    u: torch.Tensor
    weight: float


class Shadow(NamedTuple):
    """A sample's shadow ray as its gap writes it: what the trace reads
    (o, d, max_t, ok) and, where the gap stores it, the sample's light
    (``li``; None: the gap that accumulates the sample recomputes it)."""
    o: torch.Tensor
    d: torch.Tensor
    max_t: torch.Tensor
    ok: torch.Tensor
    li: Optional[torch.Tensor] = None


def chained(x: torch.Tensor) -> bool:
    """Whether a depth over tensors like ``x`` is shaded by the fused
    chain (``shade_gap`` after each trace: the card) rather than by the
    stages one by one (the plain versions: the CPU)."""
    return _on(x) == "cuda"


def gap_variant(opened: bool, accum, sample: bool, store: bool,
                scatter: bool) -> str:
    """The variant (``GAPS``) of a gap that follows the closest-hit trace
    (``opened``) or accumulates ``accum``'s sample, then draws a sample
    (storing its li where ``store``) or scatters."""
    stored = accum is not None and accum[1].li is not None
    if store and not sample:
        raise ValueError("a gap stores the li of a sample it draws")
    if (opened == (accum is not None)) or (sample and scatter) or (
            stored and (sample or scatter)):
        raise ValueError(f"no gap opens={opened} accumulates="
                         f"{accum is not None} (stored={stored}) draws="
                         f"{sample} scatters={scatter}")
    if opened:
        return ("open_nee" + "_store" * store if sample
                else "open_scatter" if scatter else "open")
    if sample:
        return "step" + "_store" * store
    if scatter:
        return "close_scatter"
    if not stored:
        raise ValueError("a gap that accumulates a sample and neither draws "
                         "nor scatters reads its stored li")
    return "close_stored"


def shade_gap(scene: FlatScene, o, d, t, prim, importance, light, *,
              opened=None, accum=None, sample: Optional[Nee] = None,
              store: bool = False, scatter=None, origin_eps: float,
              shadow_eps: float, reference_compat: bool,
              hemisphere_sampling: str):
    """The shading between two traces of a depth whose rays (o, d) met
    (t, prim) in its closest-hit trace, on paths of ``importance`` that
    carry ``light``:

    * ``opened``: (valid, count_emission), the carry's, where the gap
      follows the closest-hit trace: shade_hit's emission and, under an
      environment map, its miss radiance (neither under
      ``reference_compat``);
    * ``accum``: (nee, shadow, t_s, prim_s): the sample ``nee`` whose
      ``Shadow`` the trace just before met at (t_s, prim_s), added where
      it passed (nee_accum);
    * ``sample``: the next sample to draw (nee_prep), its li kept where
      ``store``;
    * ``scatter``: (keys, u, fold, rr_key), as ``scatter`` takes them.

    Returns (light, Shadow or None, (o, d, importance, valid,
    count_emission) or None)."""
    kw = dict(opened=opened, accum=accum, sample=sample, store=store,
              scatter=scatter, origin_eps=origin_eps, shadow_eps=shadow_eps,
              reference_compat=reference_compat,
              hemisphere_sampling=hemisphere_sampling)
    if _on(importance) == "cuda":
        return shade_gap_cuda(scene, o, d, t, prim, importance, light, **kw)
    return shade_gap_plain(scene, o, d, t, prim, importance, light, **kw)


def shade_gap_plain(scene: FlatScene, o, d, t, prim, importance, light, *,
                    opened=None, accum=None, sample: Optional[Nee] = None,
                    store: bool = False, scatter=None, origin_eps: float,
                    shadow_eps: float, reference_compat: bool,
                    hemisphere_sampling: str):
    """``shade_gap`` as the plain stages chain (any device)."""
    return gap_by_stages(
        (shade_hit_plain, nee_prep_plain, nee_accum_plain, scatter_plain),
        scene, o, d, t, prim, importance, light, opened=opened, accum=accum,
        sample=sample, store=store, scatter=scatter, origin_eps=origin_eps,
        shadow_eps=shadow_eps, reference_compat=reference_compat,
        hemisphere_sampling=hemisphere_sampling)


def gap_by_stages(stages, scene: FlatScene, o, d, t, prim, importance,
                  light, *, opened=None, accum=None,
                  sample: Optional[Nee] = None, store: bool = False,
                  scatter=None, origin_eps: float, shadow_eps: float,
                  reference_compat: bool, hemisphere_sampling: str):
    """``shade_gap`` as ``stages`` = (shade_hit, nee_prep, nee_accum,
    scatter) chain: the plain versions (``shade_gap_plain``) or the stage
    kernels' wrappers; the hit from shade_hit (without emission where
    the gap does not follow the closest-hit trace), the accumulated
    sample drawn again where not stored."""
    shade_hit_, nee_prep_, nee_accum_, scatter_ = stages
    variant = gap_variant(opened is not None, accum, sample is not None,
                          store, scatter is not None)
    hit = None
    if opened is not None:
        valid, ce = opened
        hit, light = shade_hit_(scene, o, d, t, prim, valid, importance,
                                light, ce, origin_eps, reference_compat)
    elif variant != "close_stored":
        hit = shade_hit_(scene, o, d, t, prim, None, importance, light, None,
                         origin_eps, True)[0]
    if accum is not None:
        nee, sh, t_s, prim_s = accum
        max_t, li, ok = sh.max_t, sh.li, sh.ok
        if li is None:
            _, _, max_t, li, ok = nee_prep_(
                scene, hit, importance, nee.light, nee.u, nee.weight,
                reference_compat)
        light = nee_accum_(light, t_s, prim_s, max_t, li, ok, shadow_eps,
                           reference_compat)
    shadow = path = None
    if sample is not None:
        pt, wi, max_t, li, ok = nee_prep_(
            scene, hit, importance, sample.light, sample.u, sample.weight,
            reference_compat)
        shadow = Shadow(pt if opened is not None else accum[1].o, wi, max_t,
                        ok, li if store else None)
    if scatter is not None:
        keys, u, fold, rr_key = scatter
        path = scatter_(scene, hit, importance, keys, u, fold, rr_key,
                        origin_eps, hemisphere_sampling)
    return light, shadow, path

# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


class _ShadeHitArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("o", _P), ("o_stride", _L), ("d", _P), ("d_stride", _L),
        ("t", _P), ("prim", _P), ("valid", _P), ("importance", _P),
        ("imp_stride", _L), ("light", _P), ("light_stride", _L),
        ("count_emission", _P), ("shade_packed", _P), ("num_prims", _L),
        ("bsdf_fn", _P), ("bsdf_radiance", _P), ("env_map", _P),
        ("env_h", _L), ("env_w", _L),
        ("valid_out", _P), ("pt", _P), ("nrm", _P), ("dpdu", _P),
        ("dpdv", _P), ("wo_local", _P), ("bsdf", _P), ("t_out", _P),
        ("backface", _P), ("light_out", _P),
        ("emission", _I), ("has_env", _I),
        ("origin_eps", _F),
    ]


class _NeePrepArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("pt", _P), ("pt_stride", _L), ("nrm", _P),
        ("nrm_stride", _L), ("bsdf", _P), ("valid", _P), ("importance", _P),
        ("imp_stride", _L), ("u", _P), ("u_stride", _L), ("bsdf_fn", _P),
        ("bsdf_albedo", _P), ("light_radiance", _P), ("light_position", _P),
        ("light_direction", _P), ("light_dim_x", _P), ("light_dim_y", _P),
        ("light_area", _P), ("light", _L), ("env_map", _P), ("env_cdf", _P),
        ("env_pdf", _P), ("env_h", _L), ("env_w", _L),
        ("wi", _P), ("max_t", _P), ("li", _P), ("ok", _P),
        ("kind", _I), ("two_sided", _I), ("weight", _F), ("env_solid", _F),
    ]


class _NeeAccumArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("light", _P), ("light_stride", _L), ("t_s", _P),
        ("prim_s", _P), ("max_t", _P), ("li", _P), ("li_stride", _L),
        ("ok", _P), ("light_out", _P), ("reference_compat", _I),
        ("shadow_eps", _F),
    ]


class _ScatterArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("pt", _P), ("pt_stride", _L), ("nrm", _P),
        ("nrm_stride", _L), ("dpdu", _P), ("dpdu_stride", _L), ("dpdv", _P),
        ("dpdv_stride", _L), ("wo_local", _P), ("wo_stride", _L),
        ("bsdf", _P), ("valid", _P), ("backface", _P), ("importance", _P),
        ("imp_stride", _L), ("u", _P), ("u_stride", _L), ("u_fresnel", _P),
        ("u_rr", _P), ("bsdf_fn", _P), ("bsdf_albedo", _P),
        ("bsdf_radiance", _P), ("bsdf_ior", _P),
        ("o_out", _P), ("d_out", _P), ("imp_out", _P), ("valid_out", _P),
        ("count_emission", _P), ("mode", _I), ("origin_eps", _F),
    ]


class _NeeDraw(ctypes.Structure):
    _fields_ = [("u", _P), ("u_stride", _L), ("light", _L), ("kind", _I),
                ("two_sided", _I), ("weight", _F)]


class _GapArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("o", _P), ("o_stride", _L), ("d", _P), ("d_stride", _L),
        ("t", _P), ("prim", _P), ("valid", _P), ("importance", _P),
        ("imp_stride", _L), ("light", _P), ("light_stride", _L),
        ("count_emission", _P),
        ("t_s", _P), ("prim_s", _P), ("max_t", _P), ("li", _P),
        ("li_stride", _L), ("ok", _P), ("acc", _NeeDraw), ("smp", _NeeDraw),
        ("u", _P), ("u_stride", _L), ("u_fresnel", _P), ("u_rr", _P),
        ("shade_packed", _P), ("num_prims", _L), ("bsdf_fn", _P),
        ("bsdf_albedo", _P), ("bsdf_radiance", _P), ("bsdf_ior", _P),
        ("light_radiance", _P), ("light_position", _P),
        ("light_direction", _P), ("light_dim_x", _P), ("light_dim_y", _P),
        ("light_area", _P), ("env_map", _P), ("env_cdf", _P),
        ("env_pdf", _P), ("env_h", _L), ("env_w", _L),
        ("light_out", _P), ("s_o", _P), ("s_d", _P), ("s_max_t", _P),
        ("s_li", _P), ("s_ok", _P), ("o_out", _P), ("d_out", _P),
        ("imp_out", _P), ("valid_out", _P), ("ce_out", _P),
        ("variant", _I), ("emission", _I), ("has_env", _I),
        ("reference_compat", _I), ("mode", _I), ("origin_eps", _F),
        ("shadow_eps", _F), ("env_solid", _F),
    ]


_ARGS = (_ShadeHitArgs, _NeePrepArgs, _NeeAccumArgs, _ScatterArgs,
         _GapArgs)


def _load_library():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("shade")
        lib.shade_args_size.argtypes = [ctypes.c_int]
        lib.shade_args_size.restype = ctypes.c_longlong
        for which, args in enumerate(_ARGS):
            size = lib.shade_args_size(which)
            if size != ctypes.sizeof(args):
                raise RuntimeError(f"shade.cu: {args.__name__[1:]} is {size} "
                                   f"bytes, its ctypes mirror "
                                   f"{ctypes.sizeof(args)}")
        for name, args in zip(("shade_hit", "nee_prep", "nee_accum",
                               "scatter", "shade_gap"), _ARGS):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, args, dev) -> bool:
    """Launch kernel ``name`` on ``dev``'s current stream; False (and no
    launch) for no lanes."""
    lib = _load_library()
    if args.n == 0:
        return False
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, name)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err}")
    return True


def _rows(x, name, dev, n, width=3):
    """(pointer, row stride) of an [n, width] float32 tensor on ``dev``
    whose rows are unit-stride (any row stride: 0 for an expand, 16 for a
    packed path state's columns)."""
    if (x.dtype != torch.float32 or x.device != dev
            or tuple(x.shape) != (n, width)
            or (width > 1 and x.stride(1) != 1)):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()} on {x.device}; the kernel takes "
                         f"float32 [{n}, {width}] rows of unit stride on "
                         f"{dev}")
    return x.data_ptr(), x.stride(0) if n > 1 else width


def _flat(x, name, dev, n, dtypes):
    """The pointer of a contiguous [n] tensor of one of ``dtypes``."""
    if (x.dtype not in dtypes or x.device != dev or tuple(x.shape) != (n,)
            or (n > 1 and x.stride(0) != 1)):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on {x.device};"
                         f" the kernel takes a contiguous [{n}] tensor of "
                         f"{'/'.join(str(t) for t in dtypes)} on {dev}")
    return x.data_ptr()


def _table(x, name, dev, dtype=torch.float32):
    if x.dtype != dtype or x.device != dev or not x.is_contiguous():
        raise ValueError(f"scene table {name}: {x.dtype} on {x.device}, "
                         f"want contiguous {dtype} on {dev}")
    return x.data_ptr()


_F32 = (torch.float32,)
_BOOL = (torch.bool,)
_I32 = (torch.int32,)


def _device(x):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the shading kernels need CUDA tensors")
    return dev


def shade_hit_cuda(scene: FlatScene, o, d, t, prim, valid, importance, light,
                   count_emission, origin_eps: float,
                   reference_compat: bool):
    """``shade_hit``'s kernel on the current stream."""
    global shade_hit_launches
    dev = _device(importance)
    n = t.shape[0]
    emission = not reference_compat
    has_env = emission and scene.has_env
    a = _ShadeHitArgs(n=n, emission=int(emission), has_env=int(has_env),
                      origin_eps=origin_eps)
    a.o, a.o_stride = _rows(o, "o", dev, n)
    a.d, a.d_stride = _rows(d, "d", dev, n)
    a.t = _flat(t, "t", dev, n, _F32)
    a.prim = _flat(prim, "prim", dev, n, _I32)
    a.shade_packed = _table(scene.shade_packed, "shade_packed", dev)
    a.num_prims = scene.shade_packed.shape[0]
    f3 = dict(dtype=torch.float32, device=dev)
    hit = S.HitRecord(
        valid=torch.empty((n,), dtype=torch.bool, device=dev),
        pt=torch.empty((n, 3), **f3), n=torch.empty((n, 3), **f3),
        dpdu=torch.empty((n, 3), **f3), dpdv=torch.empty((n, 3), **f3),
        wo_local=torch.empty((n, 3), **f3),
        bsdf=torch.empty((n,), dtype=torch.int64, device=dev),
        t=torch.empty((n,), **f3),
        backface=torch.empty((n,), dtype=torch.bool, device=dev),
    )
    (a.valid_out, a.pt, a.nrm, a.dpdu, a.dpdv, a.wo_local, a.bsdf, a.t_out,
     a.backface) = (x.data_ptr() for x in hit)
    light_out = light
    if emission:
        a.importance, a.imp_stride = _rows(importance, "importance", dev, n)
        a.light, a.light_stride = _rows(light, "light", dev, n)
        a.count_emission = _flat(count_emission, "count_emission", dev, n,
                                 _BOOL)
        a.bsdf_fn = _table(scene.bsdf_fn, "bsdf_fn", dev, torch.int32)
        a.bsdf_radiance = _table(scene.bsdf_radiance, "bsdf_radiance", dev)
        light_out = torch.empty((n, 3), **f3)
        a.light_out = light_out.data_ptr()
    if has_env:
        a.valid = _flat(valid, "valid", dev, n, _BOOL)
        a.env_map = _table(scene.env_map, "env_map", dev)
        a.env_h, a.env_w = scene.env_map.shape[:2]
    if _launch("shade_hit", a, dev):
        shade_hit_launches += 1
    return hit, light_out


def nee_prep_cuda(scene: FlatScene, hit: S.HitRecord, importance,
                  light_idx: int, u, weight: float,
                  compat_two_sided: bool = False):
    """``nee_prep``'s kernel on the current stream."""
    global nee_prep_launches
    dev = _device(importance)
    n = hit.t.shape[0]
    kind = _light_kind(scene, light_idx)
    a = _NeePrepArgs(n=n, light=light_idx, kind=kind,
                     two_sided=int(compat_two_sided and kind == LIGHT_AREA),
                     weight=weight)
    a.pt, a.pt_stride = _rows(hit.pt, "hit.pt", dev, n)
    a.nrm, a.nrm_stride = _rows(hit.n, "hit.n", dev, n)
    a.bsdf = _flat(hit.bsdf, "hit.bsdf", dev, n, (torch.int64,))
    a.valid = _flat(hit.valid, "hit.valid", dev, n, _BOOL)
    a.importance, a.imp_stride = _rows(importance, "importance", dev, n)
    a.u, a.u_stride = _rows(u, "u", dev, n, 2)
    a.bsdf_fn = _table(scene.bsdf_fn, "bsdf_fn", dev, torch.int32)
    a.bsdf_albedo = _table(scene.bsdf_albedo, "bsdf_albedo", dev)
    _light_tables(a, scene, dev, kind == LIGHT_ENV)
    f3 = dict(dtype=torch.float32, device=dev)
    wi, li = torch.empty((n, 3), **f3), torch.empty((n, 3), **f3)
    max_t = torch.empty((n,), **f3)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    a.wi, a.max_t, a.li, a.ok = (x.data_ptr() for x in (wi, max_t, li, ok))
    if _launch("nee_prep", a, dev):
        nee_prep_launches += 1
    return hit.pt, wi, max_t, li, ok


def _light_kind(scene: FlatScene, light_idx: int) -> int:
    kind = scene.light_kinds[light_idx]
    if kind not in LIGHT_KINDS:
        raise ValueError(f"nee_prep kernel: no sampler for light kind {kind}")
    return kind


def _light_tables(a, scene: FlatScene, dev, env: bool) -> None:
    """The light tables into argument block ``a``, and the environment's
    where ``env``."""
    for f in ("light_radiance", "light_position", "light_direction",
              "light_dim_x", "light_dim_y", "light_area"):
        setattr(a, f, _table(getattr(scene, f), f, dev))
    if env:
        h, w = scene.env_map.shape[:2]
        a.env_map = _table(scene.env_map, "env_map", dev)
        a.env_cdf = _table(scene.env_cdf, "env_cdf", dev)
        a.env_pdf = _table(scene.env_pdf, "env_pdf", dev)
        a.env_h, a.env_w = h, w
        # folded in double, then cast, as sample_light's Python scalar
        a.env_solid = (2.0 * math.pi / w) * (math.pi / h)


def nee_accum_cuda(light, t_s, prim_s, max_t, li_imp, ok, shadow_eps: float,
                   reference_compat: bool):
    """``nee_accum``'s kernel on the current stream."""
    global nee_accum_launches
    dev = _device(light)
    n = light.shape[0]
    a = _NeeAccumArgs(n=n, reference_compat=int(reference_compat),
                      shadow_eps=shadow_eps)
    a.light, a.light_stride = _rows(light, "light", dev, n)
    a.t_s = _flat(t_s, "t_s", dev, n, _F32)
    a.prim_s = _flat(prim_s, "prim_s", dev, n, _I32)
    a.max_t = _flat(max_t, "max_t", dev, n, _F32)
    a.li, a.li_stride = _rows(li_imp, "li_imp", dev, n)
    a.ok = _flat(ok, "ok", dev, n, _BOOL)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    a.light_out = out.data_ptr()
    if _launch("nee_accum", a, dev):
        nee_accum_launches += 1
    return out


def scatter_cuda(scene: FlatScene, hit: S.HitRecord, importance, keys, u,
                 fold: bool, rr_key, origin_eps: float,
                 hemisphere_sampling: str):
    """``scatter`` on the card: its draws, then its kernel
    (``scatter_drawn``)."""
    dev = _device(importance)
    u, u_f, u_rr = scatter_draws(keys, u, rr_key, hit.t.shape[0], dev)
    return scatter_drawn(scene, hit, importance, u, u_f, u_rr, fold,
                         origin_eps, hemisphere_sampling)


def scatter_draws(keys, u, rr_key, n: int, dev):
    """``scatter``'s uniforms as the plain version draws them, in its
    order: the hemisphere's [n, 2] from ``keys[0]`` (where ``u`` is None;
    else ``u``), the Fresnel pick's [n] from ``keys[1]``, the roulette's
    [n] from ``rr_key`` (None where the depth runs none).  Returns
    (u, u_fresnel, u_rr)."""
    k_hemi, k_fresnel = keys
    if u is None:
        u = rng.uniform(k_hemi, (n, 2), dev)
    u_f = rng.uniform(k_fresnel, (n,), dev)
    u_rr = None if rr_key is None else rng.uniform(rr_key, (n,), dev)
    return u, u_f, u_rr


def _scatter_mode(fold: bool, hemisphere_sampling: str) -> int:
    """The scatter kernel's SAMPLE_* mode, or a refusal."""
    if hemisphere_sampling not in ("uniform", "cosine"):
        raise ValueError(f"scatter kernel: no hemisphere sampling "
                         f"{hemisphere_sampling!r}")
    if fold and hemisphere_sampling != "uniform":
        raise ValueError("scatter kernel: the fold of shared directions "
                         "needs hemisphere_sampling='uniform'")
    return _SAMPLE["fold" if fold else hemisphere_sampling]


def scatter_drawn(scene: FlatScene, hit: S.HitRecord, importance, u, u_f,
                  u_rr, fold: bool, origin_eps: float,
                  hemisphere_sampling: str):
    """``scatter``'s kernel on the current stream, on its uniforms: ``u``
    [N, 2] (hemisphere, or the shared draw where ``fold``), the Fresnel
    pick's ``u_f`` [N] and the roulette's ``u_rr`` [N] (None: no
    roulette)."""
    global scatter_launches
    dev = _device(importance)
    n = hit.t.shape[0]
    a = _ScatterArgs(n=n, mode=_scatter_mode(fold, hemisphere_sampling),
                     origin_eps=origin_eps)
    a.pt, a.pt_stride = _rows(hit.pt, "hit.pt", dev, n)
    a.nrm, a.nrm_stride = _rows(hit.n, "hit.n", dev, n)
    a.dpdu, a.dpdu_stride = _rows(hit.dpdu, "hit.dpdu", dev, n)
    a.dpdv, a.dpdv_stride = _rows(hit.dpdv, "hit.dpdv", dev, n)
    a.wo_local, a.wo_stride = _rows(hit.wo_local, "hit.wo_local", dev, n)
    a.bsdf = _flat(hit.bsdf, "hit.bsdf", dev, n, (torch.int64,))
    a.valid = _flat(hit.valid, "hit.valid", dev, n, _BOOL)
    a.backface = _flat(hit.backface, "hit.backface", dev, n, _BOOL)
    a.importance, a.imp_stride = _rows(importance, "importance", dev, n)
    a.u, a.u_stride = _rows(u, "u", dev, n, 2)
    a.u_fresnel = _flat(u_f, "u_fresnel", dev, n, _F32)
    if u_rr is not None:
        a.u_rr = _flat(u_rr, "u_rr", dev, n, _F32)
    a.bsdf_fn = _table(scene.bsdf_fn, "bsdf_fn", dev, torch.int32)
    for f in ("bsdf_albedo", "bsdf_radiance", "bsdf_ior"):
        setattr(a, f, _table(getattr(scene, f), f, dev))
    f3 = dict(dtype=torch.float32, device=dev)
    o_new, d_new, imp = (torch.empty((n, 3), **f3) for _ in range(3))
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    ce = torch.empty((n,), dtype=torch.bool, device=dev)
    a.o_out, a.d_out, a.imp_out, a.valid_out, a.count_emission = (
        x.data_ptr() for x in (o_new, d_new, imp, valid, ce))
    if _launch("scatter", a, dev):
        scatter_launches += 1
    return o_new, d_new, imp, valid, ce


def _nee_draw(scene: FlatScene, nee: Nee, dev, n: int,
              reference_compat: bool) -> _NeeDraw:
    kind = _light_kind(scene, nee.light)
    k = _NeeDraw(light=nee.light, kind=kind, weight=nee.weight,
                 two_sided=int(reference_compat and kind == LIGHT_AREA))
    k.u, k.u_stride = _rows(nee.u, "u", dev, n, 2)
    return k


def shade_gap_cuda(scene: FlatScene, o, d, t, prim, importance, light, *,
                   opened=None, accum=None, sample: Optional[Nee] = None,
                   store: bool = False, scatter=None, origin_eps: float,
                   shadow_eps: float, reference_compat: bool,
                   hemisphere_sampling: str):
    """``shade_gap`` on the card: a scattering gap's draws (as
    ``scatter_cuda``'s), then its kernel (``shade_gap_drawn``)."""
    if scatter is not None:
        keys, u, fold, rr_key = scatter
        _scatter_mode(fold, hemisphere_sampling)
        scatter = (*scatter_draws(keys, u, rr_key, t.shape[0],
                                  _device(importance)), fold)
    return shade_gap_drawn(
        scene, o, d, t, prim, importance, light, opened=opened, accum=accum,
        sample=sample, store=store, scatter=scatter, origin_eps=origin_eps,
        shadow_eps=shadow_eps, reference_compat=reference_compat,
        hemisphere_sampling=hemisphere_sampling)


def shade_gap_drawn(scene: FlatScene, o, d, t, prim, importance, light, *,
                    opened=None, accum=None, sample: Optional[Nee] = None,
                    store: bool = False, scatter=None, origin_eps: float,
                    shadow_eps: float, reference_compat: bool,
                    hemisphere_sampling: str):
    """``shade_gap``'s kernel on the current stream, ``scatter`` given as
    its uniforms: (u [N, 2], u_fresnel [N], u_rr [N] or None, fold)."""
    dev = _device(importance)
    n = t.shape[0]
    variant = gap_variant(opened is not None, accum, sample is not None,
                          store, scatter is not None)
    emission = not reference_compat
    a = _GapArgs(n=n, variant=GAPS.index(variant), emission=int(emission),
                 has_env=int(emission and scene.has_env),
                 reference_compat=int(reference_compat),
                 origin_eps=origin_eps, shadow_eps=shadow_eps)
    f3 = dict(dtype=torch.float32, device=dev)
    if variant != "close_stored":
        a.o, a.o_stride = _rows(o, "o", dev, n)
        a.d, a.d_stride = _rows(d, "d", dev, n)
        a.t = _flat(t, "t", dev, n, _F32)
        a.prim = _flat(prim, "prim", dev, n, _I32)
        a.importance, a.imp_stride = _rows(importance, "importance", dev, n)
        a.shade_packed = _table(scene.shade_packed, "shade_packed", dev)
        a.num_prims = scene.shade_packed.shape[0]
        a.bsdf_fn = _table(scene.bsdf_fn, "bsdf_fn", dev, torch.int32)
        for f in ("bsdf_albedo", "bsdf_radiance", "bsdf_ior"):
            setattr(a, f, _table(getattr(scene, f), f, dev))
        _light_tables(a, scene, dev, True)
    light_out = light
    if accum is not None or (opened is not None and emission):
        a.light, a.light_stride = _rows(light, "light", dev, n)
        light_out = torch.empty((n, 3), **f3)
        a.light_out = light_out.data_ptr()
    if opened is not None and emission:
        valid, ce = opened
        a.valid = _flat(valid, "valid", dev, n, _BOOL)
        a.count_emission = _flat(ce, "count_emission", dev, n, _BOOL)
    if accum is not None:
        nee, sh, t_s, prim_s = accum
        a.t_s = _flat(t_s, "t_s", dev, n, _F32)
        a.prim_s = _flat(prim_s, "prim_s", dev, n, _I32)
        if variant == "close_stored":
            a.max_t = _flat(sh.max_t, "max_t", dev, n, _F32)
            a.li, a.li_stride = _rows(sh.li, "li", dev, n)
            a.ok = _flat(sh.ok, "ok", dev, n, _BOOL)
        else:
            a.acc = _nee_draw(scene, nee, dev, n, reference_compat)
    shadow = path = None
    if sample is not None:
        a.smp = _nee_draw(scene, sample, dev, n, reference_compat)
        s_o = torch.empty((n, 3), **f3) if opened is not None else accum[1].o
        shadow = Shadow(s_o, torch.empty((n, 3), **f3),
                        torch.empty((n,), **f3),
                        torch.empty((n,), dtype=torch.bool, device=dev),
                        torch.empty((n, 3), **f3) if store else None)
        a.s_d, a.s_max_t, a.s_ok = (x.data_ptr() for x in shadow[1:4])
        if opened is not None:
            a.s_o = s_o.data_ptr()
        if store:
            a.s_li = shadow.li.data_ptr()
    if scatter is not None:
        u, u_f, u_rr, fold = scatter
        a.mode = _scatter_mode(fold, hemisphere_sampling)
        a.u, a.u_stride = _rows(u, "u", dev, n, 2)
        a.u_fresnel = _flat(u_f, "u_fresnel", dev, n, _F32)
        if u_rr is not None:
            a.u_rr = _flat(u_rr, "u_rr", dev, n, _F32)
        path = tuple(torch.empty((n, 3), **f3) for _ in range(3)) + tuple(
            torch.empty((n,), dtype=torch.bool, device=dev) for _ in range(2))
        a.o_out, a.d_out, a.imp_out, a.valid_out, a.ce_out = (
            x.data_ptr() for x in path)
    if _launch("shade_gap", a, dev):
        counter = f"{variant}_launches"
        globals()[counter] += 1
    return light_out, shadow, path
