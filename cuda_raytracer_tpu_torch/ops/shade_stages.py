"""The shading stages of a depth as kernels: shade_hit, nee_prep,
nee_accum and scatter (+ Russian roulette).

The JAX engine compiles every stage (its per-depth jit, or one jit per
stage), and XLA fuses each stage's elementwise chain into a few loop
fusions that read each lane's inputs once.  Here each stage is one
hand-written kernel of ``ops/csrc/shade.cu`` (one thread per lane, one
pass, no temporaries in device memory).  On CUDA tensors a stage
launches its kernel or raises; on CPU tensors it runs its plain version
(``*_plain``: the op chain of ``ops/shade.py`` that the stage composes);
any other device is refused.  A configuration a kernel does not cover
raises on the card, naming it.

The draws are not part of a kernel: ``nee_prep`` takes its uniforms,
and ``scatter`` draws the hemisphere (where not given), Fresnel and
roulette uniforms through ``rng.uniform`` before its launch, with the
keys and shapes the plain version draws with, so both see the same
bits.  Each wrapper counts its launches (``*_launches``, in
``render/graphs.COUNTERS``).
"""

from __future__ import annotations

import ctypes
import math

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


_ARGS = (_ShadeHitArgs, _NeePrepArgs, _NeeAccumArgs, _ScatterArgs)


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
                               "scatter"), _ARGS):
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
    a.valid = _flat(valid, "valid", dev, n, _BOOL)
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
    kind = scene.light_kinds[light_idx]
    if kind not in LIGHT_KINDS:
        raise ValueError(f"nee_prep kernel: no sampler for light kind {kind}")
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
    for f in ("light_radiance", "light_position", "light_direction",
              "light_dim_x", "light_dim_y", "light_area"):
        setattr(a, f, _table(getattr(scene, f), f, dev))
    if kind == LIGHT_ENV:
        h, w = scene.env_map.shape[:2]
        a.env_map = _table(scene.env_map, "env_map", dev)
        a.env_cdf = _table(scene.env_cdf, "env_cdf", dev)
        a.env_pdf = _table(scene.env_pdf, "env_pdf", dev)
        a.env_h, a.env_w = h, w
        # folded in double, then cast, as sample_light's Python scalar
        a.env_solid = (2.0 * math.pi / w) * (math.pi / h)
    f3 = dict(dtype=torch.float32, device=dev)
    wi, li = torch.empty((n, 3), **f3), torch.empty((n, 3), **f3)
    max_t = torch.empty((n,), **f3)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    a.wi, a.max_t, a.li, a.ok = (x.data_ptr() for x in (wi, max_t, li, ok))
    if _launch("nee_prep", a, dev):
        nee_prep_launches += 1
    return hit.pt, wi, max_t, li, ok


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
    if hemisphere_sampling not in ("uniform", "cosine"):
        raise ValueError(f"scatter kernel: no hemisphere sampling "
                         f"{hemisphere_sampling!r}")
    if fold and hemisphere_sampling != "uniform":
        raise ValueError("scatter kernel: the fold of shared directions "
                         "needs hemisphere_sampling='uniform'")
    mode = "fold" if fold else hemisphere_sampling
    a = _ScatterArgs(n=n, mode=_SAMPLE[mode], origin_eps=origin_eps)
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
