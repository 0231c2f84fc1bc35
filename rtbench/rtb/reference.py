"""The plain reference: the renderer's estimator, pixel by pixel.

An image of the system under test is the mean, per pixel, of
``samples_per_frame`` path samples in each frame accumulated since the
last reset.  Every sample is a function of the scene, the camera and
the frame's random draws, and the draws are counter-based: threefry2x32
(``jax.random``'s generator, which the renderer keeps bit for bit) keyed
by the render seed and the frame index, at a counter fixed by the
sample's lane.  So the reference can trace any pixel's samples on their
own, with the same draws, and needs nothing the program made: it takes
the scene's triangles, spheres, materials and lights as the benchmark
built them, intersects every ray against every primitive (no
acceleration structure), and shades in ``dtype`` (float64 for the
reference, bfloat16 for the control).  Each light's arithmetic comes
from its kind's file (``lights/<kind>.py``), handed in as ``kinds``.

The arithmetic of the stages (hit records, light sampling, scatter,
roulette, film, median) is a frozen copy of the estimator's plain
definition; the intersection is a Moller-Trumbore test of its own.
This module imports torch, numpy and math only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)

DIFFUSE, MIRROR, REFRACTION, GLASS, EMISSION = 0, 1, 2, 3, 4
KINDS = {"diffuse": DIFFUSE, "mirror": MIRROR, "refraction": REFRACTION,
         "glass": GLASS, "emission": EMISSION}


# ---------------------------------------------------------------------------
# threefry2x32 and the key tree
# ---------------------------------------------------------------------------


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """threefry2x32 of counter words (x0, x1) under ``key``: Python ints
    or int64 tensors holding values in [0, 2^32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int):
    if not 0 <= seed < 1 << 31:
        raise ValueError(f"render seed {seed} is not a non-negative int32")
    return (0, seed)


def fold_in(key, data: int):
    return threefry2x32(key, 0, int(data) & M32)


def split(key, num: int = 2):
    return [threefry2x32(key, 0, i) for i in range(num)]


def uniform_at(key, idx: torch.Tensor) -> torch.Tensor:
    """Element ``idx`` (int64) of ``jax.random.uniform(key, shape)``
    flattened: float32 in [0, 1)."""
    b0, b1 = threefry2x32(key, idx >> 32, idx & M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def frame_keys(render: Dict, num_lights: int, key) -> Dict:
    """Every key a frame draws from (the renderer's key tree)."""
    keys = {"raygen": fold_in(key, 0)}
    schedule = render["nee_schedule"]
    for depth in range(render["max_depth"]):
        num_nee = schedule[depth][0] if depth < len(schedule) else 0
        k_d = fold_in(key, 1000 + depth)
        for s in range(num_nee):
            k_s = fold_in(k_d, s)
            for li in range(num_lights):
                keys["nee", depth, s, li] = fold_in(k_s, li)
        if depth + 1 < render["max_depth"]:
            k_b = fold_in(key, 2000 + depth)
            keys["shared", depth] = fold_in(k_b, 17)
            keys["hemi", depth], keys["fresnel", depth] = split(k_b)
            keys["rr", depth] = fold_in(key, 3000 + depth)
    return keys


# ---------------------------------------------------------------------------
# sample layout
# ---------------------------------------------------------------------------


def tiles32s_rank(width: int, height: int) -> np.ndarray:
    """Pixel id -> slot rank of the sample-major 32x32-tile order (a
    partial last tile row packed densely)."""
    t = 32
    ntx = width // t
    full_rows = height // t
    py, px = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    tr = py // t
    th = np.where(tr < full_rows, t, height % t)
    rank = (tr * ntx * t * t + (px // t) * (th * t)
            + (py % t) * t + px % t)
    return rank.reshape(-1)


def lanes_of(render: Dict, pixels: np.ndarray) -> np.ndarray:
    """Lane index of each (pixel, sample) of a frame: [P, spp] int64."""
    w, h, spp = render["width"], render["height"], render["samples_per_frame"]
    s = np.arange(spp, dtype=np.int64)[None, :]
    p = np.asarray(pixels, np.int64)[:, None]
    order = render["sample_order"]
    if order == "tiles32s":
        return s * (w * h) + tiles32s_rank(w, h)[p]
    if order == "raster":
        return p * spp + s
    raise ValueError(f"sample order {order!r} has no reference layout")


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


class Scene:
    """The scene's primitives and tables as ``dtype`` tensors."""

    def __init__(self, arrays: Dict, dtype, device, kinds: Dict):
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64),  # noqa: E731
                                      device=device).to(dtype)
        self.dtype, self.device = dtype, device
        tv, tn = arrays["tri_v"], arrays["tri_n"]
        self.v0, self.v1, self.v2 = f(tv[:, 0]), f(tv[:, 1]), f(tv[:, 2])
        e1, e2 = self.v1 - self.v0, self.v2 - self.v0
        nrm = _cross(e1, e2)
        # the triangle side of each scalar product (_closest_tris)
        self.b_det = (-nrm).T.contiguous()
        self.b_u = torch.cat([e2, -_cross(e2, self.v0)], 1).T.contiguous()
        self.b_v = torch.cat([e1, -_cross(self.v0, e1)], 1).T.contiguous()
        self.b_t = torch.cat([nrm, -_dot(self.v0, nrm)[:, None]],
                             1).T.contiguous()
        self.n0, self.n1, self.n2 = f(tn[:, 0]), f(tn[:, 1]), f(tn[:, 2])
        self.sc = f(arrays["sph_c"]).reshape(-1, 3)
        self.sr = f(arrays["sph_r"]).reshape(-1)
        self.num_tris = len(tv)
        self.mat = torch.as_tensor(np.concatenate(
            [arrays["tri_m"], arrays["sph_m"]]).astype(np.int64),
            device=device)
        mats = arrays["materials"]
        self.kind = torch.tensor([KINDS[m["kind"]] for m in mats],
                                 device=device)
        z3 = [0.0, 0.0, 0.0]

        def col(key_of):
            return f(np.array([key_of(m) for m in mats], np.float64))

        # albedo: diffuse albedo, mirror reflectance, the transmittance of
        # refraction and glass; radiance: emission, glass reflectance
        self.albedo = col(lambda m: m.get(
            {"diffuse": "albedo", "mirror": "reflectance"}.get(
                m["kind"], "transmittance"), z3) if m["kind"] != "emission"
            else z3)
        self.radiance = col(lambda m: m.get(
            "radiance" if m["kind"] == "emission" else "reflectance", z3)
            if m["kind"] in ("emission", "glass") else z3)
        self.ior = col(lambda m: m.get("ior", 1.0)
                       if m["kind"] in ("refraction", "glass") else 1.0)
        # (kind's module, its tables) of each light
        self.lights = [(kinds[li["kind"]], kinds[li["kind"]].prepare(li, f))
                       for li in arrays["lights"]]

    def closest(self, o, d, valid, chunk_elems: int = 1 << 26):
        """Closest hit of each valid ray over every primitive: (t, prim),
        t = inf and prim = -1 where nothing is hit."""
        n = o.shape[0]
        t_best = torch.full((n,), math.inf, dtype=self.dtype,
                            device=self.device)
        p_best = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        rows = torch.nonzero(valid).flatten()
        if rows.numel() == 0:
            return t_best, p_best
        per = max(1, chunk_elems // max(self.num_tris, 1))
        for s in range(0, rows.numel(), per):
            r = rows[s:s + per]
            t, p = self._closest_tris(o[r], d[r])
            ts, ps = self._closest_spheres(o[r], d[r])
            better = ts < t
            t_best[r] = torch.where(better, ts, t)
            p_best[r] = torch.where(better, ps, p)
        return t_best, p_best

    def _closest_tris(self, o, d):
        """Moller-Trumbore over [rays, triangles], each scalar product
        of the test written as one matrix product over the triangles
        (s = o - v0, p = d x e2, q = s x e1, n = e1 x e2):
        det = -d.n, det*u = (o x d).e2 - d.(e2 x v0),
        det*v = (d x o).e1 - d.(v0 x e1), det*t = o.n - v0.n."""
        n = o.shape[0]
        if self.num_tris == 0:
            return (torch.full((n,), math.inf, dtype=self.dtype,
                               device=self.device),
                    torch.full((n,), -1, dtype=torch.int64,
                               device=self.device))
        one = torch.ones((n, 1), dtype=self.dtype, device=self.device)
        oxd = _cross(o, d)
        det = d @ self.b_det
        inv = 1.0 / det
        u = (torch.cat([oxd, d], 1) @ self.b_u) * inv
        v = (torch.cat([-oxd, d], 1) @ self.b_v) * inv
        t = (torch.cat([o, one], 1) @ self.b_t) * inv
        ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        del u, v, inv
        t = torch.where(ok, t, math.inf)
        tmin, arg = t.min(-1)
        return tmin, torch.where(torch.isfinite(tmin), arg, -1)

    def _closest_spheres(self, o, d):
        n = o.shape[0]
        if self.sr.numel() == 0:
            return (torch.full((n,), math.inf, dtype=self.dtype,
                               device=self.device),
                    torch.full((n,), -1, dtype=torch.int64,
                               device=self.device))
        oc = o[:, None, :] - self.sc[None]
        a = (d * d).sum(-1)[:, None]
        b = 2.0 * (oc * d[:, None, :]).sum(-1)
        c = (oc * oc).sum(-1) - self.sr[None] ** 2
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        t = torch.where(t1 > 0, t1, t2)
        t = torch.where((disc >= 0) & (t > 0), t, math.inf)
        tmin, arg = t.min(-1)
        return tmin, torch.where(torch.isfinite(tmin), arg + self.num_tris,
                                 -1)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp_min(_dot(v, v), eps))[..., None]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _hits(sc: Scene, o, d, t, prim, origin_eps):
    """Hit records: valid, pt, n, dpdu, dpdv, wo_local, material,
    backface."""
    valid = prim >= 0
    pidx = torch.clamp(prim, 0, sc.mat.numel() - 1)
    t_s = torch.where(valid, t, 1.0)
    pt_raw = o + t_s[:, None] * d
    is_sph = pidx >= sc.num_tris
    ti = torch.clamp(pidx, max=max(sc.num_tris - 1, 0))
    if sc.num_tris:
        v0, v1, v2 = sc.v0[ti], sc.v1[ti], sc.v2[ti]
        total = torch.clamp_min(torch.linalg.vector_norm(
            _cross(v0 - v1, v1 - v2), dim=-1), 1e-20)
        b_c = torch.linalg.vector_norm(
            _cross(v0 - pt_raw, v1 - pt_raw), dim=-1) / total
        b_a = torch.linalg.vector_norm(
            _cross(v1 - pt_raw, v2 - pt_raw), dim=-1) / total
        b_b = torch.linalg.vector_norm(
            _cross(v2 - pt_raw, v0 - pt_raw), dim=-1) / total
        n_tri = _norm(b_a[:, None] * sc.n0[ti] + b_b[:, None] * sc.n1[ti]
                      + b_c[:, None] * sc.n2[ti])
    else:
        n_tri = torch.zeros_like(pt_raw)
    if sc.sr.numel():
        si = torch.clamp(pidx - sc.num_tris, 0, sc.sr.numel() - 1)
        n_sph = _norm(pt_raw - sc.sc[si])
    else:
        n_sph = torch.zeros_like(pt_raw)
    n = torch.where(is_sph[:, None], n_sph, n_tri)
    backface = _dot(n, d) >= 0
    n = n * torch.where(backface, -1.0, 1.0)[:, None].to(n.dtype)
    pt = pt_raw - d * origin_eps
    use_y = (n[:, 1] < 1e-4) & (n[:, 1] > -0.999)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    guide = torch.where(use_y[:, None], eye[1], eye[0])
    dpdu = _norm(_cross(guide, n))
    dpdv = _norm(_cross(dpdu, n))
    wo = _norm(torch.stack([_dot(dpdu, -d), _dot(dpdv, -d), _dot(n, -d)],
                           dim=-1))
    return dict(valid=valid, pt=pt, n=n, dpdu=dpdu, dpdv=dpdv, wo=wo,
                mat=sc.mat[pidx], backface=backface)


def _spherical(u):
    cos_t = 2.0 * u[:, 0] - 1.0
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def _to_world(v, h):
    return v[:, 0:1] * h["dpdu"] + v[:, 1:2] * h["dpdv"] + v[:, 2:3] * h["n"]


def _scatter(sc: Scene, h, importance, u, w_shared, u_f, render):
    """Next direction and throughput of every vertex: (o, d,
    importance', valid, count_emission)."""
    n = h["n"]
    kind = sc.kind[h["mat"]]
    albedo = sc.albedo[h["mat"]]
    ior = sc.ior[h["mat"]]
    if w_shared is not None:
        d_dif = w_shared * torch.where(_dot(w_shared, n) >= 0.0, 1.0,
                                       -1.0)[:, None].to(n.dtype)
        thr_dif = albedo * (2.0 * _dot(d_dif, n).abs())[:, None]
    else:
        s = _spherical(u)
        loc = torch.stack([s[:, 0], s[:, 1], s[:, 2].abs()], dim=-1)
        d_dif = _to_world(loc, h)
        thr_dif = albedo * (2.0 * _dot(d_dif, n).abs())[:, None]
    wo = h["wo"]
    d_mir = _to_world(torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1), h)
    cos_o = torch.clamp(wo[:, 2], 1e-6, 1.0)
    eta = torch.where(h["backface"], ior, 1.0 / ior)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_o * cos_o, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    d_refr = _to_world(torch.stack([-eta * wo[:, 0], -eta * wo[:, 1],
                                    -cos_t], -1), h)
    d_refr = torch.where(tir[:, None], d_mir, d_refr)
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    x = 1.0 - cos_o
    fres = torch.where(tir, 1.0, r0 + (1.0 - r0) * x ** 5)
    reflect = u_f < fres
    scale = torch.where(tir, 1.0, eta * eta)[:, None]
    d_glass = torch.where(reflect[:, None], d_mir, d_refr)
    thr_glass = torch.where(reflect[:, None], sc.radiance[h["mat"]],
                            albedo * scale)
    thr_refr = torch.where(tir[:, None], albedo, albedo * scale)
    k3 = kind[:, None]
    d_new = torch.where(k3 == DIFFUSE, d_dif, torch.where(
        k3 == MIRROR, d_mir, torch.where(k3 == REFRACTION, d_refr, d_glass)))
    thr = torch.where(k3 == DIFFUSE, thr_dif, torch.where(
        k3 == MIRROR, albedo, torch.where(k3 == REFRACTION, thr_refr,
                                          thr_glass)))
    emit = kind == EMISSION
    thr = torch.where(emit[:, None], 0.0, thr)
    imp = importance * thr
    transmit = (((kind == REFRACTION) & ~tir)
                | ((kind == GLASS) & ~reflect & ~tir))
    eps = render["origin_eps"]
    o_new = h["pt"] + torch.where(transmit[:, None], -eps * n, eps * n)
    valid = h["valid"] & ~emit & (imp.amax(-1) > 0)
    delta = (kind == MIRROR) | (kind == REFRACTION) | (kind == GLASS)
    return o_new, d_new, imp, valid, delta


class Reference:
    """Traces chosen pixels of a camera's frames with the renderer's
    estimator (``render``: the render settings of the workload;
    ``kinds``: the module of each light kind, by name)."""

    def __init__(self, arrays: Dict, render: Dict, kinds: Dict,
                 dtype=torch.float64, device="cpu"):
        if render.get("reference_compat") or \
                render["hemisphere_sampling"] != "uniform":
            raise ValueError("the reference follows the uniform hemisphere "
                             "and no reference_compat")
        self.render = render
        self.dtype = dtype
        self.device = torch.device(device)
        self.scene = Scene(arrays, dtype, self.device, kinds)
        self.num_lights = len(self.scene.lights)

    def _draw(self, key, lanes, per_row, granule=1):
        """The [lanes, per_row] uniforms of rows lane // granule."""
        rows = lanes // granule
        if per_row == 1:
            return uniform_at(key, rows).to(self.dtype)
        idx = rows[:, None] * per_row + torch.arange(per_row,
                                                     device=rows.device)
        return uniform_at(key, idx).to(self.dtype)

    def camera_rays(self, key, lanes, pixels, camera):
        """Pinhole rays of the lanes (pixel of each lane given)."""
        r = self.render
        w, h = r["width"], r["height"]
        u = self._draw(key, lanes, 2)
        px = (pixels % w).to(self.dtype)
        py = (pixels // w).to(self.dtype)
        x = (px + u[:, 0]) / w
        y = (py + u[:, 1]) / h
        sx = (2.0 * x - 1.0) * camera["tan_half_h"]
        sy = (1.0 - 2.0 * y) * camera["tan_half_v"]
        c2w = torch.as_tensor(camera["c2w"], device=self.device).to(
            self.dtype)
        d = _norm(sx[:, None] * c2w[:, 0] + sy[:, None] * c2w[:, 1]
                  - c2w[:, 2])
        o = torch.as_tensor(camera["pos"], device=self.device).to(
            self.dtype).expand(d.shape)
        return o, d

    def radiance(self, frame_index: int, camera: Dict, pixels: np.ndarray
                 ) -> torch.Tensor:
        """Each pixel's mean over the frame's samples: [P, 3]."""
        r, sc = self.render, self.scene
        spp = r["samples_per_frame"]
        n_total = r["width"] * r["height"] * spp
        g = r["rng_granule"]
        if g > 1 and n_total % g:
            raise ValueError("rng_granule does not divide the lanes")
        lanes_np = lanes_of(r, pixels).reshape(-1)
        lanes = torch.as_tensor(lanes_np, device=self.device)
        pix = torch.as_tensor(np.repeat(np.asarray(pixels, np.int64), spp),
                              device=self.device)
        keys = frame_keys(r, self.num_lights,
                          fold_in(prng_key(r["seed"]), frame_index))
        o, d = self.camera_rays(keys["raygen"], lanes, pix, camera)
        n = lanes.numel()
        dt, dev = self.dtype, self.device
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        importance = torch.ones((n, 3), dtype=dt, device=dev)
        light = torch.zeros((n, 3), dtype=dt, device=dev)
        count_emission = torch.ones((n,), dtype=torch.bool, device=dev)
        schedule = r["nee_schedule"]
        for depth in range(r["max_depth"]):
            t, prim = sc.closest(o, d, valid)
            prim = torch.where(valid, prim, -1)
            h = _hits(sc, o, d, t, prim, r["origin_eps"])
            kind = sc.kind[h["mat"]]
            emit = h["valid"] & count_emission & (kind == EMISSION)
            light = light + torch.where(emit[:, None],
                                        importance * sc.radiance[h["mat"]],
                                        0.0)
            miss = valid & (prim < 0) & count_emission
            for mod, lt in sc.lights:
                if hasattr(mod, "escaped"):
                    light = light + torch.where(
                        miss[:, None], importance * mod.escaped(lt, d), 0.0)
            num_nee, weight = (schedule[depth] if depth < len(schedule)
                               else (0, 0.0))
            for s in range(num_nee):
                for li, (mod, lt) in enumerate(sc.lights):
                    u = self._draw(keys["nee", depth, s, li], lanes, 2, g)
                    le, wi, dist = mod.sample(lt, h["pt"], u)
                    cos_surf = _dot(h["n"], wi).abs()
                    li_imp = (importance * sc.albedo[h["mat"]]
                              * (cos_surf[:, None] / math.pi) * le * weight)
                    ok = (h["valid"] & (kind == DIFFUSE) & (dist > 1e-2)
                          & (cos_surf > 1e-2))
                    max_t = torch.clamp_max(dist, 1e30)
                    t_s, _ = sc.closest(h["pt"], wi, ok)
                    passes = t_s > max_t - r["shadow_eps"]
                    light = light + torch.where((ok & passes)[:, None],
                                                li_imp, 0.0)
            if depth + 1 < r["max_depth"]:
                w_shared = u = None
                if g > 1:
                    u = self._draw(keys["shared", depth], lanes, 2, g)
                    if r["rng_fold_dirs"] and \
                            r["hemisphere_sampling"] == "uniform":
                        w_shared = _spherical(u)
                else:
                    u = self._draw(keys["hemi", depth], lanes, 2)
                u_f = self._draw(keys["fresnel", depth], lanes, 1)
                o, d, importance, valid, count_emission = _scatter(
                    sc, h, importance, u, w_shared, u_f, r)
                rr = r["rr_start_depth"]
                if rr and depth + 1 >= rr:
                    p = torch.clamp(importance.amax(-1), 0.05, 1.0)
                    u_rr = self._draw(keys["rr", depth], lanes, 1)
                    valid = valid & (u_rr < p)
                    importance = importance / p[:, None]
        return light.reshape(-1, spp, 3).mean(1)

    def image(self, frames: Sequence[Tuple[int, Dict]], pixels: np.ndarray,
              median: bool = False) -> torch.Tensor:
        """The accumulated image at ``pixels`` after ``frames`` ((frame
        index, camera) each, one camera since the reset): [P, 3]; with
        ``median`` the 3x3 median (edges clamped) of that image."""
        pixels = np.asarray(pixels, np.int64)
        if not median:
            acc = sum(self.radiance(fi, cam, pixels) for fi, cam in frames)
            return acc / len(frames)
        w, h = self.render["width"], self.render["height"]
        py, px = pixels // w, pixels % w
        nb = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nb.append(np.clip(py + dy, 0, h - 1) * w
                          + np.clip(px + dx, 0, w - 1))
        nb = np.stack(nb, 1)  # [P, 9]
        uniq, inv = np.unique(nb.reshape(-1), return_inverse=True)
        img = self.image(frames, uniq)
        vals = img[torch.as_tensor(inv, device=self.device)].reshape(
            len(pixels), 9, 3)
        return torch.sort(vals, dim=1).values[:, 4, :]


def camera_of(origin, look_at, hfov_deg: float, vfov_deg: float) -> Dict:
    """A pinhole camera at ``origin`` looking at ``look_at`` (world up
    +y): position, camera-to-world columns (x, y, backward z), and the
    half-angle tangents."""
    origin = np.asarray(origin, np.float64)
    z = origin - np.asarray(look_at, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return {"pos": origin, "c2w": np.stack([x, y, z], axis=1),
            "tan_half_h": math.tan(math.radians(hfov_deg) / 2),
            "tan_half_v": math.tan(math.radians(vfov_deg) / 2)}


def scene_arrays_of(meshes: List[Dict], spheres: List[Dict],
                    materials: List[Dict], lights: List[Dict]) -> Dict:
    """The reference's view of a built scene: per-triangle vertex and
    normal arrays, spheres, materials by index and lights."""
    tv, tn, tm = [], [], []
    for m in meshes:
        idx = np.asarray(m["indices"], np.int64)
        tv.append(np.asarray(m["positions"], np.float64)[idx])
        tn.append(np.asarray(m["normals"], np.float64)[idx])
        tm.append(np.full(len(idx), m["material"], np.int64))
    return {
        "tri_v": np.concatenate(tv) if tv else np.zeros((0, 3, 3)),
        "tri_n": np.concatenate(tn) if tn else np.zeros((0, 3, 3)),
        "tri_m": np.concatenate(tm) if tm else np.zeros((0,), np.int64),
        "sph_c": np.array([s["center"] for s in spheres], np.float64),
        "sph_r": np.array([s["radius"] for s in spheres], np.float64),
        "sph_m": np.array([s["material"] for s in spheres], np.int64),
        "materials": materials,
        "lights": lights,
    }
