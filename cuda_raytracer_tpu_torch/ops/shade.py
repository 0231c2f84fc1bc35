"""Shading ops: camera ray generation, hit records, next-event estimation
and BSDF scatter sampling (torch, float32).

The port of ``cuda_raytracer_tpu/ops/shade.py``, function for function
and in the same op order.  Random draws come from the port's threefry
(``rng``), so with the same key both packages draw the same numbers.
Every function is dense over the ray dimension; BSDF dispatch computes
all lobes and selects by tag.

The camera rays are a kernel on the card (``ops/csrc/raygen.cu``: the
pixel, the draw and the direction in one pass): on a CUDA device
``generate_camera_rays`` and ``generate_camera_rays_cutracer`` launch it
or raise; on the CPU they run their plain versions (``*_plain``, the op
chains below); any other device is refused.  ``raygen_launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
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
from ..scene.bsdf import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    BSDF_GLASS,
    BSDF_MIRROR,
    BSDF_REFRACTION,
)

INF = float("inf")

#: launches of the camera rays' kernel (ops/csrc/raygen.cu) since the
#: count was last set to 0
raygen_launches = 0


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp_min(_dot(v, v), eps))[..., None]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _where3(c, a, b):
    return torch.where(c[:, None], a, b)


# ---------------------------------------------------------------------------
# camera rays
# ---------------------------------------------------------------------------


def _pix_from_slot(pix, width, height, pix_order):
    """Map sample-slot pixel index -> actual pixel id ("tiles8" /
    "tiles32s" closed-form tile arithmetic, an index tensor, or None
    for raster order)."""
    if pix_order is None:
        return pix
    if isinstance(pix_order, str):
        if pix_order == "tiles8":
            tx_count = width // 8
            tile, within = pix // 64, pix % 64
            ty, tx = tile // tx_count, tile % tx_count
            py = ty * 8 + within // 8
            px = tx * 8 + within % 8
            return py * width + px
        if pix_order != "tiles32s":
            raise ValueError(f"unknown pix_order {pix_order!r}")
        # 32x32-pixel tiles; a partial last tile row (height % 32) is
        # packed densely so the rank is a bijection onto [0, W*H)
        t = 32
        ntx = width // t
        full_rows = height // t
        rem = height % t
        q_full_end = full_rows * ntx * t * t
        tr_f = pix // (ntx * t * t)
        w_f = pix % (ntx * t * t)
        tx_f, v_f = w_f // (t * t), w_f % (t * t)
        py_f = tr_f * t + v_f // t
        px_f = tx_f * t + v_f % t
        if rem == 0:
            return py_f * width + px_f
        q2 = pix - q_full_end
        cells = rem * t
        tx_p, v_p = q2 // cells, q2 % cells
        py_p = full_rows * t + v_p // t
        px_p = tx_p * t + v_p % t
        in_full = pix < q_full_end
        py = torch.where(in_full, py_f, py_p)
        px = torch.where(in_full, px_f, px_p)
        return py * width + px
    return pix_order[pix]


def tiles8_rank(width: int, height: int) -> np.ndarray:
    """Pixel-id -> slot-rank table for sample_order='tiles8'."""
    t = 8
    py, px = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    rank = ((py // t) * (width // t) * t * t
            + (px // t) * t * t + (py % t) * t + (px % t))
    return rank.reshape(-1)


def tiles32s_rank(width: int, height: int) -> np.ndarray:
    """Pixel-id -> slot-rank table for sample_order='tiles32s'."""
    t = 32
    ntx = width // t
    full_rows = height // t
    py, px = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    tr = py // t
    th = np.where(tr < full_rows, t, height % t)
    rank = (tr * ntx * t * t + (px // t) * (th * t)
            + (py % t) * t + px % t)
    return rank.reshape(-1)


def _raygen_path(device) -> str:
    """The camera rays' path for ``device`` (None: torch's default):
    "cuda" or "cpu"."""
    dev = (torch.device(device) if device is not None
           else torch.get_default_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no camera rays path for device {dev}")
    return dev.type


def generate_camera_rays(
    key,
    width: int,
    height: int,
    spp: int,
    cam_pos,
    cam_c2w,
    tan_half_h: float,
    tan_half_v: float,
    pix_order=None,
    row_offset: int = 0,
    full_height: int = None,
    device=None,
):
    """Jittered pinhole camera rays (see the JAX function for the sample
    layouts).  ``cam_pos`` [3] and ``cam_c2w`` [3, 3] are arrays, or
    float32 tensors on ``device`` (a captured frame's camera buffer,
    which a move rewrites).  Returns (o, d) [N, 3] float32 on
    ``device``: o the camera position's stride-0 expand."""
    args = (key, width, height, spp, cam_pos, cam_c2w, tan_half_h,
            tan_half_v, pix_order, row_offset, full_height, device)
    if _raygen_path(device) == "cuda":
        return generate_camera_rays_cuda(*args)
    return generate_camera_rays_plain(*args)


def generate_camera_rays_plain(
    key,
    width: int,
    height: int,
    spp: int,
    cam_pos,
    cam_c2w,
    tan_half_h: float,
    tan_half_v: float,
    pix_order=None,
    row_offset: int = 0,
    full_height: int = None,
    device=None,
):
    """``generate_camera_rays`` in torch ops (any device)."""
    n = width * height * spp
    if full_height is None:
        full_height = height
    i = torch.arange(n, dtype=torch.int64, device=device)
    pslot = i % (width * height) if pix_order == "tiles32s" else i // spp
    pix = _pix_from_slot(pslot, width, height, pix_order)
    px = (pix % width).float()
    py = (pix // width).float() + float(row_offset)
    u = rng.uniform(key, (n, 2), device)
    x = (px + u[:, 0]) / width
    y = (py + u[:, 1]) / full_height
    sx = (2.0 * x - 1.0) * float(np.float32(tan_half_h))
    sy = (1.0 - 2.0 * y) * float(np.float32(tan_half_v))  # row 0 = top
    c2w = _on_device(cam_c2w, device)
    # d_cam @ c2w.T with d_cam = (sx, sy, -1), written out per component
    d = _norm(sx[:, None] * c2w[:, 0] + sy[:, None] * c2w[:, 1]
              - c2w[:, 2])
    o = _on_device(cam_pos, device).expand(d.shape)
    return o, d


def _on_device(x, device):
    """A camera array as float32 on ``device``; a tensor is taken as it
    is (no copy from the host: a captured frame reads its buffer)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device)


def generate_camera_rays_cutracer(
    key,
    width: int,
    height: int,
    spp: int,
    origin,
    look_at,
    up,
    left,
    pix_order=None,
    device=None,
):
    """Reference-compat camera rays: the fixed +-0.5 frustum over the
    cutracer basis (origin/look_at/up/left; see the JAX function).  The
    sample layouts are generate_camera_rays'.  The four vectors are
    arrays, or float32 tensors on ``device`` (as generate_camera_rays'
    camera).  Returns (o, d) [N, 3] float32 on ``device``."""
    args = (key, width, height, spp, origin, look_at, up, left, pix_order,
            device)
    if _raygen_path(device) == "cuda":
        return generate_camera_rays_cutracer_cuda(*args)
    return generate_camera_rays_cutracer_plain(*args)


def generate_camera_rays_cutracer_plain(
    key,
    width: int,
    height: int,
    spp: int,
    origin,
    look_at,
    up,
    left,
    pix_order=None,
    device=None,
):
    """``generate_camera_rays_cutracer`` in torch ops (any device)."""
    n = width * height * spp
    i = torch.arange(n, dtype=torch.int64, device=device)
    pslot = i % (width * height) if pix_order == "tiles32s" else i // spp
    pix = _pix_from_slot(pslot, width, height, pix_order)
    px = (pix % width).float()
    py = (pix // width).float()
    u = rng.uniform(key, (n, 2), device)
    xs = (px + u[:, 0]) / width
    ys = (py + u[:, 1]) / height
    k = _norm(torch.stack([xs - 0.5, ys - 0.5, torch.ones_like(xs)], dim=-1))
    basis = torch.stack([_on_device(v, device) for v in (left, up, look_at)])
    # k @ basis over the rows (left, up, look_at), written out per
    # component
    d = (k[:, 0:1] * basis[0] + k[:, 1:2] * basis[1]
         + k[:, 2:3] * basis[2])
    return _on_device(origin, device).expand(d.shape), d


# ---------------------------------------------------------------------------
# the camera rays' kernel (ops/csrc/raygen.cu)
# ---------------------------------------------------------------------------

#: raygen.cu's sample orders: None (raster), "tiles8", "tiles32s", and an
#: index table
_ORDER = {None: 0, "tiles8": 1, "tiles32s": 2}
_ORDER_TABLE = 3

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_U = ctypes.c_uint32


class _Div(ctypes.Structure):
    """raygen.cu's Div: a divisor and its magic pair (``_div``)."""
    _fields_ = [("d", _U), ("m", _U), ("s", _U)]


def _div(d: int) -> _Div:
    """d with (m, s) such that n // d == ((2n * m) >> 32) >> s for every
    0 <= n < 2^31: s = ceil(log2 d), m = ceil(2^(31 + s) / d) < 2^32.
    Exact: e = m * d - 2^(31 + s) < d <= 2^s, so n * m / 2^(31 + s) =
    n / d + n * e / (d * 2^(31 + s)) adds less than 1 / d to n / d.  A
    divisor of 0 (an order's unused one) gives zeros."""
    if d <= 0:
        return _Div(0, 0, 0)
    s = (d - 1).bit_length()
    return _Div(d, -(-(1 << (31 + s)) // d), s)


class _RaygenArgs(ctypes.Structure):
    _fields_ = [
        ("n", _L), ("kp0", _P), ("kp1", _P), ("cam0", _P), ("cam1", _P),
        ("cam2", _P), ("table", _P), ("d", _P), ("h0", _U), ("h1", _U),
        ("width", _I), ("height", _I), ("spp", _I),
        ("full_height", _I), ("row_offset", _I), ("order", _I),
        ("cutracer", _I), ("tan_h", _F), ("tan_v", _F),
        ("lane_div", _Div), ("pix_div", _Div), ("part_div", _Div),
        ("q_full_end", _U), ("part_y0", _U),
    ]


def _layout(a, width, height, spp):
    """The divisors of block ``a``'s order (its ``order`` set), from the
    static shape alone: a captured graph replays them."""
    if a.order == _ORDER["tiles32s"]:
        full = height // 32
        a.lane_div = _div(width * height)
        a.pix_div = _div(width // 32 * 1024)
        a.part_div = _div(32 * (height % 32))
        a.q_full_end, a.part_y0 = full * (width // 32) * 1024, 32 * full
    else:
        a.lane_div = _div(spp)
        a.pix_div = _div(width // 8 if a.order == _ORDER["tiles8"]
                         else width)


_lib = None


def _load_library():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("raygen")
        lib.raygen_args_size.restype = ctypes.c_longlong
        size = lib.raygen_args_size()
        if size != ctypes.sizeof(_RaygenArgs):
            raise RuntimeError(f"raygen.cu: RaygenArgs is {size} bytes, its "
                               f"ctypes mirror {ctypes.sizeof(_RaygenArgs)}")
        lib.raygen.argtypes = [ctypes.POINTER(_RaygenArgs), ctypes.c_void_p]
        lib.raygen.restype = ctypes.c_int
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


def _cuda_device(device):
    dev = (torch.device(device) if device is not None
           else torch.get_default_device())
    if dev.type != "cuda":
        raise ValueError("the camera rays' kernel needs a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _camera(x, name, dev, shape):
    """A camera array as a contiguous float32 tensor of ``shape`` on
    ``dev``: an array is copied there, a tensor (the captured frame's
    camera buffer) is taken as it is and must already be one."""
    t = _on_device(x, dev)
    if (t.dtype != torch.float32 or t.device != dev
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"camera {name}: {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}; the kernel takes contiguous float32 "
                         f"{list(shape)} on {dev}")
    return t


def _raygen_launch(key, width, height, spp, pix_order, dev, a):
    """Fill the sample layout and key of block ``a``, launch it and
    return d [N, 3]."""
    global raygen_launches
    n = width * height * spp
    if n >= 1 << 31:
        raise ValueError(f"{n} camera rays: the kernel takes fewer than "
                         "2^31")
    a.n, a.width, a.height, a.spp = n, width, height, spp
    if isinstance(pix_order, torch.Tensor):
        table = pix_order
        if (table.dtype != torch.int64 or table.device != dev
                or tuple(table.shape) != (width * height,)
                or not table.is_contiguous()):
            raise ValueError(f"pix_order: {table.dtype} "
                             f"{tuple(table.shape)} on {table.device}; the "
                             f"kernel takes a contiguous int64 "
                             f"[{width * height}] on {dev}")
        a.order, a.table = _ORDER_TABLE, table.data_ptr()
    elif pix_order in _ORDER:
        a.order = _ORDER[pix_order]
        # the tile orders' bijections, which the kernel's closed forms
        # assume (RenderConfig asks the same)
        tile = {"tiles8": 8, "tiles32s": 32}.get(pix_order, 1)
        if width % tile:
            raise ValueError(f"pix_order {pix_order!r}: the kernel takes "
                             f"a width that is a multiple of {tile}, not "
                             f"{width}")
    else:
        raise ValueError(f"unknown pix_order {pix_order!r}")
    _layout(a, width, height, spp)
    a.kp0, a.kp1, a.h0, a.h1 = rng._key_words(key, dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    a.d = d.data_ptr()
    if _launch("raygen", a, dev):
        raygen_launches += 1
    return d


def generate_camera_rays_cuda(
    key,
    width: int,
    height: int,
    spp: int,
    cam_pos,
    cam_c2w,
    tan_half_h: float,
    tan_half_v: float,
    pix_order=None,
    row_offset: int = 0,
    full_height: int = None,
    device=None,
):
    """``generate_camera_rays``' kernel on the current stream.  The key
    and the camera are read on the device when the kernel runs."""
    dev = _cuda_device(device)
    pos = _camera(cam_pos, "pos", dev, (3,))
    c2w = _camera(cam_c2w, "c2w", dev, (3, 3))
    a = _RaygenArgs(cam0=c2w.data_ptr(), row_offset=row_offset,
                    full_height=height if full_height is None
                    else full_height,
                    tan_h=float(np.float32(tan_half_h)),
                    tan_v=float(np.float32(tan_half_v)))
    d = _raygen_launch(key, width, height, spp, pix_order, dev, a)
    return pos.expand(d.shape), d


def generate_camera_rays_cutracer_cuda(
    key,
    width: int,
    height: int,
    spp: int,
    origin,
    look_at,
    up,
    left,
    pix_order=None,
    device=None,
):
    """``generate_camera_rays_cutracer``'s kernel on the current
    stream."""
    dev = _cuda_device(device)
    pos = _camera(origin, "origin", dev, (3,))
    vecs = [_camera(v, name, dev, (3,)) for v, name in
            ((left, "left"), (up, "up"), (look_at, "look_at"))]
    a = _RaygenArgs(cutracer=1, full_height=height)
    a.cam0, a.cam1, a.cam2 = (v.data_ptr() for v in vecs)
    d = _raygen_launch(key, width, height, spp, pix_order, dev, a)
    return pos.expand(d.shape), d


# ---------------------------------------------------------------------------
# hit records
# ---------------------------------------------------------------------------


class HitRecord(NamedTuple):
    valid: torch.Tensor  # [N] bool
    pt: torch.Tensor  # [N, 3] hit point (offset back along the ray)
    n: torch.Tensor  # [N, 3] shading normal (flipped toward -d)
    dpdu: torch.Tensor  # [N, 3] tangent frame
    dpdv: torch.Tensor
    wo_local: torch.Tensor  # [N, 3] outgoing dir in the local frame
    bsdf: torch.Tensor  # [N] int64 BSDF index
    t: torch.Tensor  # [N]
    #: True when the geometric normal faced away from the ray
    backface: torch.Tensor  # [N] bool


def make_frame(n):
    """Tangent frame from the shading normal (guide = y unless the
    normal is near-horizontal-down, then x)."""
    use_y_guide = (n[..., 1] < 1e-4) & (n[..., 1] > -0.999)
    # the guides as rows of an identity made on the device: no copy from
    # the host, which a captured frame may not make
    gx, gy = torch.eye(3, dtype=n.dtype, device=n.device)[:2]
    guide = torch.where(use_y_guide[..., None], gy, gx)
    dpdu = _norm(_cross(guide, n))
    dpdv = _norm(_cross(dpdu, n))
    return dpdu, dpdv


def compute_hits(scene: FlatScene, o, d, t, prim,
                 origin_eps: float = 1e-3) -> HitRecord:
    """Shading records from trace results.  The JAX package chunks very
    large lane counts (its TPU layout pads [N, 3] temporaries to 128
    lanes); Hopper has no such padding, so this is the unchunked form."""
    valid = prim >= 0
    pidx = torch.clamp(prim, 0, scene.num_prims - 1).long()
    t_s = torch.where(valid, t, 1.0)
    pt_raw = o + t_s[:, None] * d

    row = scene.shade_packed[pidx]
    v0 = row[:, 0:3]
    v1 = row[:, 3:6]
    v2 = row[:, 6:9]
    is_sphere = row[:, 9] > 0.5
    n0_, n1_, n2_ = row[:, 10:13], row[:, 13:16], row[:, 16:19]
    bsdf_idx = row[:, 19].long()

    # triangle: barycentric vertex-normal interpolation
    total = torch.linalg.vector_norm(_cross(v0 - v1, v1 - v2), dim=-1)
    total = torch.clamp_min(total, 1e-20)
    bC = torch.linalg.vector_norm(
        _cross(v0 - pt_raw, v1 - pt_raw), dim=-1) / total
    bA = torch.linalg.vector_norm(
        _cross(v1 - pt_raw, v2 - pt_raw), dim=-1) / total
    bB = torch.linalg.vector_norm(
        _cross(v2 - pt_raw, v0 - pt_raw), dim=-1) / total
    n_tri = _norm(bA[:, None] * n0_ + bB[:, None] * n1_ + bC[:, None] * n2_)

    n_sph = _norm(pt_raw - v0)

    n = _where3(is_sphere, n_sph, n_tri)
    backface = _dot(n, d) >= 0
    n = n * torch.where(backface, -1.0, 1.0)[:, None]

    pt = pt_raw - d * origin_eps

    dpdu, dpdv = make_frame(n)
    wo_local = _norm(
        torch.stack([_dot(dpdu, -d), _dot(dpdv, -d), _dot(n, -d)], dim=-1)
    )
    return HitRecord(
        valid=valid, pt=pt, n=n, dpdu=dpdu, dpdv=dpdv, wo_local=wo_local,
        bsdf=bsdf_idx, t=torch.where(valid, t, INF), backface=backface,
    )


# ---------------------------------------------------------------------------
# next-event estimation
# ---------------------------------------------------------------------------


def sample_light(scene: FlatScene, light_idx: int, pt, u):
    """Sample one light toward the shading points.

    Returns (Le_over_pdf [N,3], wi [N,3], dist [N])."""
    lt = scene.light_kinds[light_idx]
    rad = scene.light_radiance[light_idx]
    full = lambda v: torch.full(pt.shape[:1], v, device=pt.device)  # noqa: E731
    if lt == LIGHT_AREA:
        pos = scene.light_position[light_idx]
        ldir = scene.light_direction[light_idx]
        dx = scene.light_dim_x[light_idx]
        dy = scene.light_dim_y[light_idx]
        area = scene.light_area[light_idx]
        lpt = pos + (u[:, 0:1] - 0.5) * dx + (u[:, 1:2] - 0.5) * dy
        dvec = lpt - pt
        cos_theta = _dot(dvec, ldir)
        sq = torch.clamp_min(_dot(dvec, dvec), 1e-12)
        dist = torch.sqrt(sq)
        wi = dvec / dist[:, None]
        pdf = sq / (area * torch.clamp_min(cos_theta.abs(), 1e-8))
        # one-sided: emits only where cos(theta) < 0
        le = torch.where((cos_theta < 0)[:, None], rad, 0.0)
        return le / pdf[:, None], wi, dist
    if lt == LIGHT_POINT:
        dvec = scene.light_position[light_idx] - pt
        dist = torch.sqrt(torch.clamp_min(_dot(dvec, dvec), 1e-12))
        return rad.expand(pt.shape), dvec / dist[:, None], dist
    if lt == LIGHT_DIRECTIONAL:
        wi = scene.light_direction[light_idx].expand(pt.shape)
        return rad.expand(pt.shape), wi, full(INF)
    if lt == LIGHT_HEMISPHERE:
        z = u[:, 0]
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = 2.0 * math.pi * u[:, 1]
        wi = torch.stack([r * torch.cos(phi), z, r * torch.sin(phi)], dim=-1)
        return rad.expand(pt.shape) * (2.0 * math.pi), wi, full(INF)
    if lt == LIGHT_SPOT:
        ldir = scene.light_direction[light_idx]
        angle = scene.light_area[light_idx]  # radians, full cone
        dvec = scene.light_position[light_idx] - pt
        dist = torch.sqrt(torch.clamp_min(_dot(dvec, dvec), 1e-12))
        wi = dvec / dist[:, None]
        inside = _dot(-wi, ldir) >= torch.cos(angle / 2)
        return torch.where(inside[:, None], rad, 0.0), wi, dist
    if lt == LIGHT_ENV:
        h, w, _ = scene.env_map.shape
        idx = torch.clamp(
            torch.searchsorted(scene.env_cdf, u[:, 0].contiguous()),
            0, h * w - 1,
        )
        iy = idx // w
        ix = idx % w
        theta = (iy.float() + 0.5) / h * math.pi
        phi = (ix.float() + 0.5) / w * 2.0 * math.pi
        st_ = torch.sin(theta)
        wi = torch.stack(
            [st_ * torch.cos(phi), torch.cos(theta), st_ * torch.sin(phi)],
            dim=-1,
        )
        solid = (2.0 * math.pi / w) * (math.pi / h) * torch.clamp_min(st_, 1e-8)
        pdf = torch.clamp_min(scene.env_pdf[idx] / solid, 1e-12)
        le = scene.env_map.reshape(h * w, 3)[idx]
        return le / pdf[:, None], wi, full(INF)
    raise ValueError(f"unknown light type {lt}")


def env_radiance(scene: FlatScene, d) -> torch.Tensor:
    """Environment radiance along (unit) world directions d [N,3]."""
    h, w, _ = scene.env_map.shape
    theta = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0))
    phi = torch.remainder(torch.atan2(d[:, 2], d[:, 0]), 2.0 * math.pi)
    iy = torch.clamp((theta / math.pi * h).long(), 0, h - 1)
    ix = torch.clamp((phi / (2.0 * math.pi) * w).long(), 0, w - 1)
    return scene.env_map[iy, ix]


def env_miss_radiance(scene: FlatScene, d, importance, miss, count_emission):
    """Radiance for escaped rays on counted paths."""
    ok = miss & count_emission
    return torch.where(ok[:, None], importance * env_radiance(scene, d), 0.0)


def nee_shadow_rays(
    scene: FlatScene,
    hit: HitRecord,
    importance,
    light_idx: int,
    u,
    weight: float,
    compat_two_sided: bool = False,
):
    """One NEE shadow ray per path vertex.  Returns (o, d, maxT,
    light_importance, valid); only diffuse vertices contribute."""
    le_over_pdf, wi, dist = sample_light(scene, light_idx, hit.pt, u)
    if compat_two_sided and scene.light_kinds[light_idx] == LIGHT_AREA:
        rad = scene.light_radiance[light_idx]
        ldir = scene.light_direction[light_idx]
        lpt = hit.pt + wi * dist[:, None]
        cos_theta = _dot(lpt - hit.pt, ldir)
        sq = torch.clamp_min(dist * dist, 1e-12)
        pdf = sq / (scene.light_area[light_idx]
                    * torch.clamp_min(cos_theta.abs(), 1e-8))
        le_over_pdf = rad.expand(hit.pt.shape) / pdf[:, None]

    fn = scene.bsdf_fn[hit.bsdf]
    albedo = scene.bsdf_albedo[hit.bsdf]
    cos_surf = _dot(hit.n, wi).abs()
    li = (importance * albedo * (cos_surf[:, None] / math.pi) * le_over_pdf
          * weight)
    ok = (
        hit.valid
        & (fn == BSDF_DIFFUSE)
        & (dist > 1e-2)
        & (cos_surf > 1e-2)
    )
    li = torch.where(ok[:, None], li, 0.0)
    # infinite light distances -> the finite no-limit sentinel
    max_t = torch.clamp_max(dist, 1e30)
    return hit.pt, wi, max_t, li, ok


# ---------------------------------------------------------------------------
# BSDF scatter
# ---------------------------------------------------------------------------


def _local_to_world(v_local, dpdu, dpdv, n):
    return (v_local[..., 0:1] * dpdu + v_local[..., 1:2] * dpdv
            + v_local[..., 2:3] * n)


def _spherical_sample(u):
    """Uniform sphere sample via theta = acos(2u-1)."""
    cos_t = 2.0 * u[:, 0] - 1.0
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1
    )


def _pow5(x):
    # x ** 5 as XLA's integer_pow computes it: x * (x^2)^2
    x2 = x * x
    return x * (x2 * x2)


def scatter(
    scene: FlatScene,
    hit: HitRecord,
    importance,
    key,
    origin_eps: float = 1e-3,
    hemisphere_sampling: str = "uniform",
    u=None,
    w_shared=None,
    split_keys=None,
):
    """Sample the next path direction at every vertex (diffuse, mirror,
    refraction, glass).  ``u``: optional [N, 2] hemisphere uniforms;
    ``w_shared``: optional [N, 3] uniform-sphere directions folded into
    each lane's hemisphere (d = sign(dot(w, n)) * w); ``split_keys``:
    split(key), the (hemisphere, fresnel) keys, where the caller holds
    them already (a frame's key table; ``key`` is then unused).  Returns
    (o, d, importance', valid, count_emission)."""
    n = hit.n
    dev = n.device
    dpdu, dpdv = hit.dpdu, hit.dpdv
    fn = scene.bsdf_fn[hit.bsdf]
    albedo = scene.bsdf_albedo[hit.bsdf]
    ior = scene.bsdf_ior[hit.bsdf]

    k_hemi, k_fresnel = rng.split(key) if split_keys is None else split_keys
    if u is None and w_shared is None:
        u = rng.uniform(k_hemi, (n.shape[0], 2), dev)

    # ---- diffuse ----
    if w_shared is not None:
        if hemisphere_sampling != "uniform":
            raise ValueError(
                "w_shared (folded shared directions) requires "
                "hemisphere_sampling='uniform'"
            )
        d_dif = w_shared * torch.where(_dot(w_shared, n) >= 0.0, 1.0,
                                       -1.0)[:, None]
        thr_dif = albedo * (2.0 * _dot(d_dif, n).abs())[:, None]
    elif hemisphere_sampling == "cosine":
        r = torch.sqrt(u[:, 0])
        phi = 2.0 * math.pi * u[:, 1]
        d_local_dif = torch.stack(
            [r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(1.0 - u[:, 0])],
            dim=-1,
        )
        thr_dif = albedo
        d_dif = _local_to_world(d_local_dif, dpdu, dpdv, n)
    else:
        s = _spherical_sample(u)
        d_local_dif = torch.stack([s[:, 0], s[:, 1], s[:, 2].abs()], dim=-1)
        d_dif = _local_to_world(d_local_dif, dpdu, dpdv, n)
        thr_dif = albedo * (2.0 * _dot(d_dif, n).abs())[:, None]

    # ---- mirror ----
    wo = hit.wo_local
    d_local_mir = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
    d_mir = _local_to_world(d_local_mir, dpdu, dpdv, n)
    thr_mir = albedo

    # ---- refraction / glass (a backface hit means the ray exits) ----
    cos_o = torch.clamp(wo[:, 2], 1e-6, 1.0)
    eta = torch.where(hit.backface, ior, 1.0 / ior)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_o * cos_o, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    d_local_ref = torch.stack(
        [-eta * wo[:, 0], -eta * wo[:, 1], -cos_t], dim=-1
    )
    d_refr = _local_to_world(d_local_ref, dpdu, dpdv, n)
    d_refr = _where3(tir, d_mir, d_refr)

    # Fresnel (Schlick) for the glass lobe choice
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    fres = r0 + (1.0 - r0) * _pow5(1.0 - cos_o)
    fres = torch.where(tir, 1.0, fres)
    pick_reflect = rng.uniform(k_fresnel, tuple(fres.shape), dev) < fres

    radiance_scale = torch.where(tir, 1.0, eta * eta)[:, None]
    d_glass = _where3(pick_reflect, d_mir, d_refr)
    thr_glass = _where3(
        pick_reflect, scene.bsdf_radiance[hit.bsdf], albedo * radiance_scale
    )
    thr_refr = _where3(tir, albedo, albedo * radiance_scale)

    # ---- select by tag ----
    fn3 = fn[:, None]
    d_new = torch.where(
        fn3 == BSDF_DIFFUSE, d_dif,
        torch.where(fn3 == BSDF_MIRROR, d_mir,
                    torch.where(fn3 == BSDF_REFRACTION, d_refr, d_glass)),
    )
    thr = torch.where(
        fn3 == BSDF_DIFFUSE, thr_dif,
        torch.where(fn3 == BSDF_MIRROR, thr_mir,
                    torch.where(fn3 == BSDF_REFRACTION, thr_refr, thr_glass)),
    )
    is_delta = ((fn == BSDF_MIRROR) | (fn == BSDF_REFRACTION)
                | (fn == BSDF_GLASS))
    # emitters terminate the path
    is_emit = fn == BSDF_EMISSION
    thr = torch.where(is_emit[:, None], 0.0, thr)

    importance_new = importance * thr
    # transmissive lobes offset through the surface
    transmit = (
        ((fn == BSDF_REFRACTION) & (~tir))
        | ((fn == BSDF_GLASS) & (~pick_reflect) & (~tir))
    )
    offs = torch.where(transmit[:, None], -origin_eps * hit.n,
                       origin_eps * hit.n)
    o_new = hit.pt + offs
    valid_new = (hit.valid & (~is_emit)
                 & (importance_new.amax(-1) > 0))
    return o_new, d_new, importance_new, valid_new, is_delta


def emission_at_hits(scene: FlatScene, hit: HitRecord, importance,
                     count_emission):
    """Radiance added when a counted path hits an emissive surface."""
    rad = scene.bsdf_radiance[hit.bsdf]
    is_emit = scene.bsdf_fn[hit.bsdf] == BSDF_EMISSION
    ok = hit.valid & count_emission & is_emit
    return torch.where(ok[:, None], importance * rad, 0.0)

