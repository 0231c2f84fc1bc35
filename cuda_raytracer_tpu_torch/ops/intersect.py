"""Batched ray/primitive intersection tests (torch, float32).

The port of ``cuda_raytracer_tpu/ops/intersect.py``, op for op in the
same order: the AABB slab test, the plane + inside-outside triangle
test, the analytic sphere test, and ``packed_prim_test`` — the leaf test
every traversal shares.  The CUDA kernel of ops/csrc/packet_dfs.cu runs
``packed_prim_test`` line for line (built with FMA contraction off), so
the kernel and the plain version round alike.

Every function broadcasts over leading batch dimensions.  Their square
roots come from ``sqrt_rn``, which rounds as IEEE float32 ``sqrt`` on
every host, so the plain versions are bit-equal to the JAX package's.
"""

from __future__ import annotations

import torch

MISS = -1.0


def _dot(a, b):
    return (a * b).sum(-1)


def sqrt_rn(x):
    """float32 square root, rounded to nearest as IEEE 754 asks.

    On a CUDA tensor this is ``torch.sqrt`` (IEEE there: the kernels and
    the plain versions both round so).  On the CPU torch's vectorized
    ``sqrt`` is off by one ulp on some hosts (float64 too), so the root
    is taken in float64, cut to float32 and corrected: a midpoint
    between two neighbouring floats has 25 significant bits, so its
    square is exact in float64 and ``x`` past it moves the root one
    ulp.  No float32 ``x`` equals such a square, so there are no ties.
    """
    if x.is_cuda:
        return torch.sqrt(x)
    s = torch.sqrt(x.double()).float()
    lo = torch.nextafter(s, torch.full_like(s, -float("inf")))
    hi = torch.nextafter(s, torch.full_like(s, float("inf")))
    xd, sd = x.double(), s.double()
    mid_lo = (sd + lo.double()) * 0.5
    mid_hi = (sd + hi.double()) * 0.5
    s = torch.where((s > 0.0) & (xd < mid_lo * mid_lo), lo, s)
    return torch.where(xd > mid_hi * mid_hi, hi, s)


def intersect_bbox(o, d, bmin, bmax):
    """Slab test.  o, d: [..., 3]; bmin, bmax: [..., 3] broadcastable.

    Returns entry t: 0 if the origin is inside the box, -1 on a miss,
    else the positive slab entry distance (intersectBBox's contract).
    """
    inv = 1.0 / d  # IEEE inf handles axis-parallel rays
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tnear = torch.minimum(t0, t1)
    tfar = torch.maximum(t0, t1)
    tmin = tnear.amax(-1)
    tmax = tfar.amin(-1)
    inside = ((o >= bmin) & (o <= bmax)).all(-1)
    hit = tmin <= tmax
    t = torch.where(hit, tmin, MISS)
    t = torch.where(inside, 0.0, t)
    # fully-behind boxes: tmin < 0 with tmax < 0 -> miss
    return torch.where(hit & (tmax < 0.0), MISS, t)


def intersect_triangle(o, d, v0, v1, v2, eps: float = 1e-6):
    """Plane + half-plane triangle test (intersectRayTriangle
    semantics: parallel/outside/behind -> negative, else plane t)."""
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    denom = _dot(n, d)
    parallel = denom.abs() < eps
    t = (_dot(n, v0) - _dot(n, o)) / torch.where(parallel, 1.0, denom)
    p = o + t[..., None] * d
    inside = (
        (_dot(n, torch.linalg.cross(v1 - v0, p - v0)) >= 0)
        & (_dot(n, torch.linalg.cross(v2 - v1, p - v1)) >= 0)
        & (_dot(n, torch.linalg.cross(v0 - v2, p - v2)) >= 0)
    )
    ok = (~parallel) & inside & (t >= 0)
    return torch.where(ok, t, MISS)


def intersect_sphere(o, d, center, radius):
    """Quadratic sphere test; returns the nearest positive t or -1."""
    oc = o - center
    a = _dot(d, d)
    b = 2.0 * _dot(oc, d)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0
    sq = sqrt_rn(torch.where(ok, disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 > 0, t1, t2)
    return torch.where(ok & (t > 0), t, MISS)


def intersect_prim(o, d, prim_type, v0, v1, v2):
    """Tagged primitive test: triangles (type 0) and spheres (type 1,
    center in v0, radius in v1[..., 0])."""
    t_tri = intersect_triangle(o, d, v0, v1, v2)
    t_sph = intersect_sphere(o, d, v0, v1[..., 0])
    return torch.where(prim_type == 0, t_tri, t_sph)


def packed_prim_test(
    o_x, o_y, o_z, d_x, d_y, d_z,
    g_x, g_y, g_z, g_w,
    t1x, t1y, t1z, t1w, t2x, t2y, t2z, t2w,
    ptype, eps=1e-6,
):
    """The leaf test shared by every traversal, over the precomputed
    fields of flatten_scene (g = unnormalized plane normal | sphere
    center, g_w = plane offset n.v0 | radius, T1/T2 = affine
    barycentric rows).  Returns (ok, t); pad rows (type -1 or all-zero)
    never pass.  Each line matches ops/csrc/packet_dfs.cu's
    ``packed_prim_test``: keep the two in the same op order."""
    denom = g_x * d_x + g_y * d_y + g_z * d_z
    parallel = denom.abs() < eps
    t_tri = (g_w - (g_x * o_x + g_y * o_y + g_z * o_z)) / torch.where(
        parallel, 1.0, denom
    )
    hx = o_x + t_tri * d_x
    hy = o_y + t_tri * d_y
    hz = o_z + t_tri * d_z
    u = t1x * hx + t1y * hy + t1z * hz + t1w
    v = t2x * hx + t2y * hy + t2z * hz + t2w
    ok_tri = (
        (~parallel)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t_tri >= 0.0)
    )
    # sphere: center g, radius g_w, in the divide-by-2a form
    ocx, ocy, ocz = o_x - g_x, o_y - g_y, o_z - g_z
    a_q = d_x * d_x + d_y * d_y + d_z * d_z
    b_q = 2.0 * (ocx * d_x + ocy * d_y + ocz * d_z)
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - g_w * g_w
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = sqrt_rn(torch.clamp_min(disc, 0.0))
    ts1 = (-b_q - sq) / (2.0 * a_q)
    ts2 = (-b_q + sq) / (2.0 * a_q)
    t_sph = torch.where(ts1 > 0, ts1, ts2)
    ok_sph = (disc >= 0) & (t_sph > 0)

    is_sph = ptype > 0.5
    not_pad = ptype > -0.5
    ok = ((is_sph & ok_sph) | ((~is_sph) & ok_tri)) & not_pad
    t = torch.where(is_sph, t_sph, t_tri)
    return ok, t


def intersect_rows(o, d, rows):
    """packed_prim_test over prim_packed-layout rows.

    o, d: [..., 3]; rows: [..., >=22] (broadcastable) with type at col
    9 and the precomputed fields at cols 10:22.  Returns t, MISS (-1)
    on a miss.
    """
    ok, t = packed_prim_test(
        o[..., 0], o[..., 1], o[..., 2],
        d[..., 0], d[..., 1], d[..., 2],
        rows[..., 10], rows[..., 11], rows[..., 12], rows[..., 13],
        rows[..., 14], rows[..., 15], rows[..., 16], rows[..., 17],
        rows[..., 18], rows[..., 19], rows[..., 20], rows[..., 21],
        rows[..., 9],
    )
    return torch.where(ok, t, MISS)
