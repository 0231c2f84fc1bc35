"""Flat device scene.

The port of ``cuda_raytracer_tpu/render/flatscene.py``: the static scene
is flattened into dense float32/int32 SoA tables — primitives in
BVH-sorted order, a tagged BSDF table, a light table and the flat wide
BVH with the packet-DFS tables — built in numpy exactly as the JAX
package builds them, then handed to the device as torch tensors.

``FlatScene``/``FlatBVH`` are dataclasses of tensors; their static
metadata (levels, schedules, light kinds) stays plain Python tuples.
``from_jax_arrays`` rebuilds a scene from the JAX package's own tables
(``np.asarray`` of each leaf), so both packages can trace the same
tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accel.bvh import BVHAccel
from ..accel.wide import build_flat_wide_bvh
from ..device import resolve_device
from ..scene import static_scene as st
from ..scene.bsdf import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    BSDF_GLASS,
    BSDF_MIRROR,
    BSDF_REFRACTION,
    DiffuseBSDF,
    EmissionBSDF,
    GlassBSDF,
    MirrorBSDF,
    RefractionBSDF,
)

# primitive type tags
PRIM_TRI = 0
PRIM_SPHERE = 1

# light type tags
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_HEMISPHERE = 3
LIGHT_SPOT = 4
LIGHT_ENV = 5


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass
class FlatBVH:
    """Wide-BVH tables (see the JAX package's FlatBVH for each layout)."""

    outlets: torch.Tensor  # [N, W] int32, -1 = none
    child_min: torch.Tensor  # [N, W, 3] f32
    child_max: torch.Tensor  # [N, W, 3] f32
    leaf_start: torch.Tensor  # [N] int32
    leaf_range: torch.Tensor  # [N] int32 (>0 iff leaf)
    #: [cmin[W,3], cmax[W,3], outlets as f32, leaf_start, leaf_range,
    #: child_is_leaf flags] = 8W+2 f32, zero-padded to 128 columns
    node_packed: torch.Tensor  # [N, 128] f32
    #: packet-DFS node rows: one 128-col row per child slot, 8 per node,
    #: in BFS node numbering; cols [mnx mny mnz mxx mxy mxz grp0 ngroups]
    #: (grp0/ngroups on leaf-child slots; dead slots carry inverted boxes)
    node_dfs: torch.Tensor  # [8*Nd, 128] f32
    #: packet-DFS prim groups: 8 prims per row, 16 f32 fields each
    #: [g.xyz, g.w, T1.xyzw, T2.xyzw, type, orig_id, pad, pad]
    prim_groups: torch.Tensor  # [G, 128] f32
    #: per node [inner_base, inner_count, leaf_grp0, leaf_count]
    node_meta: torch.Tensor  # [4*Nd] i32
    # static metadata
    levels: Tuple[Tuple[int, ...], ...]
    level_child_valid: Tuple[Tuple[bool, ...], ...]
    level_is_leaf: Tuple[Tuple[bool, ...], ...]
    level_inner: Tuple[int, ...]
    level_leaf: Tuple[int, ...]
    width: int
    max_leaf: int
    root_is_leaf: bool
    wf_sched: Tuple = ()

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @functools.cached_property
    def dfs_node_rows(self) -> torch.Tensor:
        """The first 8 columns of node_dfs, contiguous ([8*Nd, 8]): the
        part of a child row the DFS kernel reads, one 32-byte sector."""
        return self.node_dfs[:, :8].contiguous()

    @property
    def dfs_prim_rows(self) -> torch.Tensor:
        """prim_groups as one 16-field row per prim ([8*G, 16] view)."""
        return self.prim_groups.view(-1, 16)

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(
            self,
            **{f.name: _to(getattr(self, f.name), device)
               for f in dataclasses.fields(self)},
        )


@dataclasses.dataclass
class FlatScene:
    """Complete device scene."""

    # primitives, BVH-sorted
    prim_type: torch.Tensor  # [P] int32
    v0: torch.Tensor  # [P, 3] f32 (sphere: center)
    v1: torch.Tensor  # [P, 3] f32 (sphere: [radius, 0, 0])
    v2: torch.Tensor  # [P, 3] f32
    n0: torch.Tensor  # [P, 3] f32 vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    prim_bsdf: torch.Tensor  # [P] int32

    # BSDF table
    bsdf_fn: torch.Tensor  # [B] int32
    bsdf_albedo: torch.Tensor  # [B, 3] f32
    bsdf_radiance: torch.Tensor  # [B, 3] f32
    bsdf_ior: torch.Tensor  # [B] f32

    # light table
    light_type: torch.Tensor  # [L] int32
    light_radiance: torch.Tensor  # [L, 3] f32
    light_position: torch.Tensor  # [L, 3] f32
    light_direction: torch.Tensor  # [L, 3] f32
    light_dim_x: torch.Tensor  # [L, 3] f32
    light_dim_y: torch.Tensor  # [L, 3] f32
    light_area: torch.Tensor  # [L] f32

    #: [v0.xyz, v1.xyz, v2.xyz, type, g.xyz, g.w, T1.xyzw, T2.xyzw]
    #: (22 of 128 columns), the shared precomputed intersection fields
    prim_packed: torch.Tensor  # [P + max_leaf + 8, 128] f32
    #: [v0.xyz v1.xyz v2.xyz type n0.xyz n1.xyz n2.xyz bsdf pad...]
    shade_packed: torch.Tensor  # [P, 32] f32

    bvh: FlatBVH

    env_map: torch.Tensor  # [H, W, 3] f32
    env_cdf: torch.Tensor  # [H*W] f32
    env_pdf: torch.Tensor  # [H*W] f32

    num_lights: int
    light_kinds: Tuple[int, ...]
    has_env: bool

    #: the K largest-area prims (prim_packed cols 0:22 + orig id)
    seed_rows: Optional[torch.Tensor] = None  # [K, 24] f32

    @property
    def num_prims(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "FlatScene":
        kw = {f.name: _to(getattr(self, f.name), device)
              for f in dataclasses.fields(self)}
        kw["bvh"] = self.bvh.to(device)
        return dataclasses.replace(self, **kw)


_BVH_STATIC = (
    "levels", "level_child_valid", "level_is_leaf", "level_inner",
    "level_leaf", "width", "max_leaf", "root_is_leaf", "wf_sched",
)
_SCENE_STATIC = ("num_lights", "light_kinds", "has_env")
_INT_FIELDS = {
    "prim_type", "prim_bsdf", "bsdf_fn", "light_type", "bvh.outlets",
    "bvh.leaf_start", "bvh.leaf_range", "bvh.node_meta",
}


def _bsdf_record(b) -> Tuple[int, np.ndarray, np.ndarray, float]:
    if isinstance(b, DiffuseBSDF):
        return BSDF_DIFFUSE, b.albedo, np.zeros(3), 1.0
    if isinstance(b, MirrorBSDF):
        return BSDF_MIRROR, b.reflectance, np.zeros(3), 1.0
    if isinstance(b, RefractionBSDF):
        return BSDF_REFRACTION, b.transmittance, np.zeros(3), b.ior
    if isinstance(b, GlassBSDF):
        # albedo slot carries transmittance; reflectance folded via ior
        return BSDF_GLASS, b.transmittance, b.reflectance, b.ior
    if isinstance(b, EmissionBSDF):
        return BSDF_EMISSION, np.zeros(3), b.radiance, 1.0
    raise TypeError(f"unsupported BSDF {type(b)}")


def _build_wf_schedule(flat) -> Tuple:
    """Static per-level segment schedule for the fused wavefront kernels.

    Segments are the *inner* nodes of each level, in level (= preorder)
    order; leaf children are intersected inline at their parent's
    segment, so leaf nodes never become segments.  Returns a tuple over
    levels of (seg_nodes, child_kind, child_pair, child_lstart,
    child_lcnt, child_forced) flat int tuples.
    """
    W = flat.width
    leaf_range = flat.leaf_range
    leaf_start = flat.leaf_start
    outlets = flat.outlets

    if leaf_range[0] > 0:  # root is a leaf: one virtual segment
        kind = [2] + [0] * (W - 1)
        return ((
            (0,),
            tuple(kind),
            tuple([-1] * W),
            tuple([int(leaf_start[0])] + [0] * (W - 1)),
            tuple([int(leaf_range[0])] + [0] * (W - 1)),
            tuple([1] + [0] * (W - 1)),
        ),)

    sched = []
    inner_per_level = [
        [int(n) for n in lv if leaf_range[n] == 0] for lv in flat.levels
    ]
    for lvl, inner in enumerate(inner_per_level):
        if not inner:
            break
        nxt = (
            {n: i for i, n in enumerate(inner_per_level[lvl + 1])}
            if lvl + 1 < len(inner_per_level)
            else {}
        )
        kinds, pairs, lstarts, lcnts = [], [], [], []
        for n in inner:
            for w in range(W):
                o = int(outlets[n, w])
                if o < 0:
                    kinds.append(0)
                    pairs.append(-1)
                    lstarts.append(0)
                    lcnts.append(0)
                elif leaf_range[o] > 0:
                    kinds.append(2)
                    pairs.append(-1)
                    lstarts.append(int(leaf_start[o]))
                    lcnts.append(int(leaf_range[o]))
                else:
                    kinds.append(1)
                    pairs.append(nxt[o])
                    lstarts.append(0)
                    lcnts.append(0)
        sched.append((
            tuple(inner),
            tuple(kinds),
            tuple(pairs),
            tuple(lstarts),
            tuple(lcnts),
            tuple([0] * (len(inner) * W)),
        ))
    return tuple(sched)


def _dfs_tables(flat, g_vec, g_w, t1_row, t2_row, ptype_o):
    """The packet-DFS tables (node_dfs, node_meta, prim_groups).

    The DFS numbers nodes in BFS order (so the inner children of any
    node are consecutive) and orders prims so each node's direct
    leaf-child prims form one contiguous "leaf run":

    * node_dfs [8*Nd, 128] f32: one row per child slot, 8 per node,
      cols [mnx mny mnz mxx mxy mxz grp0 ngroups]; child w of node n is
      row 8n+w, inner children first, then leaf children (whose rows
      carry their 8-aligned prim-group run in cols 6-7); dead slots get
      inverted boxes.
    * node_meta [4*Nd] i32: per node [inner_base, inner_count,
      leaf_grp0, leaf_count]; inner child ids are
      inner_base..inner_base+inner_count-1.
    * prim_groups [G, 128] f32: 8 prims per row, 16 fields each
      [g.xyz, g.w, T1.xyzw, T2.xyzw, type, orig_id, pad, pad] in
      leaf-run order; pad prims have type -1; orig_id maps back to the
      BVH-sorted prim arrays.
    """
    w = flat.width
    outl = flat.outlets
    lr_all = flat.leaf_range
    ls_all = flat.leaf_start

    if w > 8:
        # a node block is 8 child rows; wider trees have no DFS tables
        return (np.zeros((8, 128), np.float32),
                np.full((4,), -1, np.int32),
                np.zeros((1, 128), np.float32))

    if lr_all[0] > 0:
        # degenerate single-leaf tree: one pseudo-node whose only slot is
        # an always-hit box over the whole root leaf run
        is_root_leaf_dfs = True
        bfs = np.zeros(1, np.int64)
    else:
        is_root_leaf_dfs = False
        # BFS over inner nodes, children in slot order
        frontier = np.zeros(1, np.int64)
        lvls = [frontier]
        while True:
            ch = outl[frontier].reshape(-1)
            ch = ch[ch >= 0]
            ch = ch[lr_all[ch] == 0].astype(np.int64)
            if len(ch) == 0:
                break
            lvls.append(ch)
            frontier = ch
        bfs = np.concatenate(lvls)
    Nd = len(bfs)

    blk = np.zeros((Nd, 8, 128), np.float32)
    blk[:, :, 0:3] = 1e30  # dead slots: inverted boxes always miss
    blk[:, :, 3:6] = -1e30
    meta = np.zeros((Nd, 4), np.int64)

    if is_root_leaf_dfs:
        ln = np.zeros(1, np.int64)  # leaf child -> bfs node
        pos_l = np.zeros(1, np.int64)  # leaf child -> slot position
        leaf_lo = np.asarray([int(ls_all[0])], np.int64)
        leaf_cnt = np.asarray([int(lr_all[0])], np.int64)
        box_lmin = np.full((1, 3), -3e30)
        box_lmax = np.full((1, 3), 3e30)
        nl_per = np.ones(1, np.int64)
    else:
        outl_b = outl[bfs]  # [Nd, W]
        validc = outl_b >= 0
        ch_clip = np.clip(outl_b, 0, None)
        leaf_mask = validc & (lr_all[ch_clip] > 0)
        inner_mask = validc & ~leaf_mask
        ni = inner_mask.sum(axis=1).astype(np.int64)
        nl_per = leaf_mask.sum(axis=1).astype(np.int64)
        cmin_b = flat.child_min[bfs]
        cmax_b = flat.child_max[bfs]

        # slot positions: inner children first (slot order), then leaf
        # children (slot order)
        inn, inw = np.nonzero(inner_mask)  # row-major
        pos_i = (np.cumsum(inner_mask, axis=1) - 1)[inn, inw]
        blk[inn, pos_i, 0:3] = cmin_b[inn, inw]
        blk[inn, pos_i, 3:6] = cmax_b[inn, inw]

        ln, lw = np.nonzero(leaf_mask)  # row-major = emit order
        pos_l = ni[ln] + (np.cumsum(leaf_mask, axis=1) - 1)[ln, lw]
        lids = outl_b[ln, lw]
        leaf_lo = ls_all[lids].astype(np.int64)
        leaf_cnt = lr_all[lids].astype(np.int64)
        box_lmin = cmin_b[ln, lw]
        box_lmax = cmax_b[ln, lw]

        # inner-child BFS ids in discovery order = 1 + running inner count
        first_inner = 1 + np.concatenate(([0], np.cumsum(ni)[:-1]))
        meta[:, 0] = np.where(ni > 0, first_inner, 0)
        meta[:, 1] = ni

    # 8-aligned prim groups per leaf child, in emit (row-major) order;
    # pad prims get type -1 (never hit)
    ngr = (leaf_cnt + 7) // 8
    G = int(ngr.sum())
    gstart = np.concatenate(([0], np.cumsum(ngr)))[:-1]
    if G:
        grp_leaf = np.repeat(np.arange(len(ngr)), ngr)
        base = leaf_lo[grp_leaf] + 8 * (np.arange(G) - gstart[grp_leaf])
        idx = base[:, None] + np.arange(8)
        vmask = idx < (leaf_lo + leaf_cnt)[grp_leaf][:, None]
        idx_c = np.where(vmask, idx, 0)
        m3 = vmask[:, :, None]
        pg = np.zeros((G, 8, 16), np.float32)
        pg[:, :, 0:3] = np.where(m3, g_vec[idx_c], 0.0)
        pg[:, :, 3] = np.where(vmask, g_w[idx_c], 0.0)
        pg[:, :, 4:8] = np.where(m3, t1_row[idx_c], 0.0)
        pg[:, :, 8:12] = np.where(m3, t2_row[idx_c], 0.0)
        pg[:, :, 12] = np.where(vmask, ptype_o[idx_c], -1.0)
        pg[:, :, 13] = np.where(vmask, idx, 0.0)
        pg_flat = pg.reshape(G, 128)
    else:
        pg_flat = np.zeros((1, 128), np.float32)
    # 4 guard rows, as the JAX package's table has (its leaf DMAs fetch
    # 4-row batches); kept so the two tables stay equal
    prim_groups = np.concatenate([pg_flat, np.zeros((4, 128), np.float32)])

    # leaf slots carry (grp0, ngroups); per-node leaf job = (first leaf
    # child's grp0, total groups)
    blk[ln, pos_l, 0:3] = box_lmin
    blk[ln, pos_l, 3:6] = box_lmax
    blk[ln, pos_l, 6] = gstart
    blk[ln, pos_l, 7] = ngr
    if len(ngr):
        first_leaf = np.concatenate(([0], np.cumsum(nl_per)[:-1]))
        meta[:, 2] = np.where(
            nl_per > 0, gstart[np.minimum(first_leaf, len(ngr) - 1)], 0
        )
        meta[:, 3] = np.bincount(
            ln, weights=ngr, minlength=Nd
        ).astype(np.int64)

    return (blk.reshape(Nd * 8, 128), meta.reshape(-1).astype(np.int32),
            prim_groups)


def _lights(scene: st.Scene):
    lt, lrad, lpos, ldir, ldx, ldy, larea = [], [], [], [], [], [], []
    z3 = np.zeros(3)
    for light in scene.lights:
        if isinstance(light, st.AreaLight):
            rec = (LIGHT_AREA, light.radiance, light.position,
                   light.direction, light.dim_x, light.dim_y, light.area)
        elif isinstance(light, st.PointLight):
            rec = (LIGHT_POINT, light.radiance, light.position, z3, z3, z3,
                   0.0)
        elif isinstance(light, st.DirectionalLight):
            rec = (LIGHT_DIRECTIONAL, light.radiance, z3, light.dirToLight,
                   z3, z3, 0.0)
        elif isinstance(light, st.InfiniteHemisphereLight):
            rec = (LIGHT_HEMISPHERE, light.radiance, z3, z3, z3, z3, 0.0)
        elif isinstance(light, st.SpotLight):
            rec = (LIGHT_SPOT, light.radiance, light.position,
                   light.direction, z3, z3, float(light.angle))
        elif isinstance(light, st.EnvironmentLight):
            rec = (LIGHT_ENV, np.ones(3), z3, z3, z3, z3, 0.0)
        else:  # MeshLight is empty in the reference (light.cpp:107-113)
            continue
        for acc, v in zip((lt, lrad, lpos, ldir, ldx, ldy, larea), rec):
            acc.append(v)
    num_device_lights = len(lt)
    if not lt:  # keep shapes static with one dead light
        lt, lrad, lpos, ldir, ldx, ldy, larea = (
            [LIGHT_POINT], [z3], [z3], [z3], [z3], [z3], [0.0]
        )
    return num_device_lights, lt, lrad, lpos, ldir, ldx, ldy, larea


def flatten_tables(
    scene: st.Scene,
    tree_width: int = 4,
    max_leaf_size: int = 32,
    sah_bins: int = 12,
) -> Tuple[Dict[str, np.ndarray], Dict, BVHAccel]:
    """The numpy tables of flatten_scene: (fields, static, bvh).

    ``fields`` maps each array field name to a float32/int32 array
    (``bvh.<name>`` for the FlatBVH fields), ``static`` each static
    field likewise — the format ``from_jax_arrays`` takes."""
    tri_v: List[np.ndarray] = []
    tri_n: List[np.ndarray] = []
    tri_bsdf: List[np.ndarray] = []
    sph_c: List[np.ndarray] = []
    sph_r: List[float] = []
    sph_bsdf: List[int] = []

    bsdfs: List = []

    def bsdf_index(b) -> int:
        for i, x in enumerate(bsdfs):
            if x is b:
                return i
        bsdfs.append(b)
        return len(bsdfs) - 1

    for obj in scene.objects:
        if isinstance(obj, st.Mesh):
            if obj.num_triangles() == 0:
                continue
            v, n = obj.triangle_arrays()
            tri_v.append(v)
            tri_n.append(n)
            tri_bsdf.append(
                np.full(len(v), bsdf_index(obj.get_bsdf()), np.int32)
            )
        elif isinstance(obj, st.SphereObject):
            sph_c.append(obj.o)
            sph_r.append(obj.r)
            sph_bsdf.append(bsdf_index(obj.get_bsdf()))

    T = sum(len(v) for v in tri_v)
    S = len(sph_c)
    P = T + S
    if P == 0:
        raise ValueError("scene has no primitives")
    if P >= 1 << 24:
        # the traversal carries primitive indices as exact f32 integers
        raise ValueError(
            f"scene has {P} primitives; the float32-payload traversal "
            f"supports at most 2^24-1 (= 16,777,215)"
        )

    v0 = np.zeros((P, 3), np.float64)
    v1 = np.zeros((P, 3), np.float64)
    v2 = np.zeros((P, 3), np.float64)
    n0 = np.zeros((P, 3), np.float64)
    n1 = np.zeros((P, 3), np.float64)
    n2 = np.zeros((P, 3), np.float64)
    ptype = np.zeros(P, np.int32)
    pbsdf = np.zeros(P, np.int32)

    if T:
        tv = np.concatenate(tri_v)
        tn = np.concatenate(tri_n)
        v0[:T], v1[:T], v2[:T] = tv[:, 0], tv[:, 1], tv[:, 2]
        n0[:T], n1[:T], n2[:T] = tn[:, 0], tn[:, 1], tn[:, 2]
        pbsdf[:T] = np.concatenate(tri_bsdf)
    if S:
        ptype[T:] = PRIM_SPHERE
        v0[T:] = np.stack(sph_c)
        v1[T:, 0] = np.asarray(sph_r)
        pbsdf[T:] = np.asarray(sph_bsdf, np.int32)

    # primitive bounds: padded triangle bbox / sphere bbox
    is_tri = (ptype == PRIM_TRI)[:, None]
    pmin = np.where(
        is_tri, np.minimum(np.minimum(v0, v1), v2) - st.Triangle.PADDING,
        v0 - v1[:, :1],
    )
    pmax = np.where(
        is_tri, np.maximum(np.maximum(v0, v1), v2) + st.Triangle.PADDING,
        v0 + v1[:, :1],
    )

    bvh = BVHAccel(pmin, pmax, max_leaf_size=max_leaf_size, sah_bins=sah_bins)
    order = bvh.get_sorted_order()
    flat = build_flat_wide_bvh(bvh, tree_width)

    # precomputed intersection fields, in f64 then cast to f32: the
    # unnormalized plane normal, the plane offset n.v0 and the two
    # barycentric affine rows (u = r1.p + t1w, r1 = (e2 x n)/|n|^2;
    # v likewise with r2 = (n x e1)/|n|^2); degenerate triangles get
    # zero rows, whose zero normal trips the parallel cut
    ptype_o = ptype[order]
    v0o, v1o, v2o = v0[order], v1[order], v2[order]
    e1_ = v1o - v0o
    e2_ = v2o - v0o
    nrm_ = np.cross(e1_, e2_)
    det_ = (nrm_ * nrm_).sum(1)
    safe_ = det_ > 0.0
    inv_det = 1.0 / np.where(safe_, det_, 1.0)
    r1_ = np.where(safe_[:, None], np.cross(e2_, nrm_) * inv_det[:, None], 0.0)
    r2_ = np.where(safe_[:, None], np.cross(nrm_, e1_) * inv_det[:, None], 0.0)
    is_sph_o = ptype_o == PRIM_SPHERE
    g_vec = np.where(is_sph_o[:, None], v0o, nrm_).astype(np.float32)
    g_w = np.where(is_sph_o, v1o[:, 0], (nrm_ * v0o).sum(1)).astype(np.float32)
    t1_row = np.concatenate(
        [r1_, -(r1_ * v0o).sum(1)[:, None]], axis=1
    ).astype(np.float32)
    t2_row = np.concatenate(
        [r2_, -(r2_ * v0o).sum(1)[:, None]], axis=1
    ).astype(np.float32)
    t1_row[is_sph_o] = 0.0
    t2_row[is_sph_o] = 0.0

    # BSDF table
    B = max(len(bsdfs), 1)
    bfn = np.zeros(B, np.int32)
    balbedo = np.zeros((B, 3), np.float64)
    brad = np.zeros((B, 3), np.float64)
    bior = np.ones(B, np.float64)
    for i, b in enumerate(bsdfs):
        bfn[i], balbedo[i], brad[i], bior[i] = _bsdf_record(b)

    num_device_lights, lt, lrad, lpos, ldir, ldx, ldy, larea = _lights(scene)

    env_light = next(
        (l for l in scene.lights if isinstance(l, st.EnvironmentLight)), None
    )
    if env_light is not None:
        env_map, env_pdf, env_cdf = (
            env_light.envmap, env_light._pdf, env_light._cdf
        )
    else:
        env_map, env_pdf, env_cdf = np.zeros((1, 1, 3)), np.ones(1), np.ones(1)

    w = flat.width
    child_clipped = np.clip(flat.outlets, 0, len(flat.outlets) - 1)
    child_is_leaf = (flat.leaf_range[child_clipped] > 0) & (flat.outlets >= 0)
    node_packed = np.concatenate(
        [
            flat.child_min.reshape(-1, 3 * w),
            flat.child_max.reshape(-1, 3 * w),
            flat.outlets.astype(np.float32),
            flat.leaf_start[:, None].astype(np.float32),
            flat.leaf_range[:, None].astype(np.float32),
            child_is_leaf.astype(np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    pad_cols = (-node_packed.shape[1]) % 128
    if pad_cols:
        node_packed = np.concatenate(
            [node_packed, np.zeros((len(node_packed), pad_cols), np.float32)],
            axis=1,
        )
    node_dfs, node_meta, prim_groups = _dfs_tables(
        flat, g_vec, g_w, t1_row, t2_row, ptype_o
    )

    # packed prim rows, padded to 128 columns with max_leaf_size + 8
    # degenerate rows appended (the JAX package's layout, kept equal)
    prim_packed = np.zeros((P + max_leaf_size + 8, 128), np.float32)
    prim_packed[:P, 0:3] = v0o
    prim_packed[:P, 3:6] = v1o
    prim_packed[:P, 6:9] = v2o
    prim_packed[:P, 9] = ptype_o
    prim_packed[:P, 10:13] = g_vec
    prim_packed[:P, 13] = g_w
    prim_packed[:P, 14:18] = t1_row
    prim_packed[:P, 18:22] = t2_row

    shade_packed = np.zeros((P, 32), np.float32)
    shade_packed[:, 0:3] = v0o
    shade_packed[:, 3:6] = v1o
    shade_packed[:, 6:9] = v2o
    shade_packed[:, 9] = ptype_o
    shade_packed[:, 10:13] = n0[order]
    shade_packed[:, 13:16] = n1[order]
    shade_packed[:, 16:19] = n2[order]
    shade_packed[:, 19] = pbsdf[order]

    # seed rows: the K largest-area prims, BVH-order ids
    tri_area = 0.5 * np.sqrt(det_)
    sph_area = np.pi * v1o[:, 0] ** 2
    area = np.where(ptype_o == 0, tri_area, sph_area)
    K = int(min(32, P))
    seed_ids = np.argsort(-area, kind="stable")[:K]
    seed_rows = np.zeros((max(K, 1), 24), np.float32)
    if K:
        seed_rows[:, 0:22] = prim_packed[seed_ids, 0:22]
        seed_rows[:, 22] = seed_ids.astype(np.float32)

    fields = {
        "prim_type": ptype_o,
        "v0": v0o, "v1": v1o, "v2": v2o,
        "n0": n0[order], "n1": n1[order], "n2": n2[order],
        "prim_bsdf": pbsdf[order],
        "bsdf_fn": bfn, "bsdf_albedo": balbedo, "bsdf_radiance": brad,
        "bsdf_ior": bior,
        "light_type": lt,
        "light_radiance": np.stack(lrad),
        "light_position": np.stack(lpos),
        "light_direction": np.stack(ldir),
        "light_dim_x": np.stack(ldx),
        "light_dim_y": np.stack(ldy),
        "light_area": larea,
        "prim_packed": prim_packed,
        "shade_packed": shade_packed,
        "env_map": env_map, "env_cdf": env_cdf, "env_pdf": env_pdf,
        "seed_rows": seed_rows,
        "bvh.outlets": flat.outlets,
        "bvh.child_min": flat.child_min,
        "bvh.child_max": flat.child_max,
        "bvh.leaf_start": flat.leaf_start,
        "bvh.leaf_range": flat.leaf_range,
        "bvh.node_packed": node_packed,
        "bvh.node_dfs": node_dfs,
        "bvh.prim_groups": prim_groups,
        "bvh.node_meta": node_meta,
    }
    fields = {
        k: np.asarray(v, np.int32 if k in _INT_FIELDS else np.float32)
        for k, v in fields.items()
    }
    static = {
        "num_lights": num_device_lights,
        "light_kinds": tuple(int(t) for t in lt),
        "has_env": env_light is not None,
        "bvh.levels": tuple(tuple(int(i) for i in lv) for lv in flat.levels),
        "bvh.level_child_valid": tuple(
            tuple(bool(x) for x in (flat.outlets[lv] >= 0).reshape(-1))
            for lv in flat.levels
        ),
        "bvh.level_is_leaf": tuple(
            tuple(bool(x) for x in (flat.leaf_range[lv] > 0))
            for lv in flat.levels
        ),
        "bvh.level_inner": tuple(
            int((flat.leaf_range[lv] == 0).sum()) for lv in flat.levels
        ),
        "bvh.level_leaf": tuple(
            int((flat.leaf_range[lv] > 0).sum()) for lv in flat.levels
        ),
        "bvh.width": flat.width,
        "bvh.max_leaf": max(flat.max_leaf_range, 1),
        "bvh.root_is_leaf": bool(flat.leaf_range[0] > 0),
        "bvh.wf_sched": _build_wf_schedule(flat),
    }
    return fields, static, bvh


def from_jax_arrays(fields: Dict[str, np.ndarray], static: Dict,
                    device=None) -> FlatScene:
    """Build the port's FlatScene from host arrays.

    ``fields`` holds every array leaf of a FlatScene by name, with
    ``bvh.<name>`` for the FlatBVH leaves (``np.asarray`` of the JAX
    package's FlatScene leaves, or flatten_tables' own); ``static``
    holds the static fields under the same naming.  Arrays are taken
    as they are, so the port then traces exactly the JAX tables."""
    dev = resolve_device(device)
    expect = {f.name for f in dataclasses.fields(FlatScene)} - {"bvh"}
    expect -= set(_SCENE_STATIC)
    expect |= {"bvh." + f.name for f in dataclasses.fields(FlatBVH)}
    expect -= {"bvh." + s for s in _BVH_STATIC}
    missing = expect - set(fields)
    if missing:
        raise KeyError(f"missing scene fields: {sorted(missing)}")

    def t(name):
        a = np.asarray(fields[name])
        want = np.int32 if name in _INT_FIELDS else np.float32
        if a.dtype != want:
            raise TypeError(f"field {name}: dtype {a.dtype}, want {want}")
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    bvh = FlatBVH(
        **{f.name: t("bvh." + f.name) for f in dataclasses.fields(FlatBVH)
           if f.name not in _BVH_STATIC},
        **{s: static["bvh." + s] for s in _BVH_STATIC},
    )
    return FlatScene(
        **{f.name: t(f.name) for f in dataclasses.fields(FlatScene)
           if f.name not in _SCENE_STATIC and f.name != "bvh"},
        bvh=bvh,
        **{s: static[s] for s in _SCENE_STATIC},
    )


def flatten_scene(
    scene: st.Scene,
    tree_width: int = 4,
    max_leaf_size: int = 32,
    sah_bins: int = 12,
    device=None,
) -> Tuple[FlatScene, BVHAccel]:
    """Flatten a static scene: build the SAH BVH over all primitives
    (triangles + spheres) and put its tables on ``device`` (the GPU
    unless the caller names another)."""
    dev = resolve_device(device)
    fields, static, bvh = flatten_tables(
        scene, tree_width, max_leaf_size, sah_bins
    )
    return from_jax_arrays(fields, static, dev), bvh
