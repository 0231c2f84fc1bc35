"""Conservative closest-hit seeding against the K largest primitives.

The port of ``cuda_raytracer_tpu/ops/seeds.py``.  A brute-force hit
against any subset of the scene bounds each ray's closest hit from
above.  Testing every ray against the K largest-area prims (walls,
floor, ceiling, light panels in box-like scenes) gives a bound that is
often the final hit.  The traversals take it as the ray's starting
bound (``seed_t``, ``seed_prim``):

* child boxes entered beyond the seed are pruned from the root down;
* the kernels report only hits strictly better than the bound, and the
  seed stands in where none is (the DFS folds it back, the wavefront
  starts the ray's hit key from it);
* a shadow ray whose seed lands more than ``kill_eps`` short of the
  light is answered before it traverses.

Exactness: the sweep is ``ops/intersect.packed_prim_test``, op for op
as the kernels' leaf test, so on the same device the seed t of a prim
is the t the traversal would find for it, to the bit.  The JAX package
fuses this sweep under jit, where its t can drift by an ulp from its
kernels' (ops/seeds.py there); results stay the same up to that
rounding.

In the JAX package the sweep is XLA glue, not a Pallas kernel; here it
is torch ops (K unrolled prim tests of about 40 elementwise ops each),
on the card as on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import packed_prim_test

#: the traversals' finite "no limit" bound (T_NO_LIMIT of packet_dfs and
#: wavefront2)
T_NONE = 1e30


class SeedHits(NamedTuple):
    t: torch.Tensor  # [N] f32: hit distance, T_NONE on a miss
    prim: torch.Tensor  # [N] int32: BVH-order prim id, -1 on a miss


def seed_hits(scene, o, d, valid, k: int = 32) -> SeedHits:
    """Closest hit among the first ``k`` seed rows of ``scene`` for each
    ray.  o, d: [N, 3] f32; valid: [N] bool.  Rows are area-descending
    (render/flatscene.flatten_scene), so k < K keeps the largest."""
    rows = scene.seed_rows
    n = o.shape[0]
    if rows is None:
        return SeedHits(
            torch.full((n,), T_NONE, dtype=torch.float32, device=o.device),
            torch.full((n,), -1, dtype=torch.int32, device=o.device),
        )
    k = min(int(k), rows.shape[0])
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best_t = torch.full((n,), T_NONE, dtype=torch.float32, device=o.device)
    best_p = torch.full((n,), -1.0, dtype=torch.float32, device=o.device)
    for i in range(k):
        r = rows[i]
        # seed rows mirror prim_packed cols 0:22, with the prim id in 22
        ok, t_i = packed_prim_test(
            ox, oy, oz, dx, dy, dz,
            r[10], r[11], r[12], r[13],
            r[14], r[15], r[16], r[17],
            r[18], r[19], r[20], r[21],
            r[9],
        )
        better = ok & (t_i < best_t)
        best_p = torch.where(better, r[22], best_p)
        best_t = torch.where(better, t_i, best_t)
    best_t = torch.where(valid, best_t, T_NONE)
    best_p = torch.where(valid, best_p, -1.0)
    return SeedHits(best_t, best_p.to(torch.int32))


def seeded_bound(seed_t, t_limit=None, kill_eps: float = 1e-3):
    """Each ray's start bound under a seed: min(t_limit, 1e30, seed_t);
    with a t_limit (a shadow pass), -1 where the seed lands more than
    kill_eps short of it (the ray is occluded: no traversal needed).
    Invalid lanes are the traversal's to kill."""
    st = seed_t.float()
    if t_limit is None:
        return torch.minimum(torch.full_like(st, T_NONE), st)
    tub = torch.clamp_max(t_limit.float(), T_NONE)
    decided = st < tub - kill_eps
    return torch.where(decided, -1.0, torch.minimum(tub, st))
