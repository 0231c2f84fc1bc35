"""SAH BVH construction (host).

A vectorized numpy re-implementation of the reference's binned-SAH
builder (src/bvh.cpp:48-230, BVHAccel ctor :339-365) with the same cost
model and split rule:

* 12 value-spaced partition planes per axis between the first and last
  centroid (``numparts=12``, src/bvh.cpp:104-117);
* prefix/suffix bbox sweeps over centroid-sorted primitives
  (src/bvh.cpp:110-164);
* SAH cost ``5 + (sa_l/sa)*n_l*2 + (sa_r/sa)*n_r*2`` vs. a no-split cost
  of ``2*n`` (src/bvh.cpp:59,179,209-212);
* leaves at ``<= max_leaf_size`` primitives (default 32, src/bvh.h:111).

Instead of re-sorting each node's slice three times per node (the
reference's O(n log^2 n) approach), we keep one global centroid argsort
per axis and maintain all three orders through splits by stable
partition — the classic sweep-SAH build — which changes nothing about
the produced tree but makes the Python build fast.  (The JAX package's
optional C++ builder, native/bvh_builder.cpp, is not ported yet.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class BVHNode:
    """Binary BVH node (src/bvh.h:50-63)."""

    bb_min: np.ndarray
    bb_max: np.ndarray
    start: int
    range: int
    l: Optional["BVHNode"] = None
    r: Optional["BVHNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.l is None and self.r is None


def _surface_area(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    """Surface area of AABBs given [..., 3] corners (src/bbox.h)."""
    e = maxs - mins
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


class BVHAccel:
    """BVH over primitives given as bbox arrays (src/bvh.h:98-180 API).

    Parameters
    ----------
    prim_min, prim_max : [P, 3] float64 primitive bounds.
    max_leaf_size : leaf threshold (reference default 32).
    sah_bins : number of partition planes (reference 12).
    """

    def __init__(self, prim_min: np.ndarray, prim_max: np.ndarray,
                 max_leaf_size: int = 32, sah_bins: int = 12,
                 backend: str = "auto"):
        self.prim_min = np.asarray(prim_min, dtype=np.float64)
        self.prim_max = np.asarray(prim_max, dtype=np.float64)
        assert self.prim_min.shape == self.prim_max.shape
        self.max_leaf_size = max_leaf_size
        self.sah_bins = sah_bins
        self.centroids = (self.prim_min + self.prim_max) * 0.5
        self.backend_used = "numpy"

        n = len(self.prim_min)
        if n == 0:
            self.root = BVHNode(np.zeros(3), np.zeros(3), 0, 0)
            self.sorted_order = np.zeros(0, dtype=np.int64)
            return

        if backend == "native":
            # the C++ builder (native/bvh_builder.cpp of the JAX package)
            # is not ported yet; "auto" takes the numpy path, whose tree
            # the native builder reproduces bit for bit
            raise NotImplementedError(
                "native BVH builder not ported to cuda_raytracer_tpu_torch "
                "yet (ROADMAP queue 1); use backend='auto' or 'numpy'"
            )

        # one centroid argsort per axis, maintained through splits
        orders = [np.argsort(self.centroids[:, a], kind="stable") for a in range(3)]
        orders = np.stack(orders)  # [3, P]

        root_min = self.prim_min.min(axis=0)
        root_max = self.prim_max.max(axis=0)

        #: final primitive order (the reference mutates its primitive
        #: vector in place; getSortedPrimitives(), src/bvh.cpp:384-386).
        self.sorted_order = np.zeros(n, dtype=np.int64)
        self.root = self._build(orders, 0, n, root_min, root_max)

    # -- recursive split (src/bvh.cpp:48-230) -----------------------------
    def _build(self, orders: np.ndarray, start: int, end: int,
               bb_min: np.ndarray, bb_max: np.ndarray) -> BVHNode:
        n = end - start
        node = BVHNode(bb_min, bb_max, start, n)
        if n <= self.max_leaf_size:
            self.sorted_order[start:end] = orders[0, start:end]
            return node
        total_sa = _surface_area(bb_min, bb_max)
        if total_sa < 1e-15:
            self.sorted_order[start:end] = orders[0, start:end]
            return node

        current_cost = 2.0 * n
        best = None  # (cost, axis, count_left, bbox_l, bbox_r)
        nbins = self.sah_bins
        for axis in range(3):
            idx = orders[axis, start:end]
            cen = self.centroids[idx, axis]
            startval, endval = cen[0], cen[-1]
            if endval <= startval:
                continue
            # value-spaced dividers (src/bvh.cpp:109-117)
            parts = np.arange(1, nbins + 1, dtype=np.float64)
            dividers = startval + parts * ((endval - startval) / (nbins + 1))
            counts = np.searchsorted(cen, dividers, side="right")

            pmins = self.prim_min[idx]
            pmaxs = self.prim_max[idx]
            # prefix sweep: bbox of [0, k)
            pre_min = np.minimum.accumulate(pmins, axis=0)
            pre_max = np.maximum.accumulate(pmaxs, axis=0)
            # suffix sweep: bbox of [k, n)
            suf_min = np.minimum.accumulate(pmins[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(pmaxs[::-1], axis=0)[::-1]

            for k, cnt in enumerate(counts):
                n1 = int(cnt)
                n2 = n - n1
                if n1 == 0 or n2 == 0:
                    continue
                sa1 = _surface_area(pre_min[n1 - 1], pre_max[n1 - 1])
                sa2 = _surface_area(suf_min[n1], suf_max[n1])
                cost = 5.0 + (sa1 / total_sa) * n1 * 2.0 + (sa2 / total_sa) * n2 * 2.0
                if best is None or cost < best[0]:
                    if cost < current_cost:
                        best = (
                            cost,
                            axis,
                            n1,
                            (pre_min[n1 - 1].copy(), pre_max[n1 - 1].copy()),
                            (suf_min[n1].copy(), suf_max[n1].copy()),
                        )

        if best is None:
            # no split beats the leaf cost (src/bvh.cpp:209-212)
            self.sorted_order[start:end] = orders[0, start:end]
            return node

        _, axis, n1, (lmin, lmax), (rmin, rmax) = best
        # membership: the first n1 prims in best-axis order go left; keep
        # all three axis orders consistent by stable partition
        left_ids = orders[axis, start : start + n1]
        mask = np.zeros(len(self.prim_min), dtype=bool)
        mask[left_ids] = True
        for a in range(3):
            sl = orders[a, start:end]
            m = mask[sl]
            orders[a, start:end] = np.concatenate([sl[m], sl[~m]])

        node.l = self._build(orders, start, start + n1, lmin, lmax)
        node.r = self._build(orders, start + n1, end, rmin, rmax)
        return node

    # -- queries ----------------------------------------------------------
    def get_bbox(self):
        return self.root.bb_min.copy(), self.root.bb_max.copy()

    def get_sorted_order(self) -> np.ndarray:
        """Primitive permutation in BVH (leaf-contiguous) order — the
        analog of getSortedPrimitives() (src/bvh.cpp:384-386)."""
        return self.sorted_order

    def node_count(self) -> int:
        def count(n):
            return 1 + (count(n.l) if n.l else 0) + (count(n.r) if n.r else 0)

        return count(self.root)

    def max_depth(self) -> int:
        def depth(n):
            if n is None:
                return 0
            return 1 + max(depth(n.l), depth(n.r))

        return depth(self.root)

    def leaf_ranges(self) -> List:
        """(start, range) of every leaf in DFS order."""
        out = []

        def walk(n):
            if n.is_leaf:
                out.append((n.start, n.range))
            else:
                walk(n.l)
                walk(n.r)

        walk(self.root)
        return out

    def intersect_ray(self, o, d, prim_test, t_max=np.inf):
        """Host-side single-ray closest hit for debugging/tests — the CPU
        query the reference left a stub (src/bvh.cpp:390-439).

        ``prim_test(prim_id, o, d) -> t or None`` tests one primitive.
        Returns (prim_id or None, t).  Primitive ids are *original*
        (pre-sort) indices.
        """
        o = np.asarray(o, dtype=np.float64)
        d = np.asarray(d, dtype=np.float64)
        inv = 1.0 / np.where(d == 0, 1e-30, d)
        best = (None, t_max)
        stack = [self.root]
        while stack:
            node = stack.pop()
            t0 = (node.bb_min - o) * inv
            t1 = (node.bb_max - o) * inv
            tn = np.minimum(t0, t1).max()
            tf = np.maximum(t0, t1).min()
            if tn > tf or tf < 0 or tn > best[1]:
                continue
            if node.is_leaf:
                for i in range(node.start, node.start + node.range):
                    pid = self.sorted_order[i]
                    t = prim_test(pid, o, d)
                    if t is not None and 0 < t < best[1]:
                        best = (pid, t)
            else:
                stack.append(node.l)
                stack.append(node.r)
        return best
