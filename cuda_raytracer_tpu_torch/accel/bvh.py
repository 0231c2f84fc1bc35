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
the produced tree but makes the Python build fast.  The C++ builder
(native/bvh_builder.cpp) builds the same tree, bit for bit, faster:
``backend="auto"`` takes it when it compiles, numpy otherwise.
"""

from __future__ import annotations

import dataclasses
import time
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
    backend : "native" (the C++ builder; raises, with the compiler's
        output, when it does not build), "numpy", or "auto" (native when
        it builds, else numpy).  ``backend_used`` says which one ran,
        ``build_s`` how long the tree build took (seconds, host clock;
        the library's compile at its first use not included).
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
        self.build_s = 0.0

        n = len(self.prim_min)
        if n == 0:
            self.root = BVHNode(np.zeros(3), np.zeros(3), 0, 0)
            self.sorted_order = np.zeros(0, dtype=np.int64)
            return

        lib = None
        if backend in ("auto", "native"):
            from ..native import NativeBuildError, load_library

            try:
                lib = load_library()  # compiles at its first use
            except NativeBuildError:
                if backend == "native":
                    raise
        t0 = time.perf_counter()
        if lib is not None and self._build_native(lib):
            self.build_s = time.perf_counter() - t0
            return
        if backend == "native":
            raise RuntimeError("native BVH builder returned no tree")

        # one centroid argsort per axis, maintained through splits
        orders = [np.argsort(self.centroids[:, a], kind="stable") for a in range(3)]
        orders = np.stack(orders)  # [3, P]

        root_min = self.prim_min.min(axis=0)
        root_max = self.prim_max.max(axis=0)

        #: final primitive order (the reference mutates its primitive
        #: vector in place; getSortedPrimitives(), src/bvh.cpp:384-386).
        self.sorted_order = np.zeros(n, dtype=np.int64)
        self.root = self._build(orders, 0, n, root_min, root_max)
        self.build_s = time.perf_counter() - t0

    def _build_native(self, lib) -> bool:
        """Build through the C++ builder (native/bvh_builder.cpp); the
        tree is bit-identical to the numpy path."""
        import ctypes

        n = len(self.prim_min)
        cap = 2 * n + 1
        pmin = np.ascontiguousarray(self.prim_min)
        pmax = np.ascontiguousarray(self.prim_max)
        sorted_order = np.zeros(n, dtype=np.int64)
        node_bounds = np.zeros((cap, 6), dtype=np.float64)
        node_info = np.zeros((cap, 4), dtype=np.int64)
        count = lib.bvh_build(
            pmin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            pmax.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, self.max_leaf_size, self.sah_bins,
            sorted_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            node_bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            node_info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        )
        if count <= 0:
            return False
        self.sorted_order = sorted_order

        bounds = node_bounds[:count]
        info = node_info[:count]
        nodes = [
            BVHNode(bounds[i, :3], bounds[i, 3:], int(info[i, 0]),
                    int(info[i, 1]))
            for i in range(count)
        ]
        left = info[:, 2]
        for i in np.nonzero(left >= 0)[0]:
            nodes[i].l = nodes[int(info[i, 2])]
            nodes[i].r = nodes[int(info[i, 3])]
        self.root = nodes[0]
        self.backend_used = "native"
        return True

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
