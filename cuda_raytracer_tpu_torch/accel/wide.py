"""Wide-tree compaction and level-ordered flattening.

Re-expresses the reference's two host passes as numpy array builders:

* **compaction** (BVHNode::compactTree, src/bvh.cpp:275-337): the binary
  SAH tree is regrouped into W-ary "subtree" nodes by collecting every
  descendant at relative depth ``log2(W)`` (or early leaves above it) as
  outlets, each carrying its AABB;
* **compression** (BVHSubTree::compress, src/bvh.cpp:234-273): preorder
  DFS flattening of the subtree graph into dense arrays, recording each
  node's index into a per-depth level list — this drives the engine's
  breadth-first level-synchronous scheduling (the analog of
  deviceLevelIndices/levelCounts, src/cudaRenderer.cu:1794-1840).

The flat arrays are exactly what the jitted traversal consumes: int32
outlets with -1 for "none", per-child f32 AABBs (+inf/-inf for empty
slots so the slab test can run unmasked), and leaf start/range into the
BVH-sorted primitive array (leaf <=> range > 0, matching the
value-initialized zero range of inner reference nodes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .bvh import BVHAccel, BVHNode


@dataclasses.dataclass
class _SubTree:
    """In-memory wide node (BVHSubTree, src/bvh.h:34-47)."""

    outlets: List[Optional["_SubTree"]]
    mins: np.ndarray  # [W, 3]
    maxs: np.ndarray  # [W, 3]
    start: int = 0
    range: int = 0


def _compact(node: BVHNode, width: int, depth: int) -> _SubTree:
    """BVHNode::compactTree (src/bvh.cpp:275-337)."""
    sub = _SubTree(
        outlets=[None] * width,
        mins=np.full((width, 3), np.inf),
        maxs=np.full((width, 3), -np.inf),
    )
    if node.is_leaf:
        sub.start = node.start
        sub.range = node.range
        return sub

    curr = 0
    stack = [(0, node)]
    while stack:
        d, n = stack.pop()
        if d == depth:
            if curr >= width:
                raise RuntimeError("wide-tree compaction outlet overflow")
            sub.outlets[curr] = _compact(n, width, depth)
            sub.mins[curr] = n.bb_min
            sub.maxs[curr] = n.bb_max
            curr += 1
            continue
        if n.l is not None:
            stack.append((d + 1, n.l))
        if n.r is not None:
            stack.append((d + 1, n.r))
        if n.is_leaf and d != depth:
            if curr >= width:
                raise RuntimeError("wide-tree compaction outlet overflow")
            sub.outlets[curr] = _compact(n, width, depth)
            sub.mins[curr] = n.bb_min
            sub.maxs[curr] = n.bb_max
            curr += 1
    return sub


@dataclasses.dataclass
class FlatWideBVH:
    """Dense device-ready wide BVH.

    Attributes
    ----------
    outlets : [N, W] int32, child subtree index or -1.
    child_min, child_max : [N, W, 3] float32 child AABBs (+inf/-inf in
        empty slots).
    leaf_start, leaf_range : [N] int32; range > 0 iff the node is a leaf.
    levels : list of int32 arrays — node indices per depth (the level
        lists that drive breadth-first scheduling).
    width : tree arity W.
    """

    outlets: np.ndarray
    child_min: np.ndarray
    child_max: np.ndarray
    leaf_start: np.ndarray
    leaf_range: np.ndarray
    levels: List[np.ndarray]
    width: int

    @property
    def num_nodes(self) -> int:
        return len(self.outlets)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def max_leaf_range(self) -> int:
        return int(self.leaf_range.max()) if len(self.leaf_range) else 0

    def level_profile(self) -> List[int]:
        """Node count per level (the reference prints this at load,
        src/cudaRenderer.cu:1829-1840)."""
        return [len(lv) for lv in self.levels]


def build_flat_wide_bvh(bvh: BVHAccel, width: int = 4) -> FlatWideBVH:
    """Compact + compress ``bvh`` into a W-ary flat wide tree.

    ``width`` must be a power of two in [2, 16] (reference constraint
    TREE_BRANCHES = 2^DEPTH <= MAX_BRANCHES, src/bvh.h:9, bvh.cpp:9-10).
    """
    assert width >= 2 and (width & (width - 1)) == 0 and width <= 16
    depth = int(np.log2(width))
    root = _compact(bvh.root, width, depth)

    outlets: List[List[int]] = []
    mins: List[np.ndarray] = []
    maxs: List[np.ndarray] = []
    starts: List[int] = []
    ranges: List[int] = []
    levels: List[List[int]] = []

    # preorder DFS with explicit stack (BVHSubTree::compress,
    # src/bvh.cpp:234-273)
    def compress(sub: _SubTree, d: int) -> int:
        idx = len(outlets)
        outlets.append([-1] * width)
        mins.append(sub.mins)
        maxs.append(sub.maxs)
        starts.append(sub.start)
        ranges.append(sub.range)
        while len(levels) <= d:
            levels.append([])
        levels[d].append(idx)
        for i in range(width):
            if sub.outlets[i] is not None:
                outlets[idx][i] = compress(sub.outlets[i], d + 1)
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        compress(root, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatWideBVH(
        outlets=np.asarray(outlets, dtype=np.int32),
        child_min=np.stack(mins).astype(np.float32),
        child_max=np.stack(maxs).astype(np.float32),
        leaf_start=np.asarray(starts, dtype=np.int32),
        leaf_range=np.asarray(ranges, dtype=np.int32),
        levels=[np.asarray(lv, dtype=np.int32) for lv in levels],
        width=width,
    )
