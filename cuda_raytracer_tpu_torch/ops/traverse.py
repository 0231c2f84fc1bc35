"""Breadth-first wide-BVH traversal as torch ops (the ``"xla"`` backend).

The port of ``cuda_raytracer_tpu/ops/traverse.py``.  The JAX module is
not a Pallas kernel: it is XLA ops, one ``lax.scan`` step per tree
level over (ray, node) entry queues of a fixed capacity
(``queue_multiplier * N``).  This is the same algorithm in eager torch
ops, and it is the route for trees wider than the kernels take (the
packet-DFS and wavefront kernels stop at width 8; ``"auto"`` sends a
wider tree here, render/backends.py).

* Level loop: the box tests of every queued entry, then the hit children
  split into leaf entries (tested now) and inner entries (the next
  level's queue), each compacted in entry order and cut at the capacity;
  the entries cut off are counted in ``dropped``.
* Leaf test: ``[chunk, max_leaf]`` ray x primitive blocks through
  ``ops.intersect.intersect_rows`` (the shared leaf test), in the JAX
  module's chunks of ``LEAF_CHUNK`` entries.
* Merge: a scatter-min over the monotone int32 bits of t, then a winner
  write: an entry whose t equals the ray's updated best writes its prim.
  Where several entries of a ray tie, the last in entry order wins, as a
  scatter with repeated indices resolves on the JAX package's CPU
  backend; here that rule is explicit, so it holds on the GPU too.

The queues hold only their live prefix: each compaction reads its count
on the host (one sync per compaction on the GPU) and the chunks past it,
which hold no live entry, are skipped.  The JAX module sweeps them; they
change nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import intersect_bbox, intersect_rows

INF = float("inf")
#: int32 bits of +inf (the monotone view of a non-negative float32)
INF_BITS = 0x7F800000

#: entries per leaf-test chunk and per box-test chunk (the JAX module's):
#: a leaf chunk materializes [LEAF_CHUNK, max_leaf] temporaries, a box
#: chunk [INNER_CHUNK, W, 3]
LEAF_CHUNK = 1 << 16
INNER_CHUNK = 1 << 17


class TraceResult(NamedTuple):
    #: closest hit distance per ray (inf = miss)
    t: torch.Tensor
    #: primitive index (BVH-sorted order) per ray, -1 = miss
    prim: torch.Tensor
    #: 0-d int64: entries dropped on queue overflow (0 in any correctly
    #: sized run)
    dropped: torch.Tensor


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunk_size(capacity: int, limit: int) -> int:
    """The JAX module's chunk length for a queue of ``capacity``."""
    nc = max(_cdiv(capacity, limit), 1)
    return _cdiv(capacity, nc)


def _compact_to(mask, arrays, capacity: int):
    """The entries where ``mask`` holds, in order, cut at ``capacity``.
    Returns (outs, count, dropped)."""
    sel = mask.nonzero().squeeze(1)
    total = sel.numel()
    sel = sel[:capacity]
    return [a[sel] for a in arrays], sel.numel(), total - sel.numel()


def trace_closest(scene, o, d, valid, queue_multiplier: int = 4) -> TraceResult:
    """Closest-hit traversal for N rays against the flat wide BVH.

    o, d: [N, 3] float32; valid: [N] bool.  Invalid rays return a miss.
    """
    bvh = scene.bvh
    dev = o.device
    N = o.shape[0]
    P = scene.num_prims
    W = bvh.width
    K = bvh.max_leaf
    C = queue_multiplier * N  # per-level entry capacity
    node_rows = bvh.node_packed[:, :8 * W + 2]
    prim_rows = scene.prim_packed[:, :23]
    n_nodes = bvh.leaf_range.shape[0]

    # slot N of each per-ray buffer takes the entries that write nothing
    best_bits = torch.full((N + 1,), INF_BITS, dtype=torch.int32, device=dev)
    best_prim = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    last = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    k = torch.arange(K, dtype=torch.int32, device=dev)

    def leaf_batch(e_ray, e_node, e_valid, capacity):
        """Prim tests of the queued leaf entries, merged into the best."""
        chunk = _chunk_size(capacity, LEAF_CHUNK)
        for s in range(0, e_ray.shape[0], chunk):
            c_ray, c_node = e_ray[s:s + chunk], e_node[s:s + chunk]
            c_valid = e_valid[s:s + chunk]
            cc = c_ray.shape[0]
            nrows = node_rows[c_node]
            start = nrows[:, 7 * W].to(torch.int32)
            rng = nrows[:, 7 * W + 1].to(torch.int32)
            pid = start[:, None] + k[None, :]  # [cc, K]
            pmask = k[None, :] < rng[:, None]
            pid_c = pid.clamp(0, P - 1)
            prows = prim_rows[pid_c.reshape(-1).long()].reshape(cc, K, 23)
            t = intersect_rows(o[c_ray][:, None, :], d[c_ray][:, None, :],
                               prows)  # [cc, K]
            t = torch.where(pmask & c_valid[:, None] & (t >= 0), t, INF)
            kmin = t.argmin(1, keepdim=True)  # first (lowest-pid) min
            tmin = t.gather(1, kmin)[:, 0]
            pmin = pid_c.gather(1, kmin)[:, 0]

            finite = tmin < INF
            bits = tmin.view(torch.int32)
            tgt = torch.where(finite, c_ray, N)
            best_bits.scatter_reduce_(0, tgt, bits, "amin")
            # winner write: the entries matching the ray's updated best;
            # of several, the last in entry order (an entry beaten later
            # is overwritten by the batch that beats it)
            win = finite & (bits == best_bits[c_ray])
            tgt2 = torch.where(win, c_ray, N)
            pos = torch.arange(cc, device=dev)
            last.scatter_reduce_(0, tgt2, pos, "amax")
            is_last = win & (last[c_ray] == pos)
            best_prim.scatter_(0, torch.where(is_last, c_ray, N), pmin)
            last.scatter_(0, tgt2, -1)

    def result(dropped: int) -> TraceResult:
        prim = best_prim[:N]
        t = torch.where(prim >= 0, best_bits[:N].view(torch.float32), INF)
        return TraceResult(t, prim,
                           torch.tensor(dropped, dtype=torch.int64,
                                        device=dev))

    e_ray = torch.arange(N, dtype=torch.int64, device=dev)
    e_node = torch.zeros((N,), dtype=torch.int64, device=dev)
    if bvh.root_is_leaf:
        leaf_batch(e_ray, e_node, valid, N)
        return result(0)

    e_valid = valid
    dropped = 0
    for _ in range(bvh.num_levels - 1):
        n = e_ray.shape[0]
        if n == 0:
            break
        # box tests of the queued entries, in chunks
        hit = torch.empty((n, W), dtype=torch.bool, device=dev)
        outlets = torch.empty((n, W), dtype=torch.int64, device=dev)
        child_leaf = torch.empty((n, W), dtype=torch.bool, device=dev)
        chunk = _chunk_size(C, INNER_CHUNK)
        for s in range(0, n, chunk):
            c_ray = e_ray[s:s + chunk]
            cc = c_ray.shape[0]
            nrows = node_rows[e_node[s:s + chunk]]
            cmin = nrows[:, 0:3 * W].reshape(cc, W, 3)
            cmax = nrows[:, 3 * W:6 * W].reshape(cc, W, 3)
            outlets_f = nrows[:, 6 * W:7 * W]
            best_f = best_bits[c_ray].view(torch.float32)
            tbox = intersect_bbox(o[c_ray][:, None, :], d[c_ray][:, None, :],
                                  cmin, cmax)  # [cc, W]
            hit[s:s + chunk] = (e_valid[s:s + chunk, None] & (outlets_f >= 0)
                                & (tbox >= 0) & (tbox <= best_f[:, None]))
            outlets[s:s + chunk] = outlets_f.to(torch.int32)
            child_leaf[s:s + chunk] = nrows[:, 7 * W + 2:8 * W + 2] > 0.5

        push_ray = e_ray[:, None].expand(n, W).reshape(-1)
        push_node = outlets.clamp(0, n_nodes - 1).reshape(-1)
        hit = hit.reshape(-1)
        child_leaf = child_leaf.reshape(-1)

        # leaf children: intersect now
        (lr, ln), lcount, ldrop = _compact_to(hit & child_leaf,
                                              (push_ray, push_node), C)
        leaf_batch(lr, ln, torch.ones((lcount,), dtype=torch.bool,
                                      device=dev), C)
        # inner children: the next level's entries
        (e_ray, e_node), icount, idrop = _compact_to(
            hit & ~child_leaf, (push_ray, push_node), C)
        e_valid = torch.ones((icount,), dtype=torch.bool, device=dev)
        dropped += ldrop + idrop
    return result(dropped)


def trace_bruteforce(scene, o, d, valid, chunk: int = 512) -> TraceResult:
    """O(N*P) dense closest hit, the BVH-free oracle that validates the
    traversals.  Chunks primitives to bound memory."""
    dev = o.device
    N = o.shape[0]
    P = scene.num_prims
    best_t = torch.full((N,), INF, dtype=torch.float32, device=dev)
    best_prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    for s in range(0, P, chunk):
        e = min(s + chunk, P)
        t = intersect_rows(o[:, None, :], d[:, None, :],
                           scene.prim_packed[None, s:e, :23])  # [N, e-s]
        t = torch.where((t >= 0) & valid[:, None], t, INF)
        kk = t.argmin(1, keepdim=True)
        tmin = t.gather(1, kk)[:, 0]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_prim = torch.where(better, (kk[:, 0] + s).to(torch.int32),
                                best_prim)
    return TraceResult(best_t, best_prim,
                       torch.zeros((), dtype=torch.int64, device=dev))
