"""Deterministic stream compaction (scan + scatter).

The port of ``cuda_raytracer_tpu/ops/compact.py``: one exclusive cumsum
over the keep-mask gives every surviving element its output slot, and a
scatter writes it there.  No atomics, the same result on every run.

Overflow policy: elements whose slot is at or past the static capacity
are dropped and counted, so an undersized buffer is observable.
Nothing in the renderer calls it (the frame compacts through
ops/partition.py); it is kept so the port does what the JAX package
does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def compact(
    mask: torch.Tensor,
    arrays: Sequence[torch.Tensor],
    capacity: int,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Scatter ``arrays[i][mask]`` to the front of fresh buffers.

    mask: [M] bool keep-mask; arrays: [M, ...] tensors compacted
    together; capacity: the static output length.  Returns (outs, count,
    dropped): outs[i] is [capacity, ...] with the kept elements in order
    (zeros past them), count the number of valid leading elements
    (<= capacity, 0-d int32), dropped the overflowed elements (0-d
    int32).
    """
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m  # exclusive scan
    total = (pos[-1] + m[-1] if m.shape[0]
             else torch.zeros((), dtype=torch.int32, device=mask.device))
    keep = (m > 0) & (pos < capacity)
    # dropped and masked-out elements land in the scratch slot `capacity`
    idx = torch.where(keep, pos, capacity).long()
    outs = []
    for a in arrays:
        buf = torch.zeros((capacity + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=a.device)
        # only kept elements write, so no two writes share a slot
        buf[idx[keep]] = a[keep]
        outs.append(buf[:capacity])
    count = torch.clamp_max(total, capacity)
    return tuple(outs), count, total - count
