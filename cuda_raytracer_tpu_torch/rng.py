"""Counter-based random numbers: threefry2x32, bit-exact with ``jax.random``.

The frame's noise is part of the function being ported: the fold_in
tree over (frame, depth, NEE sample, light) and the per-granule shared
draws (cfg.rng_granule) decide which rays of a packet are coherent.  So
the port does not swap in ``torch.Generator``; it reproduces
``jax.random``'s default threefry2x32 generator with
``jax_threefry_partitionable=True`` (the default from jax 0.5 on):

* a key is a pair of uint32 words, here a host-side ``(int, int)``;
* ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xffffffff)``;
* ``fold_in(key, data)`` = ``threefry2x32(key, (0, data))``;
* ``split(key, num)[i]`` = ``threefry2x32(key, (0, i))`` (both words);
* ``uniform(key, shape)``: element ``i`` of the flattened shape draws
  ``b1 ^ b2`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``, then
  maps the top 23 bits to ``[1, 2)`` and subtracts 1.

Keys are derived on the host (a few Python integer rounds); only the
bulk ``uniform`` runs on the device, as int64 tensor ops masked to 32
bits, so CPU and CUDA give the same bits.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(key: Key, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under ``key``.

    Works on Python ints and on int64 tensors holding values in
    [0, 2^32) alike; returns the two output words."""
    k0, k1 = key
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT0 if i % 2 == 0 else _ROT1)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 — jax.random's name
    """``jax.random.PRNGKey`` for an int32 seed (jax's default x64-off
    mode; larger seeds are refused there too)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return (0, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> List[Key]:
    return [threefry2x32(key, 0, i) for i in range(num)]


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    fbits = ((b0 ^ b1) >> 9) | 0x3F800000  # < 2^31: exact in int32
    return (fbits.to(torch.int32).view(torch.float32) - 1.0).reshape(
        tuple(shape))
