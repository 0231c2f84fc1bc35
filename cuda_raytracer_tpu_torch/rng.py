"""Counter-based random numbers: threefry2x32, bit-exact with ``jax.random``.

The frame's noise is part of the function being ported: the fold_in
tree over (frame, depth, NEE sample, light) and the per-granule shared
draws (cfg.rng_granule) decide which rays of a packet are coherent.  So
the port does not swap in ``torch.Generator``; it reproduces
``jax.random``'s default threefry2x32 generator with
``jax_threefry_partitionable=True`` (the default from jax 0.5 on):

* a key is a pair of uint32 words, here a host-side ``(int, int)``, or,
  where ``uniform`` reads it, a pair of 0-d int64 tensors on the device
  (``KeyTable``: a frame's keys in one buffer that a captured CUDA
  graph reads on every replay);
* ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xffffffff)``;
* ``fold_in(key, data)`` = ``threefry2x32(key, (0, data))``;
* ``split(key, num)[i]`` = ``threefry2x32(key, (0, i))`` (both words);
* ``uniform(key, shape)``: element ``i`` of the flattened shape draws
  ``b1 ^ b2`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``, then
  maps the top 23 bits to ``[1, 2)`` and subtracts 1.

Keys are derived on the host (a few Python integer rounds); only the
bulk ``uniform`` runs on the device.  On a CUDA device it launches one
kernel (ops/csrc/rng.cu: the whole hash and map per element, in u32
registers) or raises; on the CPU it runs ``uniform_plain``, the same
hash as int64 tensor ops masked to 32 bits.  Both give jax.random's
bits, from key words given as ints or as tensors alike.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Mapping
from typing import Dict, Hashable, Iterator, List, Sequence, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)

#: launches of the uniform kernel (ops/csrc/rng.cu) since the count was
#: last set to 0
launches = 0

_lib = None


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


def _repeated(shape, repeat: int):
    """The shape of ``shape``'s draw repeated ``repeat`` times along axis
    0 (jnp.repeat)."""
    shape = tuple(int(s) for s in shape)
    if repeat == 1:
        return shape
    if repeat < 1 or not shape:
        raise ValueError(f"repeat {repeat} of shape {shape}: want repeat "
                         ">= 1 and a first axis")
    return (shape[0] * repeat,) + shape[1:]


def uniform(key, shape: Sequence[int], device, repeat: int = 1
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device``, each
    row repeated ``repeat`` times along axis 0 (``jnp.repeat(..., repeat,
    axis=0)``: draw_u2's per-granule draws).  The key words are ints or
    0-d int64 tensors on ``device`` (a ``KeyTable`` entry); the bits are
    the same.

    On a CUDA device the kernel (or an error); on the CPU the plain
    version."""
    dev = (torch.device(device) if device is not None
           else torch.get_default_device())
    if dev.type == "cuda":
        return uniform_cuda(key, shape, dev, repeat)
    if dev.type == "cpu":
        return uniform_plain(key, shape, dev, repeat)
    raise ValueError(f"no uniform path for device {dev}")


def uniform_plain(key, shape: Sequence[int], device, repeat: int = 1
                  ) -> torch.Tensor:
    """``uniform`` in int64 tensor ops (any device)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    fbits = ((b0 ^ b1) >> 9) | 0x3F800000  # < 2^31: exact in int32
    u = (fbits.to(torch.int32).view(torch.float32) - 1.0).reshape(
        tuple(shape))
    if repeat != 1:
        _repeated(shape, repeat)  # refuses what the kernel refuses
        u = torch.repeat_interleave(u, repeat, dim=0)
    return u


def _load_library():
    global _lib
    if _lib is None:
        # imported here: ops/ imports this module
        from .ops._build import load_library

        lib = load_library("rng")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.rng_uniform.argtypes = [p, p, ctypes.c_uint32, ctypes.c_uint32,
                                    p, ll, ll, ll, p]
        lib.rng_uniform.restype = ctypes.c_int
        _lib = lib
    return _lib


def _key_words(key, dev):
    """(pointer, pointer, word, word) of a key for the kernel: two
    device pointers to int64 words (and zeros), or two null pointers and
    the words."""
    k0, k1 = key
    tensors = [isinstance(k, torch.Tensor) for k in (k0, k1)]
    if not any(tensors):
        return None, None, int(k0) & _M32, int(k1) & _M32
    if not all(tensors):
        raise TypeError("key: both words ints or both tensors")
    for k in (k0, k1):
        if k.dtype != torch.int64 or k.numel() != 1 or k.device != dev:
            raise ValueError(f"key word: {k.dtype} {tuple(k.shape)} on "
                             f"{k.device}, want one int64 on {dev}")
    return k0.data_ptr(), k1.data_ptr(), 0, 0


def uniform_cuda(key, shape: Sequence[int], device, repeat: int = 1
                 ) -> torch.Tensor:
    """Launch the kernel on ``device``'s current stream (``uniform`` on
    a CUDA device).  A tensor key is read on the device when the kernel
    runs, never copied to the host."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("uniform_cuda needs a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(_repeated(shape, repeat), dtype=torch.float32,
                      device=dev)
    n = out.numel()
    if n == 0:
        return out
    if repeat != 1 and n >= 1 << 32:
        raise ValueError(f"repeat form of {n} outputs: the kernel takes "
                         "fewer than 2^32")
    p0, p1, h0, h1 = _key_words(key, dev)
    inner = n // out.shape[0] if repeat != 1 else 1
    err = _load_library().rng_uniform(
        p0, p1, h0, h1, out.data_ptr(), n, inner, repeat,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rng_uniform kernel launch failed: cuda error "
                           f"{err}")
    launches += 1
    return out


class KeyTable(Mapping):
    """Named keys on the device, for frames that run as captured CUDA
    graphs: one [K, 2] int64 buffer, each key a pair of 0-d views into
    it (the words ``uniform`` takes).  ``load`` copies host keys of the
    same names into the buffer in one transfer; the views stay where
    they are, so a graph captured reading them reads the new keys on
    every replay."""

    def __init__(self, names, device):
        self._index: Dict[Hashable, int] = {n: i for i, n in
                                            enumerate(names)}
        self.buf = torch.zeros((len(self._index), 2), dtype=torch.int64,
                               device=device)
        self._keys = {n: (self.buf[i, 0], self.buf[i, 1])
                      for n, i in self._index.items()}

    def load(self, host: Mapping) -> None:
        """Copy host keys (name -> (int, int)), one for every name."""
        if host.keys() != self._index.keys():
            raise ValueError("host keys name other keys than the table")
        self.buf.copy_(torch.tensor([host[n] for n in self._index],
                                    dtype=torch.int64).reshape(-1, 2))

    def __getitem__(self, name):
        return self._keys[name]

    def __iter__(self) -> Iterator:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)
