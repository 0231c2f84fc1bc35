"""Live-entry compaction: the kernel and its plain versions.

The port of ``cuda_raytracer_tpu/ops/pallas/partition.py``.  Russian
roulette kills most lanes at the deeper depths; the wavefront traversal
(ops/wavefront2.py) merges its hits by ray id, so a queue compacted to
its live entries needs no inverse permutation, and every later sweep
covers live entries only.

One kernel (ops/csrc/partition.cu: a single-pass stable compaction with
decoupled look-back), two entry points:

* ``compact_live_payload(payload)`` — an entry-major [N, R] float32
  payload (R = 8 for a wavefront queue entry ``o.xyz d.xyz rayid tub``,
  16 for a whole path state; the JAX package keeps the TPU's lane layout
  [R, N]); an entry is live when its field 7 is >= 0.
* ``compact_live_rays(o, d, valid, t_limit)`` — the rays as the frame
  holds them; lane i is live when ``valid[i]`` and its bound
  ``tub = min(t_limit[i], 1e30)`` (1e30 without ``t_limit``; NaN is
  dead) is >= 0, and becomes the queue entry ``o.xyz d.xyz i tub`` (i as
  an int32 bit pattern): ``compact_live_payload(make_payload(...))``
  without the full-size payload.

Both return ``(packed, n_live)``: the live entries in their original
order at the front of ``packed``, ``n_live`` a 0-d int32 tensor on the
input's device.  Entries past ``n_live`` are undefined, as in the TPU
kernel: no reader goes past it (the wavefront kernels read a level's
total from the device).  For CUDA tensors each entry point launches the
kernel (or raises) and counts it (``launches``, ``ray_launches``); for
CPU tensors it runs its plain version (``partition_plain``,
``compact_rays_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .packet_dfs import T_NO_LIMIT, check_rays

#: field of an entry that carries its liveness (tub; >= 0 is live)
LIVE_FIELD = 7

#: kernel launches since the count was last set to 0: payload form, and
#: ray form
launches = 0
ray_launches = 0

_lib = None


def _load_library():
    global _lib
    if _lib is None:
        lib = load_library("partition")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.partition_compact.argtypes = [p] * 4 + [ll, ctypes.c_int, p]
        lib.partition_rays.argtypes = [p] * 7 + [ll, p]
        lib.partition_tile_entries.argtypes = [ctypes.c_int]
        for fn in (lib.partition_compact, lib.partition_rays,
                   lib.partition_tile_entries):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_payload(payload):
    if payload.dtype != torch.float32:
        raise TypeError(f"payload: dtype {payload.dtype}, want float32")
    if payload.dim() != 2 or payload.shape[1] < 8 or payload.shape[1] % 4:
        raise ValueError(
            f"payload: shape {tuple(payload.shape)}, want [N, R] with R a "
            "multiple of 4 and >= 8"
        )
    if not payload.is_contiguous():
        raise ValueError("payload must be contiguous")
    if payload.shape[0] >= 1 << 31:
        raise ValueError("payload has too many entries for int32 positions")


def _check_rays(o, d, valid, t_limit):
    check_rays(o, d, valid, t_limit)
    if o.shape[0] >= 1 << 31:
        raise ValueError("too many rays for int32 ray ids")


def _scratch(lib, n, rays, dev):
    """The look-back's status words and tile counter (zeroed by the C
    side on the launch's stream)."""
    tiles = -(-n // lib.partition_tile_entries(int(rays)))
    return torch.empty((tiles + 1,), dtype=torch.int64, device=dev)


def _launched(err, n):
    if err != 0:
        raise RuntimeError(f"partition kernel launch failed: cuda error {err}")
    return 1 if n else 0  # the C side launches nothing for no entries


def partition_cuda(payload: torch.Tensor):
    """Launch the kernel on a payload, on the current stream; returns
    (packed, n_live)."""
    global launches
    _check_payload(payload)
    if payload.device.type != "cuda":
        raise ValueError("partition_cuda needs CUDA tensors")
    lib = _load_library()
    n, r = payload.shape
    dev = payload.device
    out = torch.empty_like(payload)
    n_live = torch.zeros((), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, n, False, dev)
    err = lib.partition_compact(
        payload.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n_live.data_ptr(), n, r, torch.cuda.current_stream(dev).cuda_stream,
    )
    launches += _launched(err, n)
    return out, n_live


def partition_rays_cuda(o, d, valid, t_limit=None):
    """Launch the kernel on rays, on the current stream; returns (queue
    [N, 8], n_live)."""
    global ray_launches
    _check_rays(o, d, valid, t_limit)
    if o.device.type != "cuda":
        raise ValueError("partition_rays_cuda needs CUDA tensors")
    lib = _load_library()
    n = o.shape[0]
    dev = o.device
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    n_live = torch.zeros((), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, n, True, dev)
    err = lib.partition_rays(
        o.data_ptr(), d.data_ptr(), valid.data_ptr(),
        None if t_limit is None else t_limit.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_live.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    ray_launches += _launched(err, n)
    return out, n_live


def partition_plain(payload: torch.Tensor):
    """The payload form in plain torch ops (any device)."""
    _check_payload(payload)
    live = payload[:, LIVE_FIELD] >= 0.0
    packed = torch.empty_like(payload)
    kept = payload[live]
    packed[: kept.shape[0]] = kept
    return packed, live.sum().to(torch.int32)


def compact_rays_plain(o, d, valid, t_limit=None):
    """The ray form in plain torch ops (any device)."""
    _check_rays(o, d, valid, t_limit)
    # the clamp keeps NaN, which is dead
    tub = (torch.full(valid.shape, T_NO_LIMIT, dtype=torch.float32,
                      device=o.device) if t_limit is None
           else torch.clamp_max(t_limit, T_NO_LIMIT))
    idx = (valid & (tub >= 0.0)).nonzero()[:, 0]
    k = idx.shape[0]
    packed = torch.empty((o.shape[0], 8), dtype=torch.float32,
                         device=o.device)
    packed[:k, 0:3] = o[idx]
    packed[:k, 3:6] = d[idx]
    packed.view(torch.int32)[:k, 6] = idx.to(torch.int32)
    packed[:k, 7] = tub[idx]
    return packed, torch.tensor(k, dtype=torch.int32, device=o.device)


def compact_live_payload(payload: torch.Tensor):
    """Stable-compact the live entries (field 7 >= 0) of a payload
    [N, R] to the front.  Returns (packed [N, R], n_live 0-d int32);
    entries past n_live are undefined.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain version."""
    if payload.device.type == "cuda":
        return partition_cuda(payload)
    if payload.device.type == "cpu":
        return partition_plain(payload)
    raise ValueError(f"no partition path for device {payload.device}")


def compact_live_rays(o, d, valid, t_limit=None):
    """The wavefront's level-0 queue of the live rays: (queue [N, 8],
    n_live 0-d int32), entries ``o.xyz d.xyz rayid tub`` of the live
    lanes in lane order, undefined past n_live.  o, d: [N, 3] float32,
    valid [N] bool, t_limit [N] float32 or None (closest-hit).

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain version."""
    if o.device.type == "cuda":
        return partition_rays_cuda(o, d, valid, t_limit)
    if o.device.type == "cpu":
        return compact_rays_plain(o, d, valid, t_limit)
    raise ValueError(f"no partition path for device {o.device}")
