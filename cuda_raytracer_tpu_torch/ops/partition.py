"""Live-entry compaction of a payload: the kernel and its plain version.

The port of ``cuda_raytracer_tpu/ops/pallas/partition.py``.  Russian
roulette kills most lanes at the deeper depths; the wavefront traversal
(ops/wavefront2.py) merges its hits by ray id, so a queue compacted to
its live entries needs no inverse permutation, and every later sweep
covers live entries only.

The payload here is **entry-major**, [N, R] float32 (R = 8 for a
wavefront queue entry ``o.xyz d.xyz rayid tub``, 16 for a whole path
state), where the JAX package keeps the TPU's lane layout [R, N]; an
entry is live when its field 7 is >= 0.

* ``compact_live_payload`` — the wrapper: launches the kernel for CUDA
  tensors (or raises), runs the plain version for CPU tensors.
* ``partition_cuda`` — the launch of ops/csrc/partition.cu (count, scan,
  scatter; stable and the same from run to run); ``launches`` counts it.
* ``partition_plain`` — the same function by boolean-mask indexing.

Both return ``(packed [N, R], n_live)``, ``n_live`` a 0-d int32 tensor
on the payload's device: the live entries in their original order at
the front, every entry past them dead (all zero, field 7 = -1).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

#: field of an entry that carries its liveness (tub; >= 0 is live)
LIVE_FIELD = 7
#: entries per block of the kernel (sizes its scratch)
BLOCK = 1024

#: kernel launches since the count was last set to 0
launches = 0

_lib = None


def _load_library():
    global _lib
    if _lib is None:
        lib = load_library("partition")
        fn = lib.partition_compact
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
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


def partition_cuda(payload: torch.Tensor):
    """Launch the kernel on the current stream; returns (packed,
    n_live)."""
    global launches
    _check_payload(payload)
    if payload.device.type != "cuda":
        raise ValueError("partition_cuda needs CUDA tensors")
    lib = _load_library()
    n, r = payload.shape
    dev = payload.device
    out = torch.empty_like(payload)
    n_live = torch.zeros((), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(-(-n // BLOCK), 1),), dtype=torch.int32,
                          device=dev)
    err = lib.partition_compact(
        payload.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n_live.data_ptr(), n, r, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"partition kernel launch failed: cuda error {err}")
    if n:  # the C side launches nothing for an empty payload
        launches += 1
    return out, n_live


def partition_plain(payload: torch.Tensor):
    """The kernel's function in plain torch ops (any device)."""
    _check_payload(payload)
    live = payload[:, LIVE_FIELD] >= 0.0
    packed = torch.zeros_like(payload)
    packed[:, LIVE_FIELD] = -1.0
    kept = payload[live]
    packed[: kept.shape[0]] = kept
    return packed, live.sum().to(torch.int32)


def compact_live_payload(payload: torch.Tensor):
    """Stable-compact the live entries (field 7 >= 0) of a payload
    [N, R] to the front.  Returns (packed [N, R], n_live 0-d int32);
    entries past n_live are dead (zeros, field 7 = -1).

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain version."""
    if payload.device.type == "cuda":
        return partition_cuda(payload)
    if payload.device.type == "cpu":
        return partition_plain(payload)
    raise ValueError(f"no partition path for device {payload.device}")
