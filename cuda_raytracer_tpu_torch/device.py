"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU.

    There is no silent CPU fallback: without CUDA the caller has to ask
    for the CPU by name (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
