"""Film reconstruction, accumulation and post-process filters (torch).

The port of ``cuda_raytracer_tpu/ops/filters.py`` (kernelReconstructImage
/ kernelAccumulate / kernelMedianFilter of the reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reconstruct(sample_light: torch.Tensor, width: int, height: int,
                spp: int, inv_order=None, sample_major: bool = False):
    """Box-filter the per-sample radiance [W*H*spp, 3] into an image
    [H, W, 3].  Pixel-major by default; ``sample_major`` for the
    tiles32s layout; ``inv_order`` ([H*W], inv_order[pixel] = slot)
    un-swizzles a tiled sample order."""
    if sample_major:
        means = sample_light.reshape(spp, -1, 3).mean(dim=0)
    else:
        means = sample_light.reshape(-1, spp, 3).mean(dim=1)
    if inv_order is not None:
        means = means[inv_order]
    return means.reshape(height, width, 3)


def accumulate(final_img, new_img, old_weight, new_weight):
    """Running average across frames."""
    return (final_img * old_weight + new_img * new_weight) / (
        old_weight + new_weight
    )


def median_filter_3x3(img: torch.Tensor, reference_compat: bool = False):
    """Per-channel 3x3 median.  ``reference_compat`` pads with white and
    takes the reference's "4th largest" (index 5 ascending); the default
    clamps to the edge and takes the true median (index 4)."""
    h, w, _ = img.shape
    chw = img.permute(2, 0, 1)[None]
    if reference_compat:
        pad = F.pad(chw, (1, 1, 1, 1), mode="constant", value=1.0)
    else:
        pad = F.pad(chw, (1, 1, 1, 1), mode="replicate")
    pad = pad[0].permute(1, 2, 0)  # [H+2, W+2, 3]
    views = torch.stack(
        [pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
        dim=2,
    )
    idx = 5 if reference_compat else 4
    return torch.sort(views, dim=2).values[:, :, idx, :]


def tonemap(img: torch.Tensor, gamma: float = 2.2, exposure: float = 1.0):
    """HDR -> display mapping."""
    img = 1.0 - torch.exp(-img * exposure)
    return torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)
