#!/usr/bin/env python3
"""Time the camera rays' kernel and the 3x3 median of one tree.

    python3 tools/torch_ends_ab.py [--tree PATH]

Imports ``cuda_raytracer_tpu_torch`` from PATH (default: this checkout;
PATH may be an unpacked earlier commit) and times, with this checkout's
``chip_smoke.cuda_time_ms`` (CUDA events behind a device sleep, each
call after a 256 MB write that empties L2, the mean of 20 calls):

* ``generate_camera_rays_cuda`` with a ``KeyTable`` key and the camera on
  the card, at run A's layout (800x600, 32 spp, tiles32s), run G's pass
  (800x600, 2 spp, raster) and chip_smoke's ``ODD_RAYGEN`` (tiles32s);
* ``median_filter_3x3_cuda`` on an 800x600 image of uniform values and
  on chip_smoke's ``TIE_IMAGE``, default and compat.

Prints the card's name and power limit first, then one line per call
with its bound (chip_smoke's ``_bound``: raygen by its draws' integer and
its float operations, the median by bytes).  Prints a digest of each
output, so two trees' outputs can be compared.  To compare two trees, run
both in one call, in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.tree), HERE]

    import importlib.util

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py (its timing), whatever tree is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.ops import filters as F
    from cuda_raytracer_tpu_torch.ops import shade as S

    print(f"card: {cs.smi_line()}; tree {os.path.abspath(args.tree)}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def timed(fn):
        return cs.cuda_time_ms(fn, args.reps, prep=flush.zero_)

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:12]

    table = rng.KeyTable(["k"], dev)
    table.load({"k": cs.RNG_KEY})
    pos = torch.tensor([0.0, 0.75, 2.5], device=dev)
    c2w = torch.eye(3, device=dev)
    tans = (math.tan(math.radians(25.0)), math.tan(math.radians(19.0)))
    for label, (w, h, spp, order) in (
            ("run A (tiles32s)", (cs.WIDTH, cs.HEIGHT, 32, "tiles32s")),
            ("run G pass (raster)", (cs.WIDTH, cs.HEIGHT, 2, None)),
            ("odd (tiles32s)", (*cs.ODD_RAYGEN, "tiles32s"))):
        def call():
            return S.generate_camera_rays_cuda(
                table["k"], w, h, spp, pos, c2w, *tans, pix_order=order,
                device=dev)[1]

        n = w * h * spp
        b = cs._bound(12 * n, cs.RAYGEN_FLOPS * n, int_ops=2 * cs.RNG_INT_OPS
                      * n)
        ms = timed(call)
        print(f"[raygen] {label}: {w}x{h}, {spp} spp, {n:,} lanes: "
              f"{ms:.4f} ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']}"
              f" ({b['bound_ms'] / ms:.1%}); d digest {digest(call())}")
    g = np.random.default_rng(16)
    images = {
        "uniform": torch.as_tensor(
            g.random((cs.HEIGHT, cs.WIDTH, 3), dtype=np.float32), device=dev),
        "ties": torch.as_tensor(cs.tie_image(*cs.TIE_IMAGE), device=dev),
    }
    for name, img in images.items():
        for compat in (False, True):
            b = cs._bound(2 * img.numel() * 4, 0)
            ms = timed(lambda: F.median_filter_3x3_cuda(img, compat))
            out = F.median_filter_3x3_cuda(img, compat)
            print(f"[median] {name} {cs.WIDTH}x{cs.HEIGHT}, "
                  f"{'compat' if compat else 'default'}: {ms:.4f} ms, bound "
                  f"{b['bound_ms']:.5f} ms by bytes "
                  f"({b['bound_ms'] / ms:.1%}); digest {digest(out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
