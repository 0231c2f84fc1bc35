"""What decides ``correct``: the images the window copied to the host,
held against the plain reference (reference.py) at pixels drawn from
the seed.

A sample of the window's host copies is kept while it runs (a reservoir
per kind of image, drawn from the seed: the film, or, in the frames
that run it, the 3x3 median of the film).  After the window each kept
image is traced again by the reference at ``pixels`` of its pixels
(``median_pixels`` for median images, whose every pixel needs its nine
neighbours), over every frame accumulated into it, with the frames'
own indices and cameras.  The numbers compared, each against its limit
in the workload file (``check.limits``):

* ``median_rel_err``: the median over the compared pixel channels of
  |image - reference| / max(|reference|, REL_FLOOR);
* ``bad_share``: the share of those channels whose relative gap passes
  BAD_REL;
* ``nonfinite``: the values of the kept images, every pixel, that are
  not finite (limit 0).
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

#: radiance under which a gap is measured against this floor, not the
#: reference's value (dark pixels)
REL_FLOOR = 1e-2
#: a channel whose relative gap passes this is counted in bad_share
BAD_REL = 1e-3


class Keeper:
    """A reservoir of ``size`` host copies per kind of image, drawn with
    the run's seed: each copy offered has the same chance to be kept."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.kept: Dict[str, List[Dict]] = {}
        self.seen: Dict[str, int] = {}

    def offer(self, kind: str, record_fn) -> None:
        """Offer the next copy of ``kind``; ``record_fn()`` makes its
        record (called only when it is kept)."""
        n = self.seen.get(kind, 0) + 1
        self.seen[kind] = n
        kept = self.kept.setdefault(kind, [])
        if len(kept) < self.size:
            kept.append(record_fn())
        else:
            j = self.rng.randrange(n)
            if j < self.size:
                kept[j] = record_fn()

    def records(self) -> List[Dict]:
        return [r for kind in sorted(self.kept) for r in self.kept[kind]]


def pixels_for(seed: int, number: int, width: int, height: int,
               count: int) -> np.ndarray:
    """``count`` distinct pixel ids of image ``number``, from the
    seed."""
    rng = np.random.default_rng([seed, number])
    count = min(count, width * height)
    return np.sort(rng.choice(width * height, size=count, replace=False))


def reference_values(scene: Dict, render: Dict, camera: Dict,
                     records: List[Dict], seed: int, check: Dict,
                     dtype=None, device="cpu"):
    """The reference's values (in ``dtype``, float64 by default) at each
    record's chosen pixels, for the built ``scene`` rendered with
    ``render`` (the renderer's seed in it) through ``camera``'s lens: a
    list of (pixels, values [P, 3] float64 numpy)."""
    import torch

    from . import catalog, reference

    kinds = {li["kind"]: catalog.light_kind(li["kind"])
             for li in scene["lights"]}
    ref = reference.Reference(
        reference.scene_arrays_of(scene["meshes"], scene["spheres"],
                                  scene["materials"], scene["lights"]),
        render, kinds, torch.float64 if dtype is None else dtype, device)
    out = []
    for rec in records:
        count = check["median_pixels"] if rec["median"] else check["pixels"]
        pix = pixels_for(seed, rec["number"], render["width"],
                         render["height"], count)
        frames = [(fi, reference.camera_of(origin, look, camera["hfov_deg"],
                                           camera["vfov_deg"]))
                  for fi, origin, look in rec["frames"]]
        vals = ref.image(frames, pix, median=rec["median"])
        out.append((pix, vals.double().cpu().numpy()))
    return out


def values_at(images: List[np.ndarray], refs) -> List[np.ndarray]:
    """Each image's values at its chosen pixels (those of ``refs``)."""
    return [np.asarray(img, np.float64).reshape(-1, 3)[pix]
            for img, (pix, _) in zip(images, refs)]


def count_nonfinite(images: List[np.ndarray]) -> int:
    return sum(int((~np.isfinite(np.asarray(img))).sum()) for img in images)


def gaps(got: List[np.ndarray], refs) -> np.ndarray:
    """Every compared channel's relative gap (inf where not finite)."""
    out = []
    for g, (_, want) in zip(got, refs):
        gap = np.abs(g - want) / np.maximum(np.abs(want), REL_FLOOR)
        out.append(np.where(np.isfinite(gap), gap, np.inf).reshape(-1))
    return np.concatenate(out) if out else np.zeros(0)


def quantiles(got: List[np.ndarray], refs) -> Dict:
    """The gaps' 50th, 75th, 90th and 99th percentiles and largest (for
    the log; not compared)."""
    gap = gaps(got, refs)
    if not gap.size:
        return {}
    qs = np.percentile(gap, [50, 75, 90, 99, 100])
    return dict(zip(("p50", "p75", "p90", "p99", "max"),
                    (float(q) for q in qs)))


def compare(got: List[np.ndarray], refs, limits: Dict,
            nonfinite: int) -> Dict:
    """The compared numbers of the values ``got`` (values_at) against
    the reference's (reference_values), each with its limit;
    ``nonfinite``: the kept images' values that are not finite."""
    gap = gaps(got, refs)
    numbers = {
        "median_rel_err": float(np.median(gap)) if gap.size else
        float("inf"),
        "bad_share": float((gap > BAD_REL).mean()) if gap.size else 1.0,
        "nonfinite": float(nonfinite),
    }
    return {k: {"value": v, "limit": float(limits[k])}
            for k, v in numbers.items()}


def passed(compared: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def lines(compared: Dict) -> List[str]:
    return [f"compared {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in compared.items()]
