"""The control of the check: the reference put in the program's place
and computed one precision lower (bfloat16 for the configuration's
float32), compared at the same images and pixels as a run compares.

``readings(cell, seed, images)`` takes the host copies that a window of
``images`` images (after the set-up image) would offer the keeper, keeps
them as a run keeps them, and compares the control's values against the
float64 reference's: the control's compared numbers, which have to fail
the cell's limits.  It runs no renderer."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import catalog, check, runner, traffic


def records_for(cell: Dict, seed: int, images: int):
    """The records a window of ``images`` images would keep."""
    job, camera = cell["job"], cell["config"]["camera"]
    render = job["render"]
    spf, threshold = render["samples_per_frame"], \
        render["post_process_threshold"]
    per = int(job["frames_per_image"])
    keeper = check.Keeper(seed, int(job["check"]["images"]))
    copies = 0
    frame_index = per  # the set-up image renders frames 0 .. per - 1
    it = traffic.frames(job)
    next(f for f in it if f.last)  # the set-up image
    done = 0
    frames = []
    for fr in it:
        if fr.reset:
            origin, look = traffic.pose(camera, job, fr.image)
            frames = []
        frames.append(frame_index)
        frame_index += 1
        if fr.copy:
            copies += 1
            median = (fr.index + 1) * spf < threshold
            number = copies
            rec = {"median": median, "number": number,
                   "frames": [(i, [float(x) for x in origin],
                               [float(x) for x in look]) for i in frames]}
            keeper.offer("median" if median else "film", lambda r=rec: r)
        if fr.last:
            done += 1
            if done == images:
                break
    return keeper.records()


def readings(cell: Dict, seed: int, images: int, device: str = "cuda",
             dtype=torch.bfloat16) -> Dict:
    """The control's compared numbers (each with the cell's limit), and
    under ``gaps`` the quantiles of its gaps."""
    config, job = cell["config"], cell["job"]
    scene = catalog.scene_builder(config["builder"])(config)
    render = dict(job["render"], seed=runner.render_seed(seed))
    records = records_for(cell, seed, images)
    args = (scene, render, config["camera"], records, seed, job["check"])
    want = check.reference_values(*args, device=device)
    low = check.reference_values(*args, dtype=dtype, device=device)
    got = [np.asarray(v, np.float64) for _, v in low]
    numbers = check.compare(got, want, job["check"]["limits"],
                            check.count_nonfinite(got))
    numbers["gaps"] = check.quantiles(got, want)
    return numbers
