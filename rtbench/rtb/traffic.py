"""The render job: one general generator for every workload file.

A job is a closed loop of images.  An image is ``frames_per_image``
frames accumulated from a camera reset; each image's camera is the
configuration's, turned ``orbit_deg`` further about the vertical axis
through the look-at point than the last image's.  With
``orbit_span_deg`` the turn sweeps back and forth across that span,
centred on the configuration's camera (a viewer looking about a room
from its door), instead of going round.  After each frame the image is
copied to the host where ``copy`` says so: ``"every"`` frame (a
display) or the image's ``"last"`` (a render queue)."""

from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple

import numpy as np


class Frame(NamedTuple):
    image: int          # the image's number in the job
    index: int          # the frame's number within its image (0-based)
    reset: bool         # the camera is placed (and the image reset) first
    copy: bool          # the image is copied to the host after the frame
    last: bool          # the image's last frame


def pose(camera: Dict, job: Dict, image: int):
    """(origin, look_at) of image ``image``."""
    look = np.asarray(camera["look_at"], np.float64)
    rel = np.asarray(camera["origin"], np.float64) - look
    deg = job.get("orbit_deg", 0.0) * image
    span = job.get("orbit_span_deg")
    if span:
        # a triangle wave: 0 at image 0, up to span / 2, down to -span / 2
        phase = (deg + span / 2) % (2 * span)
        deg = (phase if phase <= span else 2 * span - phase) - span / 2
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return look + rot @ rel, look


def frames(job: Dict) -> Iterator[Frame]:
    """The job's frames, without end."""
    n = int(job["frames_per_image"])
    copy = job["copy"]
    if copy not in ("every", "last"):
        raise ValueError(f"copy policy {copy!r}")
    image = 0
    while True:
        for i in range(n):
            last = i == n - 1
            yield Frame(image, i, i == 0, copy == "every" or last, last)
        image += 1
