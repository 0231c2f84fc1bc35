"""Rays per frame, counted as bench.py counts them (dead lanes
included): every lane of the frame is one ray per trace, and a frame
makes one camera trace, per depth one shadow trace per NEE sample and
light, and one bounce trace below the last depth."""

from __future__ import annotations

from typing import Dict


def traces_per_frame(render: Dict, num_lights: int) -> int:
    schedule = render["nee_schedule"]
    traces = 1
    for depth in range(render["max_depth"]):
        num_nee = schedule[depth][0] if depth < len(schedule) else 0
        traces += num_nee * max(num_lights, 1)
        if depth + 1 < render["max_depth"]:
            traces += 1
    return traces


def lanes_per_frame(render: Dict) -> int:
    return render["width"] * render["height"] * render["samples_per_frame"]


def rays_per_frame(render: Dict, num_lights: int) -> int:
    return lanes_per_frame(render) * traces_per_frame(render, num_lights)
