"""Offline animation rendering (the ANIMATE mode's video export).

The reference's ``Application::raytrace_video`` loop
(src/application.cpp:1650-1684): rewind the timeline, and for each
frame rebuild the path tracer against the timeline-evaluated scene,
render to completion, and write ``Video_<prefix>_NNNN.png`` until the
timeline reaches its max frame.

The port of ``cuda_raytracer_tpu/apps/animate.py``, with ``device=``
(the GPU unless the caller names another).  Each frame re-skins the
animated scene, rebuilds and flattens its BVH (the native builder when
it compiles) and uploads the tables; the CUDA kernels are built once per
process.  PNGs go through the port's ``save_png`` (no Pillow).
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np

from ..config import RenderConfig
from ..render.engine import WavefrontRenderer
from ..scene.dynamic_scene import Scene as DynamicScene
from ..utils.image import save_png
from .timeline import Timeline


def raytrace_video(
    scene: DynamicScene,
    config: RenderConfig,
    max_frame: int,
    out_dir: str = ".",
    prefix: Optional[str] = None,
    spp: Optional[int] = None,
    camera_pose: Optional[tuple] = None,
    frame_callback: Optional[Callable[[int, np.ndarray], None]] = None,
    device=None,
) -> List[str]:
    """Render every timeline frame of an animated scene to PNGs.

    Follows application.cpp:1650-1684: ``Video_<stamp>_NNNN.png`` names,
    rewind-play-step timeline drive, full re-setup per frame.  Returns
    the written file paths.

    camera_pose: optional ``(pos, c2w)`` world camera held fixed across
    frames (otherwise each frame uses the scene's canonical placement,
    like the GUI's current camera).
    """
    timeline = Timeline(max_frame)
    timeline.action_rewind()
    timeline.action_play()
    if prefix is None:
        prefix = f"Video_{int(time.time())}_"
    os.makedirs(out_dir, exist_ok=True)

    renderer = WavefrontRenderer(config, device=device)
    paths: List[str] = []
    while True:
        t = timeline.get_current_frame()
        static = scene.get_transformed_static_scene(float(t))
        renderer.load_static_scene(static)
        if camera_pose is not None:
            pos, c2w = camera_pose
            renderer.camera.pos = np.asarray(pos, dtype=np.float64)
            renderer.camera.c2w = np.asarray(c2w, dtype=np.float64)
        img = renderer.render_to(spp)
        path = os.path.join(out_dir, f"{prefix}{t:04d}.png")
        save_png(path, renderer.get_image())
        paths.append(path)
        if frame_callback is not None:
            frame_callback(t, img)
        timeline.step()
        if timeline.get_current_frame() == timeline.get_max_frame():
            timeline.action_stop()
            timeline.action_rewind()
            break
    return paths
