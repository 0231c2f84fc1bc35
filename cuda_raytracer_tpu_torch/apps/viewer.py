"""Headless interactive viewer: progressive preview with camera controls.

The render-mode loop of the reference application
(src/application.cpp:186-287): the path tracer accumulates frames
progressively into the view, and any camera motion restarts
accumulation — cutracer's setViewpoint reset-on-move semantics
(src/cudaRenderer.cu camera upload path).  Controls map the GUI's
mouse orbit/dolly/pan onto keys so the viewer can be driven from
scripts or a terminal:

    w/s   dolly in/out          h/l (or arrows)  orbit yaw
    a/d   pan left/right        j/k              orbit pitch
    q/e   pan down/up           r                home (reset view)

Every successful move resets the accumulation; ``frame()`` renders one
progressive sample batch and returns the tonemapped preview.

The port of ``cuda_raytracer_tpu/apps/viewer.py``: the same keys and
session slots, plus ``device=`` (``--device``, default ``cuda``): the
viewer renders on the GPU unless the caller names the CPU, and raises
when there is no GPU.

    python -m cuda_raytracer_tpu_torch.apps.viewer scene.dae --frames 8 \
        -w out.png [--size 800x600] [--device cpu]
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..config import RenderConfig
from ..render.engine import WavefrontRenderer


class InteractiveViewer:
    """Progressive viewer over a WavefrontRenderer."""

    #: orbit step per keypress (radians) and dolly/pan step (scene units)
    ROT_STEP = math.radians(10.0)
    MOVE_FRAC = 0.1

    def __init__(self, config: Optional[RenderConfig] = None,
                 scene_path: Optional[str] = None,
                 renderer: Optional[WavefrontRenderer] = None,
                 device=None):
        if renderer is None:
            renderer = WavefrontRenderer(config or RenderConfig(),
                                         device=device)
            if scene_path is not None:
                renderer.load_scene(scene_path)
        self.renderer = renderer
        cam = renderer.camera
        # scene scale for movement steps
        bb_min, bb_max = renderer.static_scene.bbox()
        self._scale = float(np.linalg.norm(bb_max - bb_min)) or 1.0
        # ensure the orbit parameterization matches the placed camera
        # so rotate_by/move_forward behave (collada placements set
        # pos/c2w directly)
        if not hasattr(cam, "targetPos") or cam.r <= 0:
            cam.targetPos = (np.asarray(bb_min) + np.asarray(bb_max)) / 2.0
        back = cam.pos - cam.targetPos
        cam.r = float(np.linalg.norm(back)) or self._scale
        if cam.r > 0:
            u = back / cam.r
            cam.phi = math.acos(np.clip(u[1], -1.0, 1.0))
            cam.theta = math.atan2(u[0], u[2])
        cam.minR = cam.r / 100.0
        cam.maxR = cam.r * 100.0
        self._home = (cam.pos.copy(), cam.c2w.copy(), cam.targetPos.copy(),
                      cam.r, cam.phi, cam.theta)
        #: session buffers (keys W/L + digit, application.h:281-296);
        #: lazily created in the scene directory (or cwd)
        self._session = None
        self._pending_session = None

    # -- controls ----------------------------------------------------------
    def key(self, ch: str) -> bool:
        """Apply one keypress.  Returns True if the view moved (and the
        accumulation was reset)."""
        cam = self.renderer.camera
        step = self._scale * self.MOVE_FRAC
        moved = True
        if ch == "w":
            cam.move_forward(step)
        elif ch == "s":
            cam.move_forward(-step)
        elif ch == "a":
            cam.move_by(-20.0, 0.0, cam.screenDist * step / 20.0)
        elif ch == "d":
            cam.move_by(20.0, 0.0, cam.screenDist * step / 20.0)
        elif ch == "q":
            cam.move_by(0.0, -20.0, cam.screenDist * step / 20.0)
        elif ch == "e":
            cam.move_by(0.0, 20.0, cam.screenDist * step / 20.0)
        elif ch in ("h", "left"):
            cam.rotate_by(0.0, self.ROT_STEP)
        elif ch in ("l", "right"):
            cam.rotate_by(0.0, -self.ROT_STEP)
        elif ch in ("j", "down"):
            cam.rotate_by(self.ROT_STEP, 0.0)
        elif ch in ("k", "up"):
            cam.rotate_by(-self.ROT_STEP, 0.0)
        elif ch == "r":
            pos, c2w, tgt, r, phi, theta = self._home
            cam.pos, cam.c2w = pos.copy(), c2w.copy()
            cam.targetPos, cam.r, cam.phi, cam.theta = tgt.copy(), r, phi, theta
        elif ch in ("W", "L"):
            # session save/load prefix: next digit picks the slot
            # (the editor's w/l + 0-9 bindings, application.h:281-296;
            # capitalized here because lowercase wasd fly the camera)
            self._pending_session = ch
            moved = False
        elif ch.isdigit() and self._pending_session:
            did = self._session_op(self._pending_session, int(ch))
            moved = did and self._pending_session == "L"
            self._pending_session = None
        else:
            moved = False
        if moved:
            self.renderer._reset_accumulation()
        return moved

    def _session_op(self, op: str, slot: int) -> bool:
        import os

        from ..scene.session import SessionManager

        if self._session is None:
            self._session = SessionManager(os.getcwd())
        dscene = self.renderer.dynamic_scene
        if op == "W":
            if dscene is None:
                return False
            self._session.save(slot, dscene)
            return True
        try:
            dscene, ci, cx, cc = self._session.load(slot)
        except FileNotFoundError:
            # empty slot: no-op, like the reference's silent failed
            # load (application.cpp load path just keeps the scene)
            return False
        self.renderer.dynamic_scene = dscene
        self.renderer.load_static_scene(
            dscene.get_static_scene(), ci, cx, cc
        )
        return True

    # -- progressive rendering ---------------------------------------------
    def frame(self) -> np.ndarray:
        """Render one progressive batch; returns the current tonemapped
        preview (running average over all batches since the last move)."""
        self.renderer.render()
        return self.renderer.get_image()

    def spin(self, n: int) -> np.ndarray:
        for _ in range(n):
            self.frame()
        return self.renderer.get_image()

    def status(self) -> Dict[str, float]:
        r = self.renderer
        return {
            "spp": float(r.image_samples),
            "frame_s": float(r.stage_times.get("frame", 0.0)),
            "mrays_per_frame": float(r.mrays_per_frame),
        }


def main(argv=None) -> int:
    """Terminal driver: read keys from stdin, print progress lines."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="progressive viewer")
    ap.add_argument("scene")
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--frames", type=int, default=0,
                    help="non-interactive: render N frames then exit")
    ap.add_argument("-w", "--write", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on ('cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from e
    viewer = InteractiveViewer(RenderConfig(width=w, height=h), args.scene,
                               device=device)
    if args.frames:
        viewer.spin(args.frames)
    else:  # interactive: one key per line
        print("keys: wasdqe move, hjkl orbit, r home, x exit", flush=True)
        for line in sys.stdin:
            ch = line.strip()
            if ch == "x":
                break
            if ch:
                viewer.key(ch)
            viewer.frame()
            st = viewer.status()
            print(f"spp={st['spp']:.0f} frame={st['frame_s'] * 1e3:.0f}ms",
                  flush=True)
    if args.write:
        from ..utils.image import save_png

        save_png(args.write, viewer.renderer.get_image())
        print(f"wrote {args.write}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
