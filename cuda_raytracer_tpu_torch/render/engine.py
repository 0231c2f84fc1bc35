"""The wavefront renderer.

The port of ``cuda_raytracer_tpu/render/engine.py``'s WavefrontRenderer:
it owns the flattened device scene and accumulates frames of
``samples_per_frame`` spp with reset-on-move semantics and the
threshold-gated median filter.  PyTorch runs eagerly, so there is no
jit: a frame is raygen, the bounce loop of render/bounce.py and the
film, launched in order on the device.

Whole-depth compaction (cfg.compact_depths) takes effect when
``0 < rr_start_depth < max_depth`` and the frame is "fused":
``fuse_frame="yes"``, or ``"auto"`` on the GPU (the JAX engine's rule,
where "auto" means the TPU).  Then the depths from rr_start_depth on
run over the live lanes only: the path state is partitioned, the live
count read on the host and rounded up to a per-depth capacity bucket
(sticky across frames: it grows, never shrinks, and a scene load resets
it), and each depth runs over that many lanes, re-partitioned between
depths.  The buckets and so the draws are the JAX engine's.

``stage_times`` holds host seconds, as the JAX engine's does: ``frame``
(each render(), up to a device sync), ``bvh_build``, ``flatten`` and
``upload`` (each scene load, flatten_scene's steps), and, with the
environment variable ``CRT_TIME_DEPTHS`` set, ``depth{i}`` per depth
and, under compaction, ``partition`` (the first) and
``partition{depth}`` (after a compacted depth), each behind a device
sync.

``load_scene`` reads a COLLADA document (scene/collada.py) into the
dynamic scene, flattens its static form and places the camera.  Camera
modes: "canonical" (the Scotty3D orbit placement), "collada" (the .dae
camera node; without one the camera is placed canonically, then
set_viewpoint moves it, as bench.py does) and "cutracer" (the CUDA
renderer's basis with its fixed frustum; needs a .dae camera).
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import rng
from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve_device
from ..ops import filters as F
from ..ops import shade as S
from ..scene import static_scene as st
from ..scene.camera import Camera, CutracerCamera
from ..scene.collada import load_scene_info
from ..scene.dynamic_scene import load_from_scene_info
from ..utils.timing import LapTimer, block_until_ready
from ..ops.partition import compact_live_payload
from .bounce import (
    initial_carry,
    make_stage_fns,
    pack_state,
    run_bounce_loop,
    run_depth,
    run_depth_compacted,
)
from .flatscene import FlatScene, flatten_scene


#: "canonical" = the Scotty3D orbit placement; "collada" = the .dae
#: camera node transform; "cutracer" = the CUDA renderer's basis with
#: its fixed frustum
CAMERA_MODES = ("canonical", "collada", "cutracer")


class WavefrontRenderer:
    """End-to-end renderer: load_scene / load_static_scene / setup /
    render / get_image / set_viewpoint, on ``device`` (the GPU unless the
    caller names another)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 camera_mode: str = "canonical", device=None):
        if camera_mode not in CAMERA_MODES:
            raise ValueError(f"camera_mode {camera_mode!r} is not one of "
                             f"{CAMERA_MODES}")
        self.config = config
        self.camera_mode = camera_mode
        self.device = resolve_device(device)
        self.scene: Optional[FlatScene] = None
        self.static_scene: Optional[st.Scene] = None
        self.dynamic_scene = None
        self.camera: Optional[Camera] = None
        self.cutracer_camera: Optional[CutracerCamera] = None
        self.bvh = None
        self.frame_index = 0
        self.image_samples = 0
        self._final_image = None
        self._post_image = None
        self._stages = None
        self._dropped = 0
        #: per compacted depth, its capacity bucket (lanes); set up anew
        #: with the stages, so a scene load resets it
        self._depth_buckets: Dict[int, int] = {}
        self.stage_times: Dict[str, float] = {}

    def load_scene(self, path: str) -> None:
        """Load a COLLADA document: its dynamic scene, then the static
        scene, camera and cutracer camera (load_static_scene)."""
        info = load_scene_info(path)
        dscene, cam_info, cam_xf, cut_cam = load_from_scene_info(info)
        self.dynamic_scene = dscene
        self.load_static_scene(dscene.get_static_scene(), cam_info, cam_xf,
                               cut_cam)

    def load_static_scene(self, sscene: st.Scene, cam_info=None,
                          cam_transform=None, cut_cam=None) -> None:
        cfg = self.config
        self.scene, self.bvh = flatten_scene(
            sscene,
            tree_width=cfg.tree_width,
            max_leaf_size=cfg.max_leaf_size,
            sah_bins=cfg.sah_bins,
            device=self.device,
            times=self.stage_times,
        )
        self.static_scene = sscene

        camera = Camera()
        if cam_info is not None:
            camera.configure(cam_info, cfg.width, cfg.height)
        else:
            camera.hFov, camera.vFov = 50.0, 35.0
            camera.screenW, camera.screenH = cfg.width, cfg.height
        if self.camera_mode == "collada" and cam_transform is not None:
            # the .dae node transform with the reference's +0.75y lift
            pos = (cam_transform @ np.array([0, 0, 0, 1.0]))[:3]
            pos = pos + np.array([0.0, 0.75, 0.0])
            rot = cam_transform[:3, :3]
            z = -rot @ np.array([0.0, 0.0, -1.0])  # backward dir
            x = rot @ np.array([1.0, 0.0, 0.0])
            y = rot @ np.array([0.0, 1.0, 0.0])
            camera.pos = pos
            camera.c2w = np.stack(
                [x / np.linalg.norm(x), y / np.linalg.norm(y),
                 z / np.linalg.norm(z)],
                axis=1,
            )
        else:
            bb_min, bb_max = sscene.bbox()
            if cam_transform is not None and cam_info is not None:
                c_dir = (cam_transform @ np.append(cam_info.view_dir, 1.0))[:3]
                nrm = np.linalg.norm(c_dir)
                c_dir = c_dir / nrm if nrm > 0 else np.array([0.0, 0.0, 1.0])
            else:
                c_dir = np.array([0.0, 0.0, 1.0])
            camera.place_canonical(bb_min, bb_max, c_dir)
        self.camera = camera
        self.cutracer_camera = cut_cam
        self._reset_accumulation()
        self._stages = None

    def setup(self) -> None:
        cfg = self.config
        if cfg.sample_order == "tiles8":
            self._pix_order = "tiles8"
            rank = S.tiles8_rank(cfg.width, cfg.height)
        elif cfg.sample_order == "tiles32s":
            self._pix_order = "tiles32s"
            rank = S.tiles32s_rank(cfg.width, cfg.height)
        else:
            self._pix_order = None
            rank = None
        self._inv_order = (None if rank is None else
                           torch.as_tensor(rank, device=self.device))
        self._stages = make_stage_fns(cfg)
        self._depth_buckets = {}

    @property
    def compacting(self) -> bool:
        """Whether a frame runs whole-depth compaction (see the module's
        docstring)."""
        cfg = self.config
        fuse = cfg.fuse_frame == "yes" or (
            cfg.fuse_frame == "auto" and self.device.type == "cuda")
        return bool(fuse and cfg.compact_depths and cfg.rr_start_depth
                    and cfg.rr_start_depth < cfg.max_depth)

    def bucket(self, depth: int, n_live: int, n_cur: int) -> int:
        """The lanes a compacted depth runs over: n_live rounded up to a
        grain of n_cur / 32 (at least 1024, a multiple of 1024), at most
        n_cur; sticky per depth (reused while it holds n_live)."""
        g = max(1024, -(-n_cur // 32 // 1024) * 1024)
        m = min(n_cur, max(-(-n_live // g) * g, 1024))
        prev = self._depth_buckets.get(depth)
        if prev is not None and m <= prev <= n_cur:
            m = prev
        self._depth_buckets[depth] = m
        return m

    def _run_compacted(self, carry, key, lap):
        """The frame's depths from rr_start_depth on, over the live
        lanes (``carry``: the state after the dense depths).  Returns
        (light, dropped)."""
        cfg, J = self.config, self._stages
        o, d, valid, importance, light, ce, dropped = carry
        ids = torch.arange(o.shape[0], dtype=torch.int32, device=o.device)
        packed, n_live = compact_live_payload(
            pack_state(o, d, valid, importance, ce, ids))
        nl = int(n_live)
        lap("partition", packed)
        for depth in range(cfg.rr_start_depth, cfg.max_depth):
            if nl == 0:
                break
            m = self.bucket(depth, nl, packed.shape[0])
            packed_m, light, dr = run_depth_compacted(
                J, cfg, self.scene, packed, nl, light, key, depth, m)
            dropped = dropped + dr
            lap(f"depth{depth}", light)
            if depth + 1 < cfg.max_depth:
                packed, n_live = compact_live_payload(packed_m)
                nl = int(n_live)
                lap(f"partition{depth}", packed)
        return light, dropped

    def _raygen(self, key):
        cfg = self.config
        if self.camera_mode == "cutracer":
            return S.generate_camera_rays_cutracer(
                rng.fold_in(key, 0),
                cfg.width, cfg.height, cfg.samples_per_frame,
                *self._cutracer_arrays(),
                pix_order=self._pix_order,
                device=self.device,
            )
        return S.generate_camera_rays(
            rng.fold_in(key, 0),
            cfg.width, cfg.height, cfg.samples_per_frame,
            self.camera.pos, self.camera.c2w,
            math.tan(math.radians(self.camera.hFov) / 2),
            math.tan(math.radians(self.camera.vFov) / 2),
            pix_order=self._pix_order,
            device=self.device,
        )

    def _cutracer_arrays(self):
        if self.cutracer_camera is None:
            raise ValueError("scene has no collada camera for cutracer mode")
        return self.cutracer_camera.as_arrays()

    def _film(self, light, with_median: bool):
        cfg = self.config
        img = F.reconstruct(light, cfg.width, cfg.height,
                            cfg.samples_per_frame,
                            inv_order=self._inv_order,
                            sample_major=cfg.sample_order == "tiles32s")
        final = F.accumulate(
            self._final_image, img, float(self.image_samples),
            float(cfg.samples_per_frame),
        )
        post = (F.median_filter_3x3(final, cfg.reference_compat)
                if with_median else final)
        return final, post

    def _reset_accumulation(self) -> None:
        cfg = self.config
        self._final_image = torch.zeros(
            (cfg.height, cfg.width, 3), dtype=torch.float32,
            device=self.device,
        )
        self._post_image = None
        self.image_samples = 0

    def render(self) -> None:
        """Trace one frame of samples_per_frame spp and accumulate it."""
        if self._stages is None:
            self.setup()
        cfg = self.config
        t0 = time.perf_counter()
        key = rng.fold_in(rng.PRNGKey(cfg.seed), self.frame_index)
        o, d = self._raygen(key)

        def lap(name, fence):
            pass

        if os.environ.get("CRT_TIME_DEPTHS"):
            timer = LapTimer()
            block_until_ready((o, d))
            timer.start()

            def lap(name, fence):
                self.stage_times[name] = timer.lap(name, fence)

        if self.compacting:
            carry = initial_carry(o, d)
            for depth in range(cfg.rr_start_depth):
                carry = run_depth(self._stages, cfg, self.scene, carry, key,
                                  depth)
                lap(f"depth{depth}", carry)
            light, dropped = self._run_compacted(carry, key, lap)
        else:
            light, dropped = run_bounce_loop(
                self._stages, cfg, self.scene, o, d, key,
                after_depth=lambda depth, carry: lap(f"depth{depth}", carry),
            )
        with_median = self.image_samples < cfg.post_process_threshold
        final, post = self._film(light, with_median)
        self._dropped = int(dropped)
        block_until_ready((final, post))
        self.stage_times["frame"] = time.perf_counter() - t0
        self._final_image = final
        self._post_image = post
        self.image_samples += cfg.samples_per_frame
        self.frame_index += 1

    def render_to(self, total_spp: Optional[int] = None) -> np.ndarray:
        """Accumulate frames until total_spp samples/pixel, then return
        the image."""
        target = total_spp or self.config.total_samples
        while self.image_samples < target:
            self.render()
        return self.get_image()

    def get_image(self) -> np.ndarray:
        if (self.image_samples < self.config.post_process_threshold
                and self._post_image is not None):
            return self._post_image.cpu().numpy()
        return self._final_image.cpu().numpy()

    def get_raw_image(self) -> np.ndarray:
        return self._final_image.cpu().numpy()

    def set_viewpoint(self, origin, look_at) -> None:
        cam = self.camera
        origin = np.asarray(origin, dtype=np.float64)
        look_at = np.asarray(look_at, dtype=np.float64)
        z = origin - look_at  # backward
        z = z / np.linalg.norm(z)
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        cam.pos = origin
        cam.c2w = np.stack([x, y, z], axis=1)
        if self.cutracer_camera is not None:
            # as the JAX engine does: only origin and look_at move (left
            # and up keep the .dae basis), and look_at takes the forward
            # direction -z
            self.cutracer_camera.origin = origin
            self.cutracer_camera.look_at = -z
        self._reset_accumulation()

    # -- checkpoint / resume: the JAX engine's .npz keys, so a checkpoint
    # written by either package loads into the other ---------------------
    def save_checkpoint(self, path: str) -> None:
        if self._final_image is None:
            raise RuntimeError("nothing to checkpoint: no frame rendered yet")
        np.savez(
            path,
            final_image=self._final_image.cpu().numpy(),
            image_samples=self.image_samples,
            frame_index=self.frame_index,
            seed=self.config.seed,
            width=self.config.width,
            height=self.config.height,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if (int(data["width"]), int(data["height"])) != (
            self.config.width, self.config.height
        ):
            raise ValueError("checkpoint resolution mismatch")
        if int(data["seed"]) != self.config.seed:
            raise ValueError("checkpoint RNG seed mismatch")
        self._final_image = torch.as_tensor(
            np.asarray(data["final_image"], np.float32), device=self.device
        )
        self.image_samples = int(data["image_samples"])
        self.frame_index = int(data["frame_index"])
        self._post_image = None

    @property
    def dropped(self) -> int:
        """Rays the last frame's traversals cut off (0 when all is well)."""
        return self._dropped

    @property
    def mrays_per_frame(self) -> float:
        """Total rays traced per frame (camera + shadow + bounce), in
        millions — bench.py's accounting."""
        cfg = self.config
        return cfg.rays_per_frame * self.traces_per_frame / 1e6

    @property
    def traces_per_frame(self) -> int:
        cfg = self.config
        traversals = 1
        for depth in range(cfg.max_depth):
            num_nee, _ = (cfg.nee_schedule[depth]
                          if depth < len(cfg.nee_schedule) else (0, 0.0))
            traversals += num_nee * max(self.scene.num_lights, 1)
            if depth + 1 < cfg.max_depth:
                traversals += 1
        return traversals
