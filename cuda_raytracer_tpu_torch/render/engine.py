"""The wavefront renderer.

The port of ``cuda_raytracer_tpu/render/engine.py``'s WavefrontRenderer:
it owns the flattened device scene and accumulates frames of
``samples_per_frame`` spp with reset-on-move semantics and the
threshold-gated median filter.  PyTorch runs eagerly, so there is no
fuse/jit split: a frame is raygen, the bounce loop of render/bounce.py
and the film, launched in order on the device.

Camera modes "canonical" and "collada" are ported ("collada" without a
.dae transform places the camera canonically, then set_viewpoint moves
it, as bench.py does).  ``load_scene`` (COLLADA) and the "cutracer"
mode are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve_device
from ..ops import filters as F
from ..ops import shade as S
from ..scene import static_scene as st
from ..scene.camera import Camera
from .bounce import make_stage_fns, run_bounce_loop
from .flatscene import FlatScene, flatten_scene


class WavefrontRenderer:
    """End-to-end renderer: load_static_scene / setup / render /
    get_image / set_viewpoint, on ``device`` (the GPU unless the caller
    names another)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 camera_mode: str = "canonical", device=None):
        if camera_mode not in ("canonical", "collada"):
            raise NotImplementedError(
                f"camera_mode {camera_mode!r} is not ported yet "
                "(ROADMAP queue 1 item 8)"
            )
        self.config = config
        self.camera_mode = camera_mode
        self.device = resolve_device(device)
        self.scene: Optional[FlatScene] = None
        self.camera: Optional[Camera] = None
        self.bvh = None
        self.frame_index = 0
        self.image_samples = 0
        self._final_image = None
        self._post_image = None
        self._stages = None
        self._dropped = 0

    def load_static_scene(self, sscene: st.Scene, cam_info=None,
                          cam_transform=None) -> None:
        cfg = self.config
        self.scene, self.bvh = flatten_scene(
            sscene,
            tree_width=cfg.tree_width,
            max_leaf_size=cfg.max_leaf_size,
            sah_bins=cfg.sah_bins,
            device=self.device,
        )

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

    def _raygen(self, key):
        cfg = self.config
        return S.generate_camera_rays(
            rng.fold_in(key, 0),
            cfg.width, cfg.height, cfg.samples_per_frame,
            self.camera.pos, self.camera.c2w,
            math.tan(math.radians(self.camera.hFov) / 2),
            math.tan(math.radians(self.camera.vFov) / 2),
            pix_order=self._pix_order,
            device=self.device,
        )

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
        key = rng.fold_in(rng.PRNGKey(cfg.seed), self.frame_index)
        o, d = self._raygen(key)
        light, dropped = run_bounce_loop(
            self._stages, cfg, self.scene, o, d, key
        )
        with_median = self.image_samples < cfg.post_process_threshold
        final, post = self._film(light, with_median)
        self._dropped = int(dropped)  # waits for the frame
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
