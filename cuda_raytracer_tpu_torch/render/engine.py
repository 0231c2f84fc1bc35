"""The wavefront renderer.

The port of ``cuda_raytracer_tpu/render/engine.py``'s WavefrontRenderer:
it owns the flattened device scene and accumulates frames of
``samples_per_frame`` spp with reset-on-move semantics and the
threshold-gated median filter.  A frame is raygen, the bounce loop of
render/bounce.py and the film.

The frame is "fused" under the JAX engine's rule: ``fuse_frame="yes"``,
or ``"auto"`` on the GPU (where the JAX engine's "auto" means the TPU).
A fused frame runs the JAX engine's programs: raygen, one per depth and
the film (with and without the median), each reading what changes from
frame to frame (the key table of bounce.frame_keys, the camera, the
sample count) from static buffers refreshed before the frame.  On the
GPU each program is a CUDA graph (render/graphs.py), captured on the
first frame after an eager warm-up frame on a side stream and replayed
after that, all of a renderer's graphs in one memory pool; a scene load
or a config change (``setup``) and a new field of view capture anew, a
new frame index, camera move or sample count does not.  On the CPU the
same programs run eagerly.  ``fuse_frame="no"`` runs the frame eagerly,
stage by stage (the JAX engine's per-stage executables).  A traversal
that sizes its work on the host (``"xla"``, which ``"auto"`` takes for
trees wider than 8) cannot be captured: such a frame runs its programs
eagerly, and ``graph_refusal`` says why.

Whole-depth compaction (cfg.compact_depths) takes effect when
``0 < rr_start_depth < max_depth`` and the frame is fused.  Then the
depths from rr_start_depth on run over the live lanes only: the path
state is partitioned, the live count read on the host, between
programs, and rounded up to a per-depth capacity bucket (sticky across
frames: it grows, never shrinks, and a scene load resets it), and each
depth runs over that many lanes, re-partitioned between depths.  The
buckets and so the draws are the JAX engine's, and, as its compacted
executables, the programs are one per depth and bucket (here: per
bucket of that depth and of each compacted depth before it, whose
outputs it reads); the live count reaches them as the partition's
device count.

``stage_times`` holds host seconds, as the JAX engine's does: ``frame``
(each render(), up to a device sync), ``bvh_build``, ``flatten`` and
``upload`` (each scene load, flatten_scene's steps), and, with the
environment variable ``CRT_TIME_DEPTHS`` set, ``depth{i}`` per depth
and, under compaction, ``partition`` (the first) and
``partition{depth}`` (after a compacted depth), each behind a device
sync, between the programs.

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
import warnings
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
from .backends import xla_passes
from .bounce import (
    frame_keys,
    initial_carry,
    make_stage_fns,
    pack_state,
    run_bounce_loop,
    run_depth,
    run_depth_compacted,
)
from .flatscene import FlatScene, flatten_scene
from .graphs import FrameGraphs


#: "canonical" = the Scotty3D orbit placement; "collada" = the .dae
#: camera node transform; "cutracer" = the CUDA renderer's basis with
#: its fixed frustum
CAMERA_MODES = ("canonical", "collada", "cutracer")


def _host_copy(img: torch.Tensor) -> np.ndarray:
    """A copy of ``img`` on the host, on the CPU too: the fused frame
    accumulates in buffers that the next frame rewrites."""
    return img.to("cpu", copy=True).numpy()


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
        #: the live lanes the last compacted frame read on the host, at
        #: each partition
        self.live_counts = []
        #: the fused frame's CUDA graphs (render/graphs.py); on the GPU
        #: unless ``graphs.enabled`` is set False, which calls the
        #: programs without capture
        self.graphs = FrameGraphs(self.device.type == "cuda")
        self._graph_fov = None

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
        # the fused frame's static inputs: its keys, the camera (pos and
        # c2w, or the cutracer origin, look_at, up and left), the sample
        # count, and the accumulated and filtered images
        dev = self.device
        self._keys = rng.KeyTable(
            frame_keys(cfg, self.scene.num_lights, (0, 0)), dev)
        self._cam = torch.zeros((12,), dtype=torch.float32, device=dev)
        self._samples = torch.zeros((), dtype=torch.float32, device=dev)
        shape = (cfg.height, cfg.width, 3)
        self._film_in = torch.zeros(shape, dtype=torch.float32, device=dev)
        self._post_out = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.graphs.reset()
        if self.graphs.enabled and self.fused and self.graph_refusal:
            warnings.warn(self.graph_refusal, stacklevel=2)

    @property
    def fused(self) -> bool:
        """Whether a frame runs the JAX engine's fused programs (see the
        module's docstring)."""
        cfg = self.config
        return cfg.fuse_frame == "yes" or (
            cfg.fuse_frame == "auto" and self.device.type == "cuda")

    @property
    def compacting(self) -> bool:
        """Whether a frame runs whole-depth compaction (see the module's
        docstring)."""
        cfg = self.config
        return bool(self.fused and cfg.compact_depths and cfg.rr_start_depth
                    and cfg.rr_start_depth < cfg.max_depth)

    @property
    def graph_refusal(self) -> Optional[str]:
        """Why a fused frame cannot be captured as CUDA graphs, or None:
        its traversal sizes work on the host."""
        passes = xla_passes(self.config, self.scene.bvh.width)
        if not passes:
            return None
        return (f"the {', '.join(passes)} passes trace through 'xla' "
                f"(tree width {self.scene.bvh.width}), which sizes its "
                f"queues on the host: the fused frame runs eagerly, not "
                f"as CUDA graphs")

    @property
    def graphed(self) -> bool:
        """Whether render() replays CUDA graphs."""
        return (self.fused and self.graphs.enabled
                and self.graph_refusal is None)

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

    def _run_compacted(self, run, carry, lap):
        """The fused frame's depths from rr_start_depth on, over the live
        lanes (``carry``: the state after the dense depths), each program
        through ``run(key, program)``.  Adds their radiance and drops to
        the carry's ``light`` and ``dropped`` in place."""
        cfg, J, scene, keys = self.config, self._stages, self.scene, self._keys
        o, d, valid, importance, light, ce, dropped = carry

        def pack():
            ids = torch.arange(o.shape[0], dtype=torch.int32, device=o.device)
            return compact_live_payload(
                pack_state(o, d, valid, importance, ce, ids))

        packed, n_live = run(("pack",), pack)
        nl = int(n_live)
        self.live_counts = [nl]
        lap("partition", packed)
        # a program reads the outputs of the programs before it, which
        # depend on their buckets: its key holds them all
        buckets = ()
        for depth in range(cfg.rr_start_depth, cfg.max_depth):
            if nl == 0:
                break
            m = self.bucket(depth, nl, packed.shape[0])
            buckets += (m,)

            def compacted(packed=packed, n_live=n_live, depth=depth, m=m):
                packed_m, _, dr = run_depth_compacted(
                    J, cfg, scene, packed, n_live, light, keys, depth, m)
                dropped.add_(dr)
                return packed_m

            packed_m = run(("depth", depth, buckets), compacted)
            lap(f"depth{depth}", light)
            if depth + 1 < cfg.max_depth:
                packed, n_live = run(
                    ("partition", depth, buckets),
                    lambda p=packed_m: compact_live_payload(p))
                nl = int(n_live)
                self.live_counts.append(nl)
                lap(f"partition{depth}", packed)

    def _raygen(self, key, camera=None):
        """Camera rays from ``key``; ``camera``: the camera's arrays as
        tensors (the fused frame's buffer), else the camera's own."""
        cfg = self.config
        if self.camera_mode == "cutracer":
            return S.generate_camera_rays_cutracer(
                key, cfg.width, cfg.height, cfg.samples_per_frame,
                *(camera or self._cutracer_arrays()),
                pix_order=self._pix_order,
                device=self.device,
            )
        return S.generate_camera_rays(
            key, cfg.width, cfg.height, cfg.samples_per_frame,
            *(camera or (self.camera.pos, self.camera.c2w)),
            *self._tan_half(),
            pix_order=self._pix_order,
            device=self.device,
        )

    def _tan_half(self):
        return (math.tan(math.radians(self.camera.hFov) / 2),
                math.tan(math.radians(self.camera.vFov) / 2))

    def _cutracer_arrays(self):
        if self.cutracer_camera is None:
            raise ValueError("scene has no collada camera for cutracer mode")
        return self.cutracer_camera.as_arrays()

    def _film(self, light, with_median: bool, final_img, image_samples):
        cfg = self.config
        final = F.film(light, final_img, image_samples,
                       float(cfg.samples_per_frame), cfg.width, cfg.height,
                       cfg.samples_per_frame, inv_order=self._inv_order,
                       sample_major=cfg.sample_order == "tiles32s")
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

    def _laps(self):
        """lap(name, fence) for CRT_TIME_DEPTHS (else a no-op): the host
        seconds since the last lap, behind a device sync, into
        stage_times[name]; lap(None, fence) starts the clock."""
        if not os.environ.get("CRT_TIME_DEPTHS"):
            return lambda name, fence: None
        timer = LapTimer()

        def lap(name, fence):
            if name is None:
                block_until_ready(fence)
                timer.start()
            else:
                self.stage_times[name] = timer.lap(name, fence)

        return lap

    def _eager_frame(self, key, with_median):
        """fuse_frame="no": the frame stage by stage, keys from the host.
        Returns (final, post, dropped)."""
        cfg = self.config
        keys = frame_keys(cfg, self.scene.num_lights, key)
        o, d = self._raygen(keys["raygen"])
        lap = self._laps()
        lap(None, (o, d))
        light, dropped = run_bounce_loop(
            self._stages, cfg, self.scene, o, d, keys,
            after_depth=lambda depth, carry: lap(f"depth{depth}", carry),
        )
        final, post = self._film(light, with_median, self._final_image,
                                 float(self.image_samples))
        return final, post, dropped

    def _fused_programs(self, run, with_median):
        """The fused frame from its static inputs (_load_inputs), each
        program through ``run(key, program)``.  Returns (final, post,
        dropped)."""
        cfg, J, scene, keys = self.config, self._stages, self.scene, self._keys
        lap = self._laps()
        cam = self._cam
        camera = ((cam[0:3], cam[3:6], cam[6:9], cam[9:12])
                  if self.camera_mode == "cutracer"
                  else (cam[0:3], cam[3:12].view(3, 3)))
        carry = run(("raygen",), lambda: initial_carry(
            *self._raygen(keys["raygen"], camera)))
        lap(None, carry)
        n_dense = cfg.rr_start_depth if self.compacting else cfg.max_depth
        for depth in range(n_dense):
            carry = run(("depth", depth), lambda c=carry, i=depth: run_depth(
                J, cfg, scene, c, keys, i))
            lap(f"depth{depth}", carry)
        if self.compacting:
            self._run_compacted(run, carry, lap)
        light, dropped = carry[4], carry[6]
        final, post = run(("film", with_median), lambda: self._film(
            light, with_median, self._film_in, self._samples))
        return final, post, dropped

    def _load_inputs(self, key) -> None:
        """Refresh the fused frame's static inputs for frame ``key``."""
        self._keys.load(frame_keys(self.config, self.scene.num_lights, key))
        if self.camera_mode == "cutracer":
            arrays = self._cutracer_arrays()
        else:
            arrays = (self.camera.pos, self.camera.c2w)
        self._cam.copy_(torch.as_tensor(np.concatenate(
            [np.asarray(a, np.float32).reshape(-1) for a in arrays])))
        self._samples.fill_(float(self.image_samples))
        if self._final_image is not self._film_in:
            self._film_in.copy_(self._final_image)

    def _fused_frame(self, key, with_median):
        """A fused frame: the programs as graphs (warm-up and capture
        first where there are none) or called directly.  Returns (final,
        post, dropped), final and post in buffers that outlive the
        frame."""
        fov = None if self.camera_mode == "cutracer" else self._tan_half()
        if fov != self._graph_fov:
            # the field of view is baked into raygen
            self.graphs.reset()
            self._graph_fov = fov
        self._load_inputs(key)
        if not self.graphed:
            final, post, dropped = self._fused_programs(
                lambda k, fn: fn(), with_median)
        else:
            dev = self.device
            if ("raygen",) not in self.graphs:
                self.graphs.warm_up(lambda: self._fused_programs(
                    lambda k, fn: fn(), with_median), dev)
            final, post, dropped = self._fused_programs(
                lambda k, fn: self.graphs.run(k, fn, dev), with_median)
        # out of the graphs' pool, which the next frame's programs reuse
        self._film_in.copy_(final)
        if not with_median:
            return self._film_in, self._film_in, dropped
        self._post_out.copy_(post)
        return self._film_in, self._post_out, dropped

    def render(self) -> None:
        """Trace one frame of samples_per_frame spp and accumulate it."""
        if self._stages is None:
            self.setup()
        cfg = self.config
        t0 = time.perf_counter()
        key = rng.fold_in(rng.PRNGKey(cfg.seed), self.frame_index)
        with_median = self.image_samples < cfg.post_process_threshold
        frame = self._fused_frame if self.fused else self._eager_frame
        final, post, dropped = frame(key, with_median)
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
            return _host_copy(self._post_image)
        return _host_copy(self._final_image)

    def get_raw_image(self) -> np.ndarray:
        return _host_copy(self._final_image)

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
