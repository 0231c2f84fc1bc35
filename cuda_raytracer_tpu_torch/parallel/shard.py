"""Multi-card rendering: one frame sharded over a mesh of devices.

The port of ``cuda_raytracer_tpu/parallel/shard.py``.  JAX's shard_map
is one controller driving the devices of one host; here one process
drives a **mesh**: an ordered list of ``torch.device``s, one shard per
entry.  There is no process group: shard ``i`` runs on ``mesh[i]``
under that device's guard (the kernels launch on the thread's current
device, with the stream of their tensors' device), and its result comes
back to ``mesh[0]``.  An entry may repeat a device: the CPU tests run
8 shards on the one CPU device, as the JAX tests run them on 8 virtual
host devices.  The scene is copied once to each distinct device.

The two modes of config.shard_mode:

* ``samples``: shard ``i`` traces the full image with
  ``spp // n`` samples per pixel under ``fold_in(key, i)``; the shards'
  images are averaged on ``mesh[0]`` in shard order (JAX's pmean).
* ``tiles``: shard ``i`` renders rows ``[i*rows, (i+1)*rows)`` with the
  full spp (a height=rows frame whose sensor window is shifted), and the
  slabs are concatenated by rows on ``mesh[0]``.

Each shard runs the shared bounce loop (render/bounce.py), not the
engine's compacted frame, so cfg.compact_depths has no effect here, as
in the JAX package.

Where the JAX package jits the sharded frame, ``ShardedRenderer``
(``compile`` and ``render``) captures each shard's trace of its slab,
under the shard's device guard, as one CUDA graph (render/graphs.py)
and replays them, under the engine's rule: ``fuse_frame="yes"``, or
``"auto"`` when every shard is on the GPU.  Each shard then reads its
key table (bounce.frame_keys of its key) and the camera from static
buffers on its device, refreshed before the frame; the shards' images
are combined eagerly.  ``render_frame_sharded`` stays the eager frame.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from collections.abc import Mapping
from typing import List, Optional

import numpy as np
import torch

from .. import rng
from ..config import RenderConfig
from ..ops import filters as F
from ..ops import shade as S
from ..render.backends import xla_passes
from ..render.bounce import frame_keys, make_stage_fns, run_bounce_loop
from ..render.flatscene import FlatScene
from ..render.graphs import FrameGraphs
from ..utils.timing import block_until_ready


def make_render_mesh(devices=None) -> List[torch.device]:
    """The mesh: ``devices`` as torch.devices, in order, or every
    visible CUDA device.  Without CUDA and without ``devices`` it
    raises: the CPU has to be named (``["cpu"] * n``), as
    device.resolve_device asks."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu', ...] to "
                "shard over the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("the mesh needs at least one device")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in mesh]


def _on(device: torch.device):
    """Make ``device`` the thread's current device while a shard runs
    (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _replicas(scene: FlatScene, mesh) -> List[FlatScene]:
    """The scene on each entry's device: one copy per distinct device."""
    copies = {scene.v0.device: scene}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = scene.to(dev)
    return [copies[dev] for dev in mesh]


def _order_arrays(cfg: RenderConfig, device=None):
    """(pix_order, inv_order, sample_major) for cfg.sample_order: the
    engine's swizzle (render/engine.py setup), so each shard honours
    the configured sample order."""
    if cfg.sample_order == "tiles8":
        rank = S.tiles8_rank(cfg.width, cfg.height)
        return "tiles8", torch.as_tensor(rank, device=device), False
    if cfg.sample_order == "tiles32s":
        rank = S.tiles32s_rank(cfg.width, cfg.height)
        return "tiles32s", torch.as_tensor(rank, device=device), True
    return None, None, False


def _trace_slab(scene: FlatScene, cfg: RenderConfig, cam_arrays, key,
                hfov_t, vfov_t, spp: int, row_offset: int = 0,
                full_height: Optional[int] = None, orders=None):
    """spp samples per pixel of a cfg.height-row frame whose rows start
    at ``row_offset`` of a ``full_height``-row sensor, on the scene's
    device (``orders``: _order_arrays of cfg there, made if None).
    ``key``: the shard's key, or the table bounce.frame_keys derives
    from it (a rng.KeyTable for a captured frame); ``cam_arrays``: the
    camera's (pos, c2w), arrays or tensors on the scene's device.
    Returns (image [cfg.height, W, 3], dropped)."""
    pos, c2w = cam_arrays
    dev = scene.v0.device
    pix_order, inv_order, sample_major = (
        _order_arrays(cfg, dev) if orders is None else orders)
    keys = (key if isinstance(key, Mapping)
            else frame_keys(cfg, scene.num_lights, key))
    o, d = S.generate_camera_rays(
        keys["raygen"], cfg.width, cfg.height, spp, pos, c2w,
        hfov_t, vfov_t, pix_order=pix_order, row_offset=row_offset,
        full_height=full_height, device=dev,
    )
    light, dropped = run_bounce_loop(make_stage_fns(cfg), cfg, scene, o, d,
                                     keys)
    img = F.reconstruct(light, cfg.width, cfg.height, spp,
                        inv_order=inv_order, sample_major=sample_major)
    return img, dropped


def _render_chunk(scene: FlatScene, cfg: RenderConfig, cam_arrays, key,
                  hfov_t, vfov_t, spp: int):
    """Trace spp samples/pixel of the full image; returns [H, W, 3] on the
    scene's device.  The schedule is the shared bounce loop."""
    return _trace_slab(scene, cfg, cam_arrays, key, hfov_t, vfov_t, spp)[0]


def _slab_config(cfg: RenderConfig, rows: int) -> RenderConfig:
    """Per-slab config for tiles-mode sharding: a height=rows frame.

    Honours cfg.sample_order within the slab whenever the slab supports
    it (tiles32s supports any height; tiles8 needs rows % 8 == 0) and
    falls back to raster, with a warning, only when it cannot."""
    if cfg.sample_order == "tiles8" and rows % 8:
        warnings.warn(
            f"shard_mode='tiles': slab height {rows} is not a multiple "
            "of 8; sample_order='tiles8' falls back to raster within "
            "each slab (use a height divisible by 8*n_chips, or "
            "tiles32s which packs partial tile rows)",
            stacklevel=2,
        )
        return cfg.replace(height=rows, sample_order="raster")
    return cfg.replace(height=rows)


def _shard_setup(mesh, cfg: RenderConfig):
    """A sharded frame's fixed inputs: (the config each shard traces,
    its spp, its order arrays on its device).  samples: the full frame at
    spp // n; tiles: a slab of height // n rows at the full spp."""
    n = len(mesh)
    if cfg.shard_mode == "samples":
        shard_cfg, spp = cfg, max(cfg.samples_per_frame // n, 1)
    else:
        if cfg.height % n:
            raise ValueError(f"shard_mode='tiles': height {cfg.height} "
                             f"does not divide over {n} shards")
        shard_cfg = _slab_config(cfg, cfg.height // n)
        spp = cfg.samples_per_frame
    # the sample-order tables are a host computation over every pixel:
    # once per distinct device, not per shard and frame
    orders = {}
    for dev in mesh:
        if dev not in orders:
            orders[dev] = _order_arrays(shard_cfg, dev)
    return shard_cfg, spp, [orders[dev] for dev in mesh]


def _sharded_frame(mesh, scenes, setup, cfg: RenderConfig, cam_arrays, key,
                   hfov_t: float, vfov_t: float):
    """One frame over the mesh, ``scenes[i]`` on ``mesh[i]``, ``setup``
    from _shard_setup.  Returns (image [H, W, 3] on mesh[0], dropped per
    shard)."""
    shard_cfg, spp, orders = setup
    tiles = cfg.shard_mode == "tiles"
    shards = []
    for i, (dev, scene) in enumerate(zip(mesh, scenes)):
        with _on(dev):
            shards.append(_trace_slab(
                scene, shard_cfg, cam_arrays, rng.fold_in(key, i), hfov_t,
                vfov_t, spp, row_offset=i * shard_cfg.height if tiles else 0,
                full_height=cfg.height, orders=orders[i]))
    return _combine(mesh, cfg, shards)


def _combine(mesh, cfg: RenderConfig, shards):
    """The shards' (image, dropped) as the frame on mesh[0] and the
    drops per shard: slabs concatenated by rows (tiles) or images
    averaged in shard order (samples)."""
    imgs = [im.to(mesh[0]) for im, _ in shards]
    img = (torch.cat(imgs, dim=0) if cfg.shard_mode == "tiles"
           else torch.stack(imgs).mean(0))
    return img, [dr for _, dr in shards]


def render_frame_sharded(mesh, scene: FlatScene, cfg: RenderConfig,
                         cam_arrays, key, hfov_t: float, vfov_t: float):
    """One sharded frame of cfg.samples_per_frame spp over the mesh (see
    the module's docstring for the two modes); ``cam_arrays`` is the
    camera's (pos, c2w).  Returns the full [H, W, 3] frame on
    mesh[0]."""
    return _sharded_frame(mesh, _replicas(scene, mesh),
                          _shard_setup(mesh, cfg), cfg, cam_arrays, key,
                          hfov_t, vfov_t)[0]


class _ShardedFrame:
    """The sharded frame of one scene, config and frustum:
    ``frame(cam_arrays, key)`` -> (image on mesh[0], dropped per
    shard).  Fused (the engine's
    rule), each shard traces its slab from its static buffers (key
    table, camera) as one program, a CUDA graph on the GPU unless its
    traversal sizes work on the host ("xla"), else the program itself;
    unfused, it is _sharded_frame."""

    def __init__(self, mesh, scene: FlatScene, cfg: RenderConfig,
                 tan_h: float, tan_v: float):
        self.mesh, self.cfg, self.tan = mesh, cfg, (tan_h, tan_v)
        self.scenes = _replicas(scene, mesh)
        self.setup = _shard_setup(mesh, cfg)
        on_gpu = all(dev.type == "cuda" for dev in mesh)
        self.fused = cfg.fuse_frame == "yes" or (
            cfg.fuse_frame == "auto" and on_gpu)
        passes = xla_passes(cfg, scene.bvh.width)
        self.graphs = FrameGraphs(on_gpu and self.fused and not passes)
        if on_gpu and self.fused and passes:
            warnings.warn(
                f"the {', '.join(passes)} passes trace through 'xla' (tree "
                f"width {scene.bvh.width}), which sizes its queues on the "
                f"host: the shards run eagerly, not as CUDA graphs",
                stacklevel=3)
        shard_cfg = self.setup[0]
        names = frame_keys(shard_cfg, scene.num_lights, (0, 0))
        self.keys = [rng.KeyTable(names, dev) for dev in mesh]
        self.cams = [torch.zeros((12,), dtype=torch.float32, device=dev)
                     for dev in mesh]

    def __call__(self, cam_arrays, key):
        if not self.fused:
            return _sharded_frame(self.mesh, self.scenes, self.setup,
                                  self.cfg, cam_arrays, key, *self.tan)
        shard_cfg, spp, orders = self.setup
        tiles = self.cfg.shard_mode == "tiles"
        cam = torch.as_tensor(np.concatenate(
            [np.asarray(a, np.float32).reshape(-1) for a in cam_arrays]))
        shards = []
        for i, dev in enumerate(self.mesh):
            self.keys[i].load(frame_keys(shard_cfg, self.scenes[i].num_lights,
                                         rng.fold_in(key, i)))
            self.cams[i].copy_(cam)

            def slab(i=i):
                c = self.cams[i]
                return _trace_slab(
                    self.scenes[i], shard_cfg, (c[0:3], c[3:12].view(3, 3)),
                    self.keys[i], *self.tan, spp,
                    row_offset=i * shard_cfg.height if tiles else 0,
                    full_height=self.cfg.height, orders=orders[i])

            with _on(dev):
                if self.graphs.enabled and ("shard", i) not in self.graphs:
                    self.graphs.warm_up(slab, dev)
                shards.append(self.graphs.run(("shard", i), slab, dev))
        return _combine(self.mesh, self.cfg, shards)


class ShardedRenderer:
    """The engine's surface with every frame sharded over the mesh.

    load_scene / load_static_scene / set_viewpoint (reset-on-move) /
    render / render_to / get_image (median filter below
    post_process_threshold) / save_checkpoint / load_checkpoint, as
    render.engine.WavefrontRenderer has them.  Scenes and the camera
    live in an embedded WavefrontRenderer on mesh[0] (never set up:
    only its loaders and camera are used), so the two cannot drift;
    only the frame differs.  The key of frame f is
    fold_in(PRNGKey(cfg.seed), f), as in the engine, and shard i's is
    fold_in of that by i.

    ``camera_mode="cutracer"`` is refused: sharded frames take the
    pinhole camera's (pos, c2w).  (The JAX package's ShardedRenderer
    accepts the mode and fails in its first frame, unpacking the
    cutracer camera's four arrays as two.)
    """

    def __init__(self, cfg: RenderConfig, mesh=None,
                 camera_mode: str = "collada"):
        from ..render.engine import WavefrontRenderer

        if camera_mode == "cutracer":
            raise ValueError(
                "camera_mode='cutracer' is not supported by sharded "
                "frames (they take the pinhole camera's pos and c2w); use "
                "'collada' or 'canonical', or render on one device")
        self.cfg = self.config = cfg
        self.mesh = make_render_mesh(mesh)
        self._host = WavefrontRenderer(cfg, camera_mode=camera_mode,
                                       device=self.mesh[0])
        self._scenes = None
        self._dropped = 0
        self.frame_index = 0
        self.stage_times = {}

    # -- scene / camera (delegated) ------------------------------------
    def load_scene(self, path: str) -> None:
        self._host.load_scene(path)
        self._scenes = None
        self._reset_accumulation()

    def load_static_scene(self, sscene, cam_info=None, cam_transform=None,
                          cut_cam=None) -> None:
        self._host.load_static_scene(sscene, cam_info, cam_transform,
                                     cut_cam)
        self._scenes = None
        self._reset_accumulation()

    def set_viewpoint(self, origin, look_at) -> None:
        self._host.set_viewpoint(origin, look_at)
        self._reset_accumulation()

    @property
    def scene(self):
        return self._host.scene

    @property
    def camera(self):
        return self._host.camera

    @property
    def static_scene(self):
        return self._host.static_scene

    def _camera_arrays(self):
        return self.camera.pos, self.camera.c2w

    def _reset_accumulation(self) -> None:
        cfg = self.cfg
        self._final_image = torch.zeros((cfg.height, cfg.width, 3),
                                        dtype=torch.float32,
                                        device=self.mesh[0])
        self._post_image = None
        self.image_samples = 0

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        """The frame's fixed inputs: the frustum, the scene on each
        shard's device, _shard_setup's, and the shards' graphs, captured
        in the next frame."""
        cam = self.camera
        self._frame = _ShardedFrame(
            self.mesh, self.scene, self.cfg,
            math.tan(math.radians(cam.hFov) / 2),
            math.tan(math.radians(cam.vFov) / 2))
        self._scenes = self._frame.scenes
        self._setup = self._frame.setup
        self._tan = self._frame.tan

    @property
    def graphs(self) -> Optional[FrameGraphs]:
        """The shards' CUDA graphs (render/graphs.py), once set up."""
        return None if self._scenes is None else self._frame.graphs

    def compile(self, scene: FlatScene, hfov: float, vfov: float):
        """A one-frame function frame(scene, cam_arrays, key) -> image
        (the JAX package's jitted frame): on the GPU each shard's trace
        is captured as a CUDA graph on the first call and replayed after
        it; a call with another scene captures anew."""
        tan_h = math.tan(math.radians(hfov) / 2)
        tan_v = math.tan(math.radians(vfov) / 2)
        held = {}

        def frame(scene, cam_arrays, key):
            if held.get("scene") is not scene:
                held.update(scene=scene, frame=_ShardedFrame(
                    self.mesh, scene, self.cfg, tan_h, tan_v))
            return held["frame"](cam_arrays, key)[0]

        return frame

    # -- per-frame render (the engine's) ----------------------------------
    def render(self) -> None:
        """Trace one sharded frame of samples_per_frame spp and
        accumulate it."""
        if self._scenes is None:
            self.setup()
        cfg = self.cfg
        t0 = time.perf_counter()
        key = rng.fold_in(rng.PRNGKey(cfg.seed), self.frame_index)
        img, dropped = self._frame(self._camera_arrays(), key)
        final = F.accumulate(self._final_image, img,
                             float(self.image_samples),
                             float(cfg.samples_per_frame))
        with_median = self.image_samples < cfg.post_process_threshold
        post = (F.median_filter_3x3(final, cfg.reference_compat)
                if with_median else final)
        self._dropped = sum(int(x) for x in dropped)
        block_until_ready((final, post))
        self.stage_times["frame"] = time.perf_counter() - t0
        self._final_image = final
        self._post_image = post
        self.image_samples += cfg.samples_per_frame
        self.frame_index += 1

    def render_to(self, total_spp: Optional[int] = None) -> np.ndarray:
        target = total_spp or self.cfg.total_samples
        while self.image_samples < target:
            self.render()
        return self.get_image()

    def get_image(self) -> np.ndarray:
        if (self.image_samples < self.cfg.post_process_threshold
                and self._post_image is not None):
            return self._post_image.cpu().numpy()
        return self._final_image.cpu().numpy()

    def get_raw_image(self) -> np.ndarray:
        return self._final_image.cpu().numpy()

    # -- checkpoint / resume: the engine's .npz keys ---------------------
    def save_checkpoint(self, path: str) -> None:
        np.savez(
            path,
            final_image=self._final_image.cpu().numpy(),
            image_samples=self.image_samples,
            frame_index=self.frame_index,
            seed=self.cfg.seed,
            width=self.cfg.width,
            height=self.cfg.height,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if (int(data["width"]), int(data["height"])) != (
            self.cfg.width, self.cfg.height
        ):
            raise ValueError("checkpoint resolution mismatch")
        if int(data["seed"]) != self.cfg.seed:
            raise ValueError("checkpoint RNG seed mismatch")
        self._final_image = torch.as_tensor(
            np.asarray(data["final_image"], np.float32), device=self.mesh[0])
        self.image_samples = int(data["image_samples"])
        self.frame_index = int(data["frame_index"])
        self._post_image = None

    @property
    def dropped(self) -> int:
        """Rays the last frame's traversals cut off, summed over the
        shards (0 when all is well)."""
        return self._dropped

    @property
    def mrays_per_frame(self) -> float:
        return self._host.mrays_per_frame
