"""Tile-scheduled path tracer with the Scotty3D PathTracer surface: the
renderer's independent oracle.

The port of ``cuda_raytracer_tpu/render/pathtracer.py``: the
INIT/READY/VISUALIZE/RENDERING/DONE state machine, the 32x32-tile work
queue drained by worker threads, set_scene/set_camera/set_frame_size/
update_screen, save_image, and the BVH visualize mode with node descent
(all on the host, as in the reference).

The integrator (NEE + BSDF sampling, brute-force closest hits over all
primitives) runs in float64 torch ops on ``device`` (the GPU unless the
caller names another), as the reference runs float64 numpy.  It follows
numpy's types and operation order: the scene's tables stay float32 and
are widened where numpy widens them (a float32 product stays float32;
mixing with a float64 operand widens), sums over xyz add x + y first,
then z, and cross products are numpy's formula.  Its randomness is the
reference's: numpy Generators, one per worker
(``default_rng(15618 + tid)``), drawn on the host in the reference's
order and moved to the device, so on equal inputs a tile equals the
reference's up to float64 rounding.  An area light's per-lane draws
(``rng.random(2)`` each) are made as one ``rng.random((k, 2))``, the
same stream; other lights keep the reference's per-lane loop.
"""

from __future__ import annotations

import enum
import math
import queue
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..scene import static_scene as st
from ..scene.bsdf import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    BSDF_GLASS,
    BSDF_MIRROR,
    BSDF_REFRACTION,
)
from ..scene.camera import Camera
from .flatscene import PRIM_SPHERE

F64 = torch.float64
#: ray-prim pairs per chunk of the brute-force closest hit, which keeps
#: about 40 [n, m] float64 temporaries live: on the CPU 2 MB each, a size
#: the caches hold (the reference's 2,000,000 pairs make 16 MB ones); on
#: the GPU 134 MB each, about 5 GB in all
_CHUNK_PAIRS = {"cpu": 1 << 18, "cuda": 1 << 24}


def _sum3(x):
    """Sum over the last axis (3) in numpy's order: (x + y) + z."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _cross(a, b):
    """numpy's cross product of [..., 3] operands (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm(x, keepdim=False):
    """numpy's linalg.norm over the last axis."""
    n = torch.sqrt(_sum3(x * x))
    return n[..., None] if keepdim else n


class State(enum.Enum):
    """PathTracer states (src/pathtracer.h:196-202)."""

    INIT = 0
    READY = 1
    VISUALIZE = 2
    RENDERING = 3
    DONE = 4


class WorkQueue:
    """Thread-safe work queue (src/work_queue.h:11-50)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()

    def put_work(self, item, count: int = 1) -> None:
        for _ in range(count):
            self._q.put(item)

    def get_work(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def clear(self) -> None:
        while self.get_work() is not None:
            pass


class WorkItem:
    """One tile (src/pathtracer.h companion struct)."""

    def __init__(self, tile_x: int, tile_y: int, tile_w: int, tile_h: int):
        self.tile_x, self.tile_y = tile_x, tile_y
        self.tile_w, self.tile_h = tile_w, tile_h


class PathTracer:
    """Tile-scheduled renderer with the Scotty3D surface; the integrator
    runs on ``device``."""

    TILE = 32  # 32x32 tiles (pathtracer.cpp:201-205)

    def __init__(self, ns_aa: int = 8, max_ray_depth: int = 4,
                 ns_area_light: int = 1, num_threads: int = 4,
                 max_leaf_size: int = 4, device=None):
        self.state = State.INIT
        self.ns_aa = ns_aa
        self.max_ray_depth = max_ray_depth
        self.ns_area_light = ns_area_light
        self.num_threads = num_threads
        self.max_leaf_size = max_leaf_size
        self.device = resolve_device(device)
        self.camera: Optional[Camera] = None
        self.scene: Optional[st.Scene] = None
        self.w = self.h = 0
        self.sample_buffer: Optional[np.ndarray] = None
        self.work_queue = WorkQueue()
        self.workers: List[threading.Thread] = []
        self._tiles_done = 0
        self._tiles_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # visualize-mode state (pathtracer.cpp:249-392)
        self.selection_history: List = []
        self._flat = None

    # -- configuration (pathtracer.cpp:71-127) ---------------------------
    def set_scene(self, scene: st.Scene) -> None:
        self.scene = scene
        self._build_accel()
        if self.camera is not None and self.w:
            self.state = State.READY

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        if self.scene is not None and self.w:
            self.state = State.READY

    def set_frame_size(self, width: int, height: int) -> None:
        self.w, self.h = width, height
        self.sample_buffer = np.zeros((height, width, 3), dtype=np.float64)
        #: per-pixel squared standard error of the pixel-mean estimate
        #: (sample variance / ns_aa), for z-tests against other
        #: estimators of the same integral
        self.se2_buffer = np.zeros((height, width, 3), dtype=np.float64)
        if self.scene is not None and self.camera is not None:
            self.state = State.READY

    def _build_accel(self) -> None:
        """BVH build (build_accel, pathtracer.cpp:215-239): the flat
        scene's float32 tables on the device, and the binary BVH for the
        visualize mode."""
        from .flatscene import flatten_scene

        flat, bvh = flatten_scene(self.scene, max_leaf_size=self.max_leaf_size,
                                  device=self.device)
        self._flat = {
            k: getattr(flat, k)
            for k in (
                "prim_type", "v0", "v1", "v2", "n0", "n1", "n2",
                "prim_bsdf", "bsdf_fn", "bsdf_albedo", "bsdf_radiance",
                "bsdf_ior",
            )
        }
        env = next((l for l in self.scene.lights
                    if isinstance(l, st.EnvironmentLight)), None)
        self._envmap = (None if env is None else
                        torch.as_tensor(env.envmap, device=self.device))
        self._bvh = bvh
        self.selection_history = [bvh.root]

    # -- BVH visualization (pathtracer.cpp:249-392) ----------------------
    def visualize_accel(self) -> np.ndarray:
        """Depth-shaded wireframe of the currently selected BVH node's
        children: the headless analog of the GL visualize mode."""
        node = self.selection_history[-1]
        img = np.zeros((self.h or 256, self.w or 256, 3), np.float32)
        boxes = []
        if node.l is not None:
            boxes.append((node.l.bb_min, node.l.bb_max, (1.0, 0.3, 0.3)))
        if node.r is not None:
            boxes.append((node.r.bb_min, node.r.bb_max, (0.3, 0.3, 1.0)))
        boxes.append((node.bb_min, node.bb_max, (1.0, 1.0, 1.0)))
        cam = self.camera
        if cam is None:
            return img
        h, w, _ = img.shape
        for bmin, bmax, color in boxes:
            corners = np.array(
                [[bmin[0] if i & 1 else bmax[0],
                  bmin[1] if i & 2 else bmax[1],
                  bmin[2] if i & 4 else bmax[2]] for i in range(8)]
            )
            w2c = cam.c2w.T
            rel = (corners - cam.pos) @ w2c.T
            z = -rel[:, 2]
            ok = z > 1e-6
            sx = rel[:, 0] / np.where(ok, z, 1) / math.tan(
                math.radians(cam.hFov) / 2)
            sy = rel[:, 1] / np.where(ok, z, 1) / math.tan(
                math.radians(cam.vFov) / 2)
            px = ((sx + 1) / 2 * (w - 1)).astype(int)
            py = ((1 - (sy + 1) / 2) * (h - 1)).astype(int)
            edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6),
                     (5, 7), (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
            for a, b in edges:
                if not (ok[a] and ok[b]):
                    continue
                n = 32
                xs = np.linspace(px[a], px[b], n).astype(int)
                ys = np.linspace(py[a], py[b], n).astype(int)
                m_ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
                img[ys[m_ok], xs[m_ok]] = color
        return img

    def key_press(self, key: str) -> None:
        """BVH descent keys (pathtracer.cpp keyboard handling):
        '<' left child, '>' right child, 'up' parent."""
        node = self.selection_history[-1]
        if key in ("<", "left") and node.l is not None:
            self.selection_history.append(node.l)
        elif key in (">", "right") and node.r is not None:
            self.selection_history.append(node.r)
        elif key in ("up", "u") and len(self.selection_history) > 1:
            self.selection_history.pop()

    # -- rendering (start_raytracing, pathtracer.cpp:183-213) ------------
    def start_raytracing(self) -> None:
        if self.scene is None or self.camera is None:
            raise RuntimeError("start_raytracing needs a scene and a camera")
        self.state = State.RENDERING
        self._stop.clear()
        self.work_queue.clear()
        self.sample_buffer[:] = 0
        tiles = []
        for ty in range(0, self.h, self.TILE):
            for tx in range(0, self.w, self.TILE):
                tiles.append(WorkItem(tx, ty, min(self.TILE, self.w - tx),
                                      min(self.TILE, self.h - ty)))
        self._tiles_total = len(tiles)
        self._tiles_done = 0
        for t in tiles:
            self.work_queue.put_work(t)
        self.workers = [
            threading.Thread(target=self._worker_thread, args=(i,), daemon=True)
            for i in range(self.num_threads)
        ]
        for worker in self.workers:
            worker.start()

    def stop(self) -> None:
        self._stop.set()
        self.work_queue.clear()
        for worker in self.workers:
            worker.join(timeout=5)
        self.workers = []
        self.state = State.READY

    def is_done(self) -> bool:
        if self.state != State.RENDERING:
            return self.state == State.DONE
        with self._lock:
            done = self._tiles_done >= self._tiles_total
        if done:
            self.state = State.DONE
        return done

    def _worker_thread(self, tid: int) -> None:
        """worker_thread loop (pathtracer.cpp:537-558)."""
        rng = np.random.default_rng(15618 + tid)
        while not self._stop.is_set():
            item = self.work_queue.get_work()
            if item is None:
                return
            self.raytrace_tile(item, rng)
            with self._lock:
                self._tiles_done += 1

    # -- integrator -------------------------------------------------------
    def _rays(self, x, y):
        """Camera rays (host, float64) on the device."""
        o, d = self.camera.generate_rays(x, y)
        return (torch.as_tensor(o, device=self.device),
                torch.as_tensor(d, device=self.device))

    def raytrace_tile(self, item: WorkItem, rng) -> None:
        """raytrace_tile (pathtracer.cpp:510-535), batched over the
        tile's pixel-samples."""
        tw, th = item.tile_w, item.tile_h
        n = tw * th * self.ns_aa
        pix = np.arange(tw * th)
        px = item.tile_x + (pix % tw)
        py = item.tile_y + (pix // tw)
        px = np.repeat(px, self.ns_aa)
        py = np.repeat(py, self.ns_aa)
        u = rng.random((n, 2))
        x = (px + u[:, 0]) / self.w
        y = (py + u[:, 1]) / self.h
        o, d = self._rays(x, 1.0 - y)
        radiance = self._trace(o, d, rng).cpu().numpy()
        per_pix = radiance.reshape(tw * th, self.ns_aa, 3)
        acc = per_pix.mean(axis=1)
        se2 = per_pix.var(axis=1, ddof=1) / self.ns_aa
        self.sample_buffer[
            item.tile_y : item.tile_y + th, item.tile_x : item.tile_x + tw
        ] = acc.reshape(th, tw, 3)
        self.se2_buffer[
            item.tile_y : item.tile_y + th, item.tile_x : item.tile_x + tw
        ] = se2.reshape(th, tw, 3)

    def raytrace_pixel(self, x: int, y: int, rng=None) -> np.ndarray:
        """raytrace_pixel (stub at pathtracer.cpp:499-508; implemented):
        estimate one pixel with ns_aa samples."""
        rng = rng or np.random.default_rng(15618)
        u = rng.random((self.ns_aa, 2))
        xs = (x + u[:, 0]) / self.w
        ys = 1.0 - (y + u[:, 1]) / self.h
        o, d = self._rays(xs, ys)
        return self._trace(o, d, rng).cpu().numpy().mean(axis=0)

    def _closest_hit(self, o, d):
        """Brute-force closest hit of rays o, d ([n, 3] float64 on the
        device) over all primitives: (t [n] float64, prim [n] int64, -1
        on a miss).  Chunked over the prims; ties go to the lowest prim
        index whatever the chunking (argmin takes the first minimum, and
        a later chunk must be strictly closer)."""
        f = self._flat
        n = o.shape[0]
        best_t = torch.full((n,), math.inf, dtype=F64, device=o.device)
        best_p = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        P = f["v0"].shape[0]
        chunk = max(1, _CHUNK_PAIRS[o.device.type] // max(n, 1))
        # per component, [n, 1]: the [n, m] products below are numpy's
        # [n, m, 3] ones, axis by axis, never stacked
        oc = [o[:, k:k + 1] for k in range(3)]
        dc = [d[:, k:k + 1] for k in range(3)]
        for s in range(0, P, chunk):
            e = min(s + chunk, P)
            v0 = f["v0"][s:e]
            v1 = f["v1"][s:e]
            v2 = f["v2"][s:e]
            is_sph = f["prim_type"][s:e] == PRIM_SPHERE
            # triangles: the plane in float32, as the reference's tables
            nrm = _cross(v1 - v0, v2 - v0)
            nrm64 = nrm.to(F64)
            denom = d @ nrm64.T  # [n, m]
            t_tri = (_sum3(nrm * v0)[None, :] - (o @ nrm64.T)) / denom
            p = [oc[k] + t_tri * dc[k] for k in range(3)]

            def inside(a, v):
                """cross(a, p - v) . nrm >= 0, a and v [m, 3]."""
                q = [p[k] - v[:, k] for k in range(3)]
                a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
                c0 = a1 * q[2] - a2 * q[1]
                c1 = a2 * q[0] - a0 * q[2]
                c2 = a0 * q[1] - a1 * q[0]
                return (c0 * nrm[:, 0] + c1 * nrm[:, 1]) + c2 * nrm[:, 2] >= 0

            ok_tri = ((denom.abs() > 1e-12) & inside(v1 - v0, v0)
                      & inside(v2 - v1, v1) & inside(v0 - v2, v2)
                      & (t_tri >= 0))
            # spheres: v0 the centre, v1.x the radius
            q = [oc[k] - v0[:, k] for k in range(3)]
            b = 2 * ((q[0] * dc[0] + q[1] * dc[1]) + q[2] * dc[2])
            c = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) \
                - (v1[:, 0] ** 2)[None, :]
            disc = b * b - 4 * c
            sq = torch.sqrt(torch.clamp(disc, min=0))
            t1 = (-b - sq) / 2
            t2 = (-b + sq) / 2
            t_sph = torch.where(t1 > 0, t1, t2)
            ok_sph = (disc >= 0) & (t_sph > 0)
            t = torch.where(is_sph[None, :], t_sph, t_tri)
            ok = torch.where(is_sph[None, :], ok_sph, ok_tri)
            t = torch.where(ok, t, math.inf)
            tk, k = t.min(dim=1)
            better = tk < best_t
            best_t = torch.where(better, tk, best_t)
            best_p = torch.where(better, k + s, best_p)
        return best_t, best_p

    def _occluded(self, o, d, max_t):
        t, p = self._closest_hit(o, d)
        return (p >= 0) & (t < max_t - 1e-3)

    def _sample_light(self, sl, pt, rng):
        """sample_L of light ``sl`` at points pt ([k, 3] float64 on the
        device), in lane order: (radiance, wi, dist, pdf) on the
        device."""
        k = pt.shape[0]
        dev = pt.device
        if isinstance(sl, st.AreaLight):
            # k calls of rng.random(2) draw the numbers of one
            # rng.random((k, 2))
            s = torch.as_tensor(rng.random((k, 2)) - 0.5, device=dev)
            pos, dx, dy, dirn = (torch.as_tensor(a, device=dev) for a in (
                sl.position, sl.dim_x, sl.dim_y, sl.direction))
            dd = pos + s[:, 0:1] * dx + s[:, 1:2] * dy - pt
            cos_theta = _sum3(dd * dirn)
            sq_dist = _sum3(dd * dd)
            dist = torch.sqrt(sq_dist)
            wi = dd / dist[:, None]
            pdf = sq_dist / (sl.area * cos_theta.abs())
            rad = torch.where((cos_theta < 0)[:, None],
                              torch.as_tensor(sl.radiance, device=dev), 0.0)
            return rad, wi, dist, pdf
        pts = pt.cpu().numpy()
        rad = np.zeros((k, 3))
        wi = np.zeros((k, 3))
        dist = np.zeros(k)
        pdf = np.zeros(k)
        for i in range(k):
            rad[i], wi[i], dist[i], pdf[i] = sl.sample_L(pts[i], rng)
        return tuple(torch.as_tensor(a, device=dev)
                     for a in (rad, wi, dist, pdf))

    def _env_radiance(self, d):
        """EnvironmentLight.sample_dir for each direction of d [k, 3]."""
        h, w, _ = self._envmap.shape
        d = d / _norm(d, keepdim=True)
        theta = torch.arccos(torch.clamp(d[:, 1], -1, 1))
        phi = torch.remainder(torch.atan2(d[:, 2], d[:, 0]), 2 * np.pi)
        iy = torch.clamp((theta / np.pi * h).long(), max=h - 1)
        ix = torch.clamp((phi / (2 * np.pi) * w).long(), max=w - 1)
        return self._envmap[iy, ix]

    def _trace(self, o, d, rng):
        """trace_ray over a ray batch (the integrator the reference left
        as a stub, pathtracer.cpp:395-497): emission on counted hits,
        NEE at diffuse vertices, uniform-hemisphere / specular bounces.
        Returns the radiance [n, 3] float64 on the device."""
        f = self._flat
        n = o.shape[0]
        dev = o.device

        def draw(*shape):
            return torch.as_tensor(rng.random(shape), device=dev)

        light = torch.zeros((n, 3), dtype=F64, device=dev)
        importance = torch.ones((n, 3), dtype=F64, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        count_emission = torch.ones(n, dtype=torch.bool, device=dev)
        y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=F64, device=dev)
        x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=F64, device=dev)
        for depth in range(self.max_ray_depth):
            t, p = self._closest_hit(o, d)
            hit = (p >= 0) & alive
            if self._envmap is not None:
                # escaped counted paths pick up the environment
                miss = alive & (p < 0) & count_emission
                idx = torch.nonzero(miss)[:, 0]
                if idx.numel():
                    light[idx] += importance[idx] * self._env_radiance(d[idx])
            if not bool(hit.any()):
                break
            pidx = torch.where(hit, p, 0)
            t_safe = torch.where(hit, t, 0.0)
            pt = o + t_safe[:, None] * d
            is_sph = f["prim_type"][pidx] == PRIM_SPHERE
            # normals
            v0, v1, v2 = f["v0"][pidx], f["v1"][pidx], f["v2"][pidx]
            nrm_t = _cross(v1 - v0, v2 - v0)
            tot = _norm(nrm_t, keepdim=True) + 1e-20
            bC = _norm(_cross(v0 - pt, v1 - pt)) / tot[:, 0]
            bA = _norm(_cross(v1 - pt, v2 - pt)) / tot[:, 0]
            bB = _norm(_cross(v2 - pt, v0 - pt)) / tot[:, 0]
            nsm = (bA[:, None] * f["n0"][pidx] + bB[:, None] * f["n1"][pidx]
                   + bC[:, None] * f["n2"][pidx])
            n_sph = pt - v0
            nrm = torch.where(is_sph[:, None], n_sph, nsm)
            nrm = nrm / (_norm(nrm, keepdim=True) + 1e-20)
            flip = _sum3(nrm * d) > 0
            nrm = torch.where(flip[:, None], -nrm, nrm)

            bidx = f["prim_bsdf"][pidx]
            fn = f["bsdf_fn"][bidx]
            albedo = f["bsdf_albedo"][bidx]
            emission = f["bsdf_radiance"][bidx]
            ior = f["bsdf_ior"][bidx]

            emit_mask = hit & count_emission & (fn == BSDF_EMISSION)
            light = torch.where(emit_mask[:, None],
                                light + importance * emission, light)

            # NEE at diffuse vertices
            diffuse = hit & (fn == BSDF_DIFFUSE)
            idxs = torch.nonzero(diffuse)[:, 0]
            if idxs.numel():
                for sl in self.scene.lights:
                    for _ in range(self.ns_area_light):
                        rad = torch.zeros((n, 3), dtype=F64, device=dev)
                        wi = torch.zeros((n, 3), dtype=F64, device=dev)
                        dist = torch.full((n,), math.inf, dtype=F64,
                                          device=dev)
                        pdf = torch.ones(n, dtype=F64, device=dev)
                        (rad[idxs], wi[idxs], dist[idxs],
                         pdf[idxs]) = self._sample_light(sl, pt[idxs], rng)
                        cos_s = _sum3(nrm * wi).abs()
                        contrib = (importance * albedo / np.pi
                                   * (cos_s / torch.clamp(pdf, min=1e-12))[:, None]
                                   * rad / self.ns_area_light)
                        active = diffuse & (_sum3(rad) > 0) & (cos_s > 1e-4)
                        act = torch.nonzero(active)[:, 0]
                        if act.numel():
                            occ = torch.ones(n, dtype=torch.bool, device=dev)
                            # the shadow origin is offset 1e-3 along the
                            # normal, so the light-point distance from
                            # that origin shrinks by ~cos*1e-3; measure
                            # maxT from the offset origin or the
                            # pass/occlude threshold sits knife-edge on
                            # hits against the light quad itself
                            cos_off = _sum3(nrm * wi)
                            occ[act] = self._occluded(
                                pt[act] + nrm[act] * 1e-3,
                                wi[act],
                                dist[act] - cos_off[act] * 1e-3,
                            )
                            add = active & (~occ)
                            light = torch.where(add[:, None],
                                                light + contrib, light)

            if depth + 1 >= self.max_ray_depth:
                break

            # scatter
            u1 = draw(n)
            u2 = draw(n)
            cos_t = (2 * u1 - 1).abs()
            sin_t = torch.sqrt(torch.clamp(1 - cos_t ** 2, min=0))
            phi = 2 * np.pi * u2
            guide = torch.where(
                ((nrm[:, 1] < 1e-4) & (nrm[:, 1] > -0.999))[:, None],
                y_axis, x_axis)
            dpdu = _cross(guide, nrm)
            dpdu = dpdu / (_norm(dpdu, keepdim=True) + 1e-20)
            dpdv = _cross(dpdu, nrm)
            d_dif = ((sin_t * torch.cos(phi))[:, None] * dpdu
                     + (sin_t * torch.sin(phi))[:, None] * dpdv
                     + cos_t[:, None] * nrm)
            thr_dif = albedo * (2 * _sum3(d_dif * nrm).abs())[:, None]

            wo = -d
            d_mir = wo - 2 * _sum3(wo * nrm)[:, None] * nrm
            d_mir = -d_mir
            thr_mir = albedo

            # refraction/glass (entering if not flipped); ior, eta and r0
            # stay float32, as the reference's
            eta = torch.where(flip, ior, 1.0 / torch.clamp(ior, min=1e-6))
            cos_o = torch.clamp(_sum3(wo * nrm), 1e-6, 1.0)
            sin2 = eta ** 2 * torch.clamp(1 - cos_o ** 2, min=0.0)
            tir = sin2 >= 1.0
            cos_tr = torch.sqrt(torch.clamp(1 - sin2, min=0.0))
            d_ref = (-eta[:, None] * (wo - cos_o[:, None] * nrm)
                     - cos_tr[:, None] * nrm)
            r0 = ((1 - ior) / (1 + ior)) ** 2
            fres = r0 + (1 - r0) * (1 - cos_o) ** 5
            fres = torch.where(tir, 1.0, fres)
            pick_r = draw(n) < fres
            refl = (pick_r | tir)[:, None]
            d_glass = torch.where(refl, d_mir, d_ref)
            thr_glass = torch.where(refl, emission, albedo * (eta ** 2)[:, None])
            d_refr = torch.where(tir[:, None], d_mir, d_ref)
            thr_refr = torch.where(tir[:, None], albedo,
                                   albedo * (eta ** 2)[:, None])

            is_dif = (fn == BSDF_DIFFUSE)[:, None]
            is_mir = (fn == BSDF_MIRROR)[:, None]
            is_refr = (fn == BSDF_REFRACTION)[:, None]
            d_new = torch.where(is_dif, d_dif, torch.where(
                is_mir, d_mir, torch.where(is_refr, d_refr, d_glass)))
            thr = torch.where(is_dif, thr_dif, torch.where(
                is_mir, thr_mir, torch.where(is_refr, thr_refr, thr_glass)))
            is_delta = ((fn == BSDF_MIRROR) | (fn == BSDF_REFRACTION)
                        | (fn == BSDF_GLASS))
            transmit = (((fn == BSDF_REFRACTION)
                         | ((fn == BSDF_GLASS) & ~pick_r)) & ~tir)
            offs = torch.where(transmit[:, None], -1e-3 * nrm, 1e-3 * nrm)
            o = pt + offs
            dnl = _norm(d_new, keepdim=True) + 1e-20
            d = d_new / dnl
            importance = importance * thr
            alive = (hit & (fn != BSDF_EMISSION)
                     & (importance.amax(dim=1) > 1e-6))
            count_emission = is_delta
            if not bool(alive.any()):
                break
        return light

    # -- output (save_image, pathtracer.cpp:577-591) ----------------------
    def save_image(self, filename: str, tonemapped: bool = True) -> None:
        from ..utils.image import save_png

        img = self.sample_buffer
        if tonemapped:
            img = (np.clip(img, 0, None) * np.sqrt(2.0)) ** (1.0 / 2.2)
        save_png(filename, img)

    def update_screen(self) -> Tuple[int, int]:
        """Progress for a UI poll loop: (tiles done, total)."""
        with self._lock:
            return self._tiles_done, self._tiles_total
