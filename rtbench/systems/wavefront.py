"""The port's WavefrontRenderer on one device, driven through its
public calls (load_static_scene, set_viewpoint, render, get_image,
dropped, stage_times).

A system file gives ``Renderer(scene, render, camera, render_seed,
device)`` with ``devices`` (those it runs on), ``load_times`` (the
scene load's stage times), ``frames`` (frames rendered), ``place``,
``frame``, ``image`` and ``close``; the workload file names it
(``"system"``).  A light of the scene becomes the port's class that its
kind's file names (``lights/<kind>.py``).
"""

from __future__ import annotations

from typing import Dict

from rtb import catalog


def port_scene(scene: Dict):
    """The benchmark's scene as the port's static scene."""
    from cuda_raytracer_tpu_torch.scene import bsdf as B
    from cuda_raytracer_tpu_torch.scene import static_scene as st

    def make(m):
        kind = m["kind"]
        if kind == "diffuse":
            return B.DiffuseBSDF(m["albedo"])
        if kind == "mirror":
            return B.MirrorBSDF(m["reflectance"])
        if kind == "refraction":
            return B.RefractionBSDF(m["transmittance"], m["roughness"],
                                    m["ior"])
        if kind == "glass":
            return B.GlassBSDF(m["transmittance"], m["reflectance"],
                               m["roughness"], m["ior"])
        if kind == "emission":
            return B.EmissionBSDF(m["radiance"])
        raise ValueError(f"material kind {kind!r}")

    bsdfs = [make(m) for m in scene["materials"]]
    objects = [st.Mesh(m["positions"], m["normals"], m["indices"],
                       bsdfs[m["material"]]) for m in scene["meshes"]]
    objects += [st.SphereObject(s["center"], s["radius"],
                                bsdfs[s["material"]])
                for s in scene["spheres"]]
    lights = []
    for li in scene["lights"]:
        kind = catalog.light_kind(li["kind"])
        lights.append(getattr(st, kind.PORT_CLASS)(
            *[li[k] for k in kind.PORT_ARGS]))
    return st.Scene(objects, lights)


class Renderer:
    """One renderer of the cell's settings on the scene, on ``device``."""

    def __init__(self, scene: Dict, render: Dict, camera: Dict,
                 render_seed: int, device: str = "cuda"):
        from cuda_raytracer_tpu_torch.config import RenderConfig
        from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

        fields = {k: (tuple(tuple(x) for x in v) if k == "nee_schedule"
                      else v) for k, v in render.items()}
        self.config = RenderConfig(**fields, seed=render_seed)
        self.r = WavefrontRenderer(self.config, camera_mode="collada",
                                   device=device)
        self.devices = [device]
        self.r.load_static_scene(port_scene(scene))
        self.load_times = dict(self.r.stage_times)
        self.r.camera.hFov = float(camera["hfov_deg"])
        self.r.camera.vFov = float(camera["vfov_deg"])
        self.frames = 0

    def place(self, origin, look_at) -> None:
        """Move the camera (which starts a new image)."""
        self.r.set_viewpoint(origin, look_at)

    def frame(self) -> int:
        """Render one frame; returns the rays its traversals dropped."""
        self.r.render()
        self.frames += 1
        return int(self.r.dropped)

    def image(self):
        """The displayed image on the host (numpy [H, W, 3])."""
        return self.r.get_image()

    def close(self) -> None:
        del self.r
