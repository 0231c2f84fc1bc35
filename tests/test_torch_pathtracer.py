"""The port's PathTracer (render/pathtracer.py) against the JAX package's.

Both draw from the same numpy Generators in the same order, so on equal
scenes and cameras their tiles are equal up to float64 rounding: the
port runs the integrator as float64 torch ops (matmuls through BLAS, so
a few products round in another order than numpy's) where the JAX
package runs numpy.  Held: rtol 1e-9, atol 1e-12 on every value
(float64 ulps compound over a path's few dozen operations; a flipped
branch would differ by far more).  Equality runs use one worker thread:
with more, which worker (and so which Generator) takes a tile depends on
scheduling.  Last, the port's engine against the port's oracle by
tests/test_radiance.py's per-pixel z-test.
"""

import time

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.render import pathtracer as jax_pt
from cuda_raytracer_tpu.scene import static_scene as jax_st
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse
from cuda_raytracer_tpu.scene.camera import Camera as JaxCamera

from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.pathtracer import (
    PathTracer,
    State,
    WorkItem,
    WorkQueue,
)
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF
from cuda_raytracer_tpu_torch.scene.camera import Camera
from cuda_raytracer_tpu_torch.utils.image import load_png
from torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-9, 1e-12


def _camera(cls, w, h, pos=(0.0, 0.75, 2.5), target=(0.0, 0.75, 0.0)):
    cam = cls()
    cam.ar = w / h
    cam.pos = np.array(pos)
    back = cam.pos - np.array(target)
    back /= np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    cam.c2w = np.stack([right, up, back], axis=1)
    return cam


def _pair(scene_fn, w=48, h=32, ns_aa=4, depth=3, **cam):
    """(JAX tracer, port tracer) on the same scene and camera."""
    a = jax_pt.PathTracer(ns_aa=ns_aa, max_ray_depth=depth, num_threads=1)
    b = PathTracer(ns_aa=ns_aa, max_ray_depth=depth, num_threads=1,
                   device="cpu")
    for pt, pkg, cam_cls in ((a, "jax", JaxCamera), (b, "port", Camera)):
        pt.set_frame_size(w, h)
        pt.set_camera(_camera(cam_cls, w, h, **cam))
        pt.set_scene(scene_fn(pkg))
    return a, b


def _cornell(sphere_bsdfs="diffuse"):
    return lambda pkg: (jax_cornell if pkg == "jax" else cornell_box_scene)(
        with_spheres=True, sphere_bsdfs=sphere_bsdfs)


def _sphere_under_env(pkg):
    """tests/test_envlight.py's scene: a diffuse sphere (albedo 0.6) under
    an environment map with a brighter sky."""
    mod, bsdf = (jax_st, JaxDiffuse) if pkg == "jax" else (st, DiffuseBSDF)
    env = np.full((8, 16, 3), 0.5)
    env[:2] = 2.0
    sphere = mod.SphereObject(np.zeros(3), 1.0, bsdf(np.array([0.6] * 3)))
    return mod.Scene([sphere], [mod.EnvironmentLight(env)])


def _render(pt, timeout=120):
    pt.start_raytracing()
    deadline = time.time() + timeout
    while not pt.is_done():
        assert time.time() < deadline, "render timed out"
        time.sleep(0.01)


def _assert_close(got, want):
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (
        f"{int(bad.sum())} values off; max |diff| "
        f"{float(np.abs(got - want).max()):.3g}")


def test_work_queue():
    q = WorkQueue()
    q.put_work("a", 3)
    assert [q.get_work() for _ in range(4)] == ["a", "a", "a", None]
    q.put_work("b")
    q.clear()
    assert q.get_work() is None
    item = WorkItem(32, 0, 16, 32)
    assert (item.tile_x, item.tile_y, item.tile_w, item.tile_h) == (32, 0,
                                                                    16, 32)


def test_state_machine():
    pt = PathTracer(device="cpu")
    assert pt.state is State.INIT
    pt.set_frame_size(32, 32)
    assert pt.state is State.INIT  # still no scene/camera
    pt.set_camera(_camera(Camera, 32, 32))
    pt.set_scene(cornell_box_scene())
    assert pt.state is State.READY
    _render(pt)
    assert pt.state is State.DONE
    assert pt.update_screen() == (1, 1)
    assert [s.name for s in State] == [s.name for s in jax_pt.State]


@pytest.mark.parametrize("spheres", ["diffuse", "glass"])
def test_tiles_match_jax(spheres):
    """A full render (a 32x32 tile and a 16x32 one): sample and standard
    error buffers on every pixel; "glass" is one mirror and one glass
    sphere."""
    a, b = _pair(_cornell(spheres))
    _render(a)
    _render(b)
    assert b.update_screen() == a.update_screen() == (2, 2)
    assert b.sample_buffer.max() > 0.05
    _assert_close(b.sample_buffer, a.sample_buffer)
    _assert_close(b.se2_buffer, a.se2_buffer)


def test_env_light_tiles_match_jax():
    """Misses pick up the environment; NEE samples it lane by lane."""
    a, b = _pair(_sphere_under_env, w=32, h=24, ns_aa=8, depth=4,
                 pos=(0.0, 0.0, 4.0), target=(0.0, 0.0, 0.0))
    _render(a)
    _render(b)
    # the background is the map's horizon band; the sphere sees the sky
    assert (b.sample_buffer == 0.5).mean() > 0.3
    assert b.sample_buffer.max() > 0.6
    _assert_close(b.sample_buffer, a.sample_buffer)
    _assert_close(b.se2_buffer, a.se2_buffer)


def test_raytrace_pixel_matches_jax():
    a, b = _pair(_cornell(), ns_aa=8)
    for rng in (None, 3):
        def gen():
            return None if rng is None else np.random.default_rng(rng)

        want = a.raytrace_pixel(24, 16, gen())
        got = b.raytrace_pixel(24, 16, gen())
        assert got.shape == (3,) and np.isfinite(got).all()
        _assert_close(got, want)


def test_closest_hit_matches_jax():
    """4,096 seeded rays from inside the box: prim equal, t within 1e-12
    (both are inf on a miss)."""
    a, b = _pair(_cornell("glass"))
    g = np.random.default_rng(11)
    o = g.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 2.0], (4096, 3))
    d = g.standard_normal((4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_want, p_want = a._closest_hit(o, d)
    t_got, p_got = b._closest_hit(torch.as_tensor(o), torch.as_tensor(d))
    t_got, p_got = t_got.numpy(), p_got.numpy()
    assert (p_want >= 0).mean() > 0.5 and (p_want < 0).any()
    assert np.array_equal(p_got, p_want)
    hit = p_want >= 0
    assert np.isinf(t_got[~hit]).all()
    assert np.abs(t_got[hit] - t_want[hit]).max() <= 1e-12


def test_visualize_accel_matches_jax():
    a, b = _pair(_cornell())
    for pt in (a, b):
        pt.state = jax_pt.State.VISUALIZE if pt is a else State.VISUALIZE
    assert np.array_equal(b.visualize_accel(), a.visualize_accel())
    for key in ("<", ">", "up", "right", "left", "u"):
        a.key_press(key)
        b.key_press(key)
        assert len(a.selection_history) == len(b.selection_history)
        img = b.visualize_accel()
        assert img.shape == (32, 48, 3)
        assert np.array_equal(img, a.visualize_accel())
    assert (img > 0).any()


def test_save_image_matches_jax(tmp_path):
    a, b = _pair(_cornell(), ns_aa=2, depth=2)
    _render(a)
    _render(b)
    for tonemapped in (True, False):
        out_a = str(tmp_path / f"a{tonemapped}.png")
        out_b = str(tmp_path / f"b{tonemapped}.png")
        a.save_image(out_a, tonemapped)
        b.save_image(out_b, tonemapped)
        got = load_png(out_b)
        assert got.shape == (32, 48, 3) and got.max() > 0
        assert np.array_equal(got, load_png(out_a))


def test_engine_matches_oracle_per_pixel_ztest():
    """tests/test_radiance.py's statistic and bounds, with the port's
    engine and the port's oracle (4 worker threads), both on the CPU."""
    w, h, cpu_spp, frames, spf = 32, 24, 48, 12, 4
    scene = cornell_box_scene(with_spheres=True)
    pt = PathTracer(ns_aa=cpu_spp, max_ray_depth=3, num_threads=4,
                    device="cpu")
    pt.set_frame_size(w, h)
    pt.set_camera(_camera(Camera, w, h))
    pt.set_scene(scene)
    pt.start_raytracing()

    r = WavefrontRenderer(RenderConfig(width=w, height=h,
                                       samples_per_frame=spf, max_depth=3),
                          device="cpu")
    r.load_static_scene(scene)
    r.set_viewpoint([0, 0.75, 2.5], [0, 0.75, 0])
    per_frame = []
    prev = np.zeros((h, w, 3))
    for k in range(1, frames + 1):
        r.render()
        acc = r.get_raw_image().astype(np.float64)
        per_frame.append(acc * k - prev * (k - 1))
        prev = acc
    per_frame = np.stack(per_frame)
    eng_mean = per_frame.mean(axis=0)
    eng_se2 = per_frame.var(axis=0, ddof=1) / frames

    deadline = time.time() + 120
    while not pt.is_done():
        assert time.time() < deadline, "oracle render timed out"
        time.sleep(0.01)
    z = (eng_mean - pt.sample_buffer) / np.sqrt(eng_se2 + pt.se2_buffer
                                                + 1e-12)
    mean_abs_z = float(np.abs(z).mean())
    frac_over_4 = float((np.abs(z) > 4.0).mean())
    max_abs_z = float(np.abs(z).max())
    print(f"mean |z| {mean_abs_z:.3f}, beyond 4 sigma {frac_over_4:.2%}, "
          f"max |z| {max_abs_z:.2f}")
    assert mean_abs_z < 1.6, f"systematic bias: mean|z|={mean_abs_z:.2f}"
    assert frac_over_4 < 0.01, f"{frac_over_4:.2%} of pixels beyond 4 sigma"
    assert max_abs_z < 10.0, f"max |z| = {max_abs_z:.1f}"
    rel = abs(eng_mean.mean() - pt.sample_buffer.mean()) / \
        pt.sample_buffer.mean()
    assert rel < 0.05, f"global mean differs by {rel:.1%}"
