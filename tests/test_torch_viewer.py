"""The port's headless progressive viewer (apps/viewer.py) on the CPU,
against the JAX package's viewer; and the port's timing helpers.

* tests/test_viewer.py's cases on the port (48x36, 2 spp per frame);
* the camera state (pos, c2w, r, phi, theta) after a fixed key sequence,
  equal to the JAX viewer's to 1e-12 (the same float64 camera code);
* one progressive frame per pixel against the JAX viewer (16x12, 2 spp,
  the Cornell box): rtol=1e-4, atol=1e-5 on at least 99% of pixels (the
  JAX "auto" traverses with XLA off the TPU, the port with the DFS's
  plain version; XLA's CPU fusion contracts FMAs);
* the W/L + digit session keys on a document the test writes: the
  reloaded scene's tables equal those before the save, but for the BSDF
  table (the session's COLLADA writer keeps no materials, in both
  packages);
* LapTimer and RayThroughput.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.apps.viewer import InteractiveViewer as JaxViewer
from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer

from cuda_raytracer_tpu_torch.apps import viewer as viewer_app
from cuda_raytracer_tpu_torch.apps.viewer import InteractiveViewer
from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.flatscene import BSDF_DIFFUSE
from cuda_raytracer_tpu_torch.utils.timing import LapTimer, RayThroughput

from test_torch_collada import document
from torch_threads import _one_torch_thread  # noqa: F401

VIEW = ([0, 0.75, 2.5], [0, 0.75, 0])
#: the FlatScene tables that hold the BSDFs
MATERIAL_TABLES = ("bsdf_fn", "bsdf_albedo", "bsdf_radiance", "bsdf_ior")
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01


def make_viewer(w=48, h=36):
    r = WavefrontRenderer(RenderConfig(width=w, height=h,
                                       samples_per_frame=2), device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.set_viewpoint(*VIEW)
    return InteractiveViewer(renderer=r)


def make_jax_viewer(w=48, h=36):
    r = JaxRenderer(JaxConfig(width=w, height=h, samples_per_frame=2))
    r.load_static_scene(jax_cornell(with_spheres=True))
    r.set_viewpoint(*VIEW)
    return JaxViewer(renderer=r)


def test_progressive_accumulation():
    v = make_viewer()
    v.frame()
    st = v.status()
    assert st["spp"] == 2 and st["frame_s"] > 0
    v.spin(3)
    assert v.status()["spp"] == 8


def test_move_resets_accumulation():
    v = make_viewer()
    v.spin(2)
    assert v.status()["spp"] == 4
    before = v.renderer.camera.pos.copy()
    assert v.key("w")  # dolly in
    assert v.status()["spp"] == 0  # reset on move
    assert not np.allclose(v.renderer.camera.pos, before)
    img = v.frame()
    assert np.isfinite(img).all() and img.max() > 0


def test_orbit_and_home():
    v = make_viewer()
    p0 = v.renderer.camera.pos.copy()
    assert v.key("h")
    assert not np.allclose(p0, v.renderer.camera.pos)
    assert v.key("r")  # home restores the original pose
    np.testing.assert_allclose(v.renderer.camera.pos, p0, atol=1e-12)


def test_unknown_key_is_noop():
    v = make_viewer()
    v.spin(1)
    assert not v.key("z")
    assert v.status()["spp"] == 2  # unchanged, no reset


KEYS = "wwhhjkaddqels" + "r" + "kkwsl"


def _camera(v):
    c = v.renderer.camera
    return [np.asarray(c.pos), np.asarray(c.c2w), np.asarray(c.targetPos),
            np.array([c.r, c.phi, c.theta])]


def test_camera_keys_match_jax():
    """The same keys move both viewers' cameras alike (no render)."""
    v, jv = make_viewer(), make_jax_viewer()
    for a, b in zip(_camera(v), _camera(jv)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for ch in KEYS:
        assert v.key(ch) == jv.key(ch), ch
        for a, b in zip(_camera(v), _camera(jv)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=ch)


def test_frame_matches_jax():
    v, jv = make_viewer(16, 12), make_jax_viewer(16, 12)
    for ch in "hw":
        v.key(ch)
        jv.key(ch)
    got, want = v.frame(), np.asarray(jv.frame())
    assert v.status()["spp"] == jv.status()["spp"] == 2
    assert v.status()["mrays_per_frame"] == jv.status()["mrays_per_frame"]
    assert float(want.mean()) > 0
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside the tolerance")
    assert bad.mean() <= MAX_BAD


def _tables(scene):
    """Every field of the FlatScene and its FlatBVH (tensors cloned)."""
    out = {}
    for obj, prefix in ((scene, ""), (scene.bvh, "bvh.")):
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            if f.name != "bvh":
                out[prefix + f.name] = (x.clone() if isinstance(
                    x, torch.Tensor) else x)
    return out


def test_viewer_session_keys(tmp_path, monkeypatch):
    """W+digit saves, L+digit reloads (application.h:281-296), into the
    working directory; the reloaded scene flattens to the same tables."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "scene.dae"
    path.write_text(document())
    v = InteractiveViewer(
        RenderConfig(width=16, height=12, samples_per_frame=2, max_depth=2),
        scene_path=str(path), device="cpu")
    v.frame()
    before = _tables(v.renderer.scene)
    assert not v.key("W")
    assert not v.key("3")
    assert os.path.exists(tmp_path / "Scene_3.dae")
    assert not v.key("L")
    assert not v.key("5")  # an empty slot: nothing loads
    assert v.status()["spp"] == 2
    assert not v.key("L")
    assert v.key("3")  # load resets accumulation -> "moved"
    assert v.status()["spp"] == 0
    after = _tables(v.renderer.scene)
    assert sorted(after) == sorted(before)
    bad = [k for k, x in before.items() if not (
        torch.equal(after[k], x) if isinstance(x, torch.Tensor)
        else after[k] == x)]
    # the session's COLLADA writer keeps no materials (in both packages):
    # only the BSDF table differs, every entry now a diffuse default
    assert bad == list(MATERIAL_TABLES)
    assert after["bsdf_fn"].shape == before["bsdf_fn"].shape
    assert bool((after["bsdf_fn"] == BSDF_DIFFUSE).all())
    assert np.isfinite(v.frame()).all()


def test_main_writes_png_and_needs_a_device(tmp_path, monkeypatch):
    path = tmp_path / "scene.dae"
    path.write_text(document())
    out = tmp_path / "v.png"
    assert viewer_app.main([str(path), "--size", "16x12", "--frames", "2",
                            "-w", str(out), "--device", "cpu"]) == 0
    assert out.exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        viewer_app.main([str(path), "--frames", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        InteractiveViewer(RenderConfig(), scene_path=str(path))


def test_lap_timer_and_throughput(capsys):
    timer = LapTimer(verbose=True)
    x = torch.ones(8)
    with timer.stage("a", x):
        x = x * 2
    timer.start()
    timer.lap("b", {"x": [x, (x,)]})
    timer.start()
    timer.lap("a")
    assert timer.counts == {"a": 2, "b": 1}
    assert all(v >= 0 for v in timer.totals.values())
    assert "[LapTimer] b :" in capsys.readouterr().out
    report = timer.report().splitlines()
    assert report[0].startswith("stage") and len(report) == 3
    timer.reset()
    assert timer.totals == {} and timer.counts == {}
    t = RayThroughput()
    assert t.mrays_per_s == 0.0
    t.add(3e6, 1.5)
    t.add(1e6, 0.5)
    assert t.mrays_per_s == pytest.approx(2.0)


def test_engine_depth_laps(monkeypatch):
    """CRT_TIME_DEPTHS adds one lap per depth to stage_times."""
    monkeypatch.setenv("CRT_TIME_DEPTHS", "1")
    v = make_viewer(16, 12)
    v.frame()
    r = v.renderer
    laps = sorted(k for k in r.stage_times if k.startswith("depth"))
    assert laps == [f"depth{i}" for i in range(r.config.max_depth)]
    assert {"frame", "bvh_build", "flatten", "upload"} <= set(r.stage_times)
