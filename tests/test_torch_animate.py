"""The port's timeline and offline video rendering (apps/timeline.py,
apps/animate.py) on the CPU, against the JAX package's.

* tests/test_timeline.py's timeline and keyframing cases on the port;
* ``raytrace_video`` for 3 frames at 16x12, 2 spp, on a generated scene:
  a 6x2-quad strip rigged with a two-joint skeleton keyed at t=0 and
  t=2, moved by its own TRS keys, under an area light.  Held: the file
  names; each frame's transformed static scene equal, field for field,
  to the JAX package's at the same time; frame 0 per pixel against the
  JAX ``raytrace_video``'s frame 0 (rtol=1e-4, atol=1e-5 on at least
  99% of pixels; the JAX "auto" traverses with XLA off the TPU, the
  port with the DFS's plain version); the PNGs decode to what was
  rendered.
"""

import types

import numpy as np

from cuda_raytracer_tpu.apps.animate import raytrace_video as jax_video
from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.scene import bsdf as jax_bsdf
from cuda_raytracer_tpu.scene import collada_info as jax_ci
from cuda_raytracer_tpu.scene import dynamic_scene as jax_dyn
from cuda_raytracer_tpu.scene import skeleton as jax_skeleton

from cuda_raytracer_tpu_torch.apps.animate import raytrace_video
from cuda_raytracer_tpu_torch.apps.timeline import Timeline
from cuda_raytracer_tpu_torch.config import RenderConfig
from cuda_raytracer_tpu_torch.render import engine
from cuda_raytracer_tpu_torch.scene import bsdf, collada_info, dynamic_scene
from cuda_raytracer_tpu_torch.scene import skeleton
from cuda_raytracer_tpu_torch.utils.image import load_png, to_uint8

from test_torch_collada import assert_same
from torch_threads import _one_torch_thread  # noqa: F401

PACKAGES = {
    "port": types.SimpleNamespace(dyn=dynamic_scene, ci=collada_info,
                                  bsdf=bsdf, sk=skeleton),
    "jax": types.SimpleNamespace(dyn=jax_dyn, ci=jax_ci, bsdf=jax_bsdf,
                                 sk=jax_skeleton),
}
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
CAMERA = (np.array([0.0, 1.0, 4.0]), np.eye(3))


def test_timeline_step_and_play():
    tl = Timeline(max_frame=3)
    assert not tl.step()  # not playing
    tl.action_play()
    assert [tl.step() for _ in range(4)] == [True, True, True, False]
    assert tl.get_current_frame() == 3 and not tl.is_currently_playing()
    tl.action_play()  # at the end: play rewinds first
    assert tl.get_current_frame() == 0
    tl.action_loop()
    for _ in range(4):
        tl.step()
    assert tl.get_current_frame() == 0  # wrapped through max inclusive


def test_timeline_actions():
    tl = Timeline(max_frame=10)
    tl.action_step_forward(4)
    assert tl.get_current_frame() == 4
    tl.action_step_backward(6)
    assert tl.get_current_frame() == 8  # modular wrap
    tl.action_goto_end()
    assert tl.get_current_frame() == 10
    tl.action_rewind()
    assert tl.get_current_frame() == 0
    tl.make_longer(5)
    assert tl.get_max_frame() == 15
    tl.make_shorter(20)
    assert tl.get_max_frame() == 1  # clamped to >= 1


def test_timeline_marked_times():
    tl = Timeline(max_frame=20)
    assert tl.mark_time(5) and tl.mark_time(15) and tl.mark_time(10)
    assert not tl.mark_time(10)  # already marked
    assert tl.marked_times == [5, 10, 15]
    tl.current_frame = 10
    assert tl.is_present_time_marked()
    assert tl.next_important_time() == 15
    assert tl.previous_important_time() == 5
    tl.action_goto_next_key_frame()
    assert tl.get_current_frame() == 15
    assert tl.next_important_time() == -1
    tl.action_goto_prev_key_frame()
    assert tl.get_current_frame() == 10
    assert tl.unmark_time(10)
    assert not tl.unmark_time(10)
    assert not tl.is_present_time_marked()


def strip_mesh(m, rigged=True):
    """A 6x2-quad strip along +x (y up); with ``rigged``, a two-joint
    skeleton along it, keyed straight at t=0 and bent at t=2, and the
    mesh's TRS keyed to rise."""
    xs = np.linspace(-1.2, 1.2, 7)
    v = np.array([[x, 0.0, z] for z in (-0.4, 0.0, 0.4) for x in xs])
    quads = [[r * 7 + c, r * 7 + c + 1, (r + 1) * 7 + c + 1, (r + 1) * 7 + c]
             for r in range(2) for c in range(6)]
    info = m.ci.PolymeshInfo(
        vertices=v,
        polygons=[m.ci.Polygon(vertex_indices=q) for q in quads],
        material=m.ci.MaterialInfo(
            bsdf=m.bsdf.DiffuseBSDF(np.array([0.7, 0.6, 0.5]))),
    )
    mesh = m.dyn.Mesh(info, np.eye(4))
    mesh.position = np.zeros(3)
    if rigged:
        sk = m.sk.Skeleton(offset=(-1.2, 0.0, 0.0))
        j1 = sk.create_joint([1.2, 0.0, 0.0])
        j2 = sk.create_joint([1.2, 0.0, 0.0], parent=j1)
        mesh.skeleton = sk
        mesh.keyframe(0.0)
        j2.angle = np.array([0.0, 0.0, 50.0])
        mesh.position = np.array([0.0, 0.3, 0.0])
        mesh.keyframe(2.0)
    return mesh


def scene(m):
    light = m.dyn.init_light(
        m.ci.LightInfo(
            light_type=m.ci.LightType.AREA,
            spectrum=np.array([8.0, 8.0, 8.0]),
            position=np.array([0.0, 1.6, 0.0]),
            direction=np.array([0.0, -1.0, 0.0]),
            up=np.array([0.0, 0.0, 1.0]),
        ),
        np.eye(4),
    )
    return m.dyn.Scene([strip_mesh(m)], [light])


def test_mesh_keyframe_interpolation():
    """TRS keys interpolate alike in both packages."""
    got = {}
    for name, m in PACKAGES.items():
        mesh = strip_mesh(m, rigged=False)
        mesh.keyframe(0.0)
        mesh.position = np.array([2.0, 0.0, 0.0])
        mesh.keyframe(10.0)
        got[name] = [mesh.get_transformed_static_object(t).positions
                     for t in (0.0, 5.0, 10.0)]
        v0, vmid, v10 = got[name]
        np.testing.assert_allclose(v10[:, 0] - v0[:, 0], 2.0, atol=1e-9)
        np.testing.assert_allclose(vmid[:, 0] - v0[:, 0], 1.0, atol=1e-6)
        mesh.unkeyframe(10.0)
        np.testing.assert_allclose(
            mesh.get_transformed_static_object(5.0).positions, v0, atol=1e-9)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


def test_raytrace_video_matches_jax(tmp_path, monkeypatch):
    kw = dict(width=16, height=12, samples_per_frame=2)
    loaded, imgs = [], []
    load = engine.WavefrontRenderer.load_static_scene

    def spy(self, sscene, *args, **kwargs):
        loaded.append(sscene)
        return load(self, sscene, *args, **kwargs)

    monkeypatch.setattr(engine.WavefrontRenderer, "load_static_scene", spy)
    paths = raytrace_video(
        scene(PACKAGES["port"]), RenderConfig(**kw), max_frame=3,
        out_dir=str(tmp_path / "port"), prefix="Video_test_", spp=2,
        camera_pose=CAMERA, frame_callback=lambda t, img: imgs.append(img),
        device="cpu")
    assert [p.rsplit("/", 1)[1] for p in paths] == \
        [f"Video_test_{i:04d}.png" for i in range(3)]
    jscene = scene(PACKAGES["jax"])
    assert len(loaded) == 3
    for t, sscene in enumerate(loaded):
        assert_same(sscene, jscene.get_transformed_static_scene(float(t)),
                    f"frame {t}")
    for path, img in zip(paths, imgs):
        assert img.shape == (12, 16, 3) and np.isfinite(img).all()
        np.testing.assert_array_equal(
            load_png(path), to_uint8(img).astype(np.float32) / 255.0)
    assert not np.array_equal(imgs[0], imgs[2])  # the strip moved

    want = []
    jpaths = jax_video(
        jscene, JaxConfig(**kw), max_frame=1,
        out_dir=str(tmp_path / "jax"), prefix="Video_test_", spp=2,
        camera_pose=CAMERA, frame_callback=lambda t, img: want.append(img))
    assert [p.rsplit("/", 1)[1] for p in jpaths] == ["Video_test_0000.png"]
    want = np.asarray(want[0])
    assert float(want.mean()) > 0
    bad = ~np.isclose(imgs[0], want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside the tolerance")
    assert bad.mean() <= MAX_BAD
