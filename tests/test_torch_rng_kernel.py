"""rng.uniform as the kernel's wrapper (ops/csrc/rng.cu), on the CPU.

* On CPU tensors ``rng.uniform`` is ``uniform_plain``, bit for bit, and
  both are ``jax.random.uniform`` at a frame's shapes: (n, 2), (n,),
  (3, 5, 2), an odd n, one draw of shape (), and no element at all.
* The repeat form (draw_u2's per-granule draws) is
  ``jnp.repeat(jax.random.uniform(key, (n // g, 2)), g, axis=0)``.
* A ``KeyTable`` key draws the bits of its int key, in both forms.
* A CUDA device goes to the kernel's wrapper, never to the plain
  version; another device is refused.
* The draws of one small CPU frame, counted by wrapping ``rng.uniform``,
  are what ``chip_smoke.expected_launches`` schedules for the kernel on
  the card, raygen's draw (hashed inside the camera rays' kernel there)
  under its ``raygen`` entry: the fast preset, the reference preset,
  three lights (area, directional, environment) and ``compact_depths``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from chip_smoke import expected_launches
from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import shade as S
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.scene import static_scene as st
from torch_threads import _one_torch_thread  # noqa: F401

SEED, DATA = 15618, 2001
W, H, SPF = 32, 32, 2


def _keys():
    """The same key for jax.random and for the port."""
    kj = jax.random.fold_in(jax.random.PRNGKey(SEED), DATA)
    return kj, tuple(int(x) for x in np.asarray(kj))


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32)


@pytest.mark.parametrize("shape", [(4096, 2), (4096,), (3, 5, 2), (777,),
                                   (1,), (), (0,), (0, 2)])
def test_uniform_on_cpu_is_the_plain_version(shape):
    kj, key = _keys()
    got = rng.uniform(key, shape, "cpu")
    plain = rng.uniform_plain(key, shape, "cpu")
    want = np.asarray(jax.random.uniform(kj, shape, dtype=jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(_bits(got), _bits(plain))
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("g", [2, 1024])
def test_repeat_form(g):
    kj, key = _keys()
    rows = 15
    want = np.asarray(jnp.repeat(
        jax.random.uniform(kj, (rows, 2), dtype=jnp.float32), g, axis=0))
    got = rng.uniform(key, (rows, 2), "cpu", repeat=g)
    assert tuple(got.shape) == (rows * g, 2)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(
        _bits(rng.uniform_plain(key, (rows, 2), "cpu", repeat=g)), _bits(want))


@pytest.mark.parametrize("repeat", [0, -1])
def test_repeat_form_refuses(repeat):
    _, key = _keys()
    with pytest.raises(ValueError, match="repeat"):
        rng.uniform(key, (4, 2), "cpu", repeat=repeat)
    with pytest.raises(ValueError, match="repeat"):
        rng.uniform(key, (), "cpu", repeat=2)


@pytest.mark.parametrize("shape,repeat", [((4097, 2), 1), ((5,), 1),
                                          ((6, 2), 1024), ((3, 5, 2), 3)])
def test_keytable_key_draws_the_int_keys_bits(shape, repeat):
    _, key = _keys()
    table = rng.KeyTable(["a", "b"], "cpu")
    table.load({"a": rng.fold_in(key, 1), "b": key})
    got = rng.uniform(table["b"], shape, "cpu", repeat=repeat)
    want = rng.uniform(key, shape, "cpu", repeat=repeat)
    assert np.array_equal(_bits(got), _bits(want))


def test_cuda_device_goes_to_the_kernel(monkeypatch):
    """A CUDA device never reaches the plain version: the wrapper
    launches the kernel or raises.  Other devices are refused."""
    _, key = _keys()
    seen = []

    def kernel(k, shape, device, repeat=1):
        seen.append((tuple(shape), torch.device(device).type, repeat))
        return "launched"

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA device")

    monkeypatch.setattr(rng, "uniform_cuda", kernel)
    monkeypatch.setattr(rng, "uniform_plain", plain)
    assert rng.uniform(key, (8, 2), "cuda", repeat=4) == "launched"
    assert rng.uniform(key, (8,), torch.device("cuda", 0)) == "launched"
    assert seen == [((8, 2), "cuda", 4), ((8,), "cuda", 1)]
    with pytest.raises(ValueError, match="device"):
        rng.uniform(key, (8,), "meta")


def test_kernel_wrapper_refuses_a_cpu_device():
    _, key = _keys()
    with pytest.raises(ValueError, match="CUDA"):
        rng.uniform_cuda(key, (8,), "cpu")


# ---------------------------------------------------------------------------
# draws per frame
# ---------------------------------------------------------------------------


def _env_map():
    g = np.random.default_rng(7)
    return (0.2 + g.random((8, 16, 3))).astype(np.float32)


def _three_lights():
    """Terrain n=8 under its area light, a directional light and an
    environment map."""
    scene = terrain_scene(n=8)
    sun = st.DirectionalLight([1.5, 1.4, 1.2], [-0.8, -0.35, -0.3])
    return st.Scene(scene.objects, [scene.lights[0], sun,
                                    st.EnvironmentLight(_env_map())])


def _fast(**over):
    kw = fast_preset_kwargs(W, H, 4 * SPF)
    kw.update(samples_per_frame=SPF, **over)
    return RenderConfig(width=W, height=H, total_samples=4 * SPF,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


#: case -> (config, scene, viewpoint)
FRAMES = {
    "fast": (lambda: _fast(), lambda: cornell_box_scene(with_spheres=True),
             ([0, 0.75, 2.5], [0, 0.75, 0])),
    "reference": (lambda: RenderConfig(width=W, height=H, total_samples=SPF,
                                       samples_per_frame=SPF),
                  lambda: cornell_box_scene(with_spheres=True),
                  ([0, 0.75, 2.5], [0, 0.75, 0])),
    "three lights": (lambda: RenderConfig(width=W, height=H,
                                          total_samples=SPF,
                                          samples_per_frame=SPF,
                                          max_leaf_size=4),
                     _three_lights, ([0, 1.3, 1.3], [0, 0, 0])),
    "compact_depths": (
        lambda: _fast(compact_depths=True, fuse_frame="yes"),
        lambda: cornell_box_scene(with_spheres=True),
        ([0, 0.75, 2.5], [0, 0.75, 0])),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_draws_per_frame_are_the_schedule(case, monkeypatch):
    cfg, scene, view = FRAMES[case]
    r = WavefrontRenderer(cfg(), camera_mode="collada", device="cpu")
    r.load_static_scene(scene())
    r.set_viewpoint(*view)
    calls, raygen, draw = [], [], rng.uniform
    in_raygen = []

    def counted(key, shape, device, repeat=1):
        out = draw(key, shape, device, repeat)
        (raygen if in_raygen else calls).append(out.numel())
        return out

    def plain_raygen(fn):
        def rays(*a, **k):
            in_raygen.append(True)
            try:
                return fn(*a, **k)
            finally:
                in_raygen.pop()
        return rays

    monkeypatch.setattr(rng, "uniform", counted)
    for name in ("generate_camera_rays_plain",
                 "generate_camera_rays_cutracer_plain"):
        monkeypatch.setattr(S, name, plain_raygen(getattr(S, name)))
    r.render()
    assert all(calls), "a frame drew nothing (no launch on the card)"
    want = expected_launches(r, 1, medians=1)
    assert len(calls) == want["rng_uniform"]
    assert len(raygen) == want["raygen"] == 1 and all(raygen)
    if case == "compact_depths":
        assert r.compacting and all(r.live_counts)
    if case == "three lights":
        assert r.scene.num_lights == 3
