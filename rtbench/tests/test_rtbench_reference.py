"""The reference against the port's plain versions on the CPU: the same
draws, and the same images at small sizes."""

import math

import numpy as np
import pytest
import torch

from conftest import CELLS, SCENES, small
from rtb import reference as R
from rtb import runner



def test_draws_are_the_ports():
    from cuda_raytracer_tpu_torch import rng

    key = R.fold_in(R.prng_key(15618), 3)
    assert key == rng.fold_in(rng.PRNGKey(15618), 3)
    assert R.split(key) == rng.split(key)
    idx = torch.tensor([0, 1, 7, 2 ** 20 + 5])
    dense = rng.uniform_plain(key, (2 ** 20 + 6,), "cpu")
    assert torch.equal(R.uniform_at(key, idx), dense[idx])
    # the granule form: row i // g of the (n / g, 2) draw, repeated
    rep = rng.uniform_plain(key, (8, 2), "cpu", repeat=128)
    lanes = torch.tensor([0, 127, 128, 1000])
    rows = lanes // 128
    got = R.uniform_at(key, rows[:, None] * 2 + torch.arange(2))
    assert torch.equal(got, rep[lanes])


def test_layout_is_the_ports():
    from cuda_raytracer_tpu_torch.ops import shade

    assert np.array_equal(R.tiles32s_rank(96, 70),
                          shade.tiles32s_rank(96, 70))


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, scene):
    res = runner.run_cell(small(name, scene), 2 ** 31 + 12345, 0.3, False,
                          device="cpu", log=lambda m: None)
    assert res["correct"], res["compared"]
    # the CPU's plain versions round as the reference's float64 does, to
    # float32's last digits
    assert res["compared"]["median_rel_err"]["value"] < 1e-5
    assert res["failed"] == 0


def test_camera_is_the_ports():
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(device="cpu")
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene

    r.load_static_scene(cornell_box_scene())
    r.set_viewpoint([0.3, 0.9, 2.0], [0.1, 0.5, 0.0])
    cam = R.camera_of([0.3, 0.9, 2.0], [0.1, 0.5, 0.0], r.camera.hFov,
                      r.camera.vFov)
    assert np.allclose(cam["c2w"], r.camera.c2w, atol=1e-15)
    assert np.allclose(cam["pos"], r.camera.pos)


def test_escaped_light_reaches_missed_rays():
    import types

    # a light that only rays which miss every primitive see, and a
    # camera ray that misses the one triangle: the pixel is its radiance
    sky = types.SimpleNamespace(
        prepare=lambda li, f: {"rad": f(li["radiance"])},
        sample=lambda t, pt, u: (torch.zeros_like(pt), pt * 0 + 1.0,
                                 torch.full_like(pt[:, 0], math.inf)),
        escaped=lambda t, d: t["rad"].expand(d.shape))
    arrays = R.scene_arrays_of(
        [{"positions": np.array([[5.0, 5, 5], [6, 5, 5], [5, 6, 5]]),
          "normals": np.tile([0.0, 0, 1], (3, 1)),
          "indices": np.array([[0, 1, 2]]), "material": 0}], [],
        [{"kind": "diffuse", "albedo": [0.5, 0.5, 0.5], "name": "d"}],
        [{"kind": "sky", "radiance": [0.25, 0.5, 1.0]}])
    render = {"width": 4, "height": 4, "samples_per_frame": 2,
              "max_depth": 2, "nee_schedule": [[1, 1.0]] * 2,
              "sample_order": "raster", "rng_granule": 1,
              "rng_fold_dirs": True, "hemisphere_sampling": "uniform",
              "rr_start_depth": 0, "origin_eps": 1e-3, "shadow_eps": 1e-3,
              "seed": 3}
    ref = R.Reference(arrays, render, {"sky": sky})
    cam = R.camera_of([0.0, 0.0, 0.0], [0.0, 0.0, -1.0], 50.0, 50.0)
    got = ref.image([(0, cam)], np.arange(16))
    assert torch.allclose(got, torch.tensor([0.25, 0.5, 1.0],
                                            dtype=torch.float64))
