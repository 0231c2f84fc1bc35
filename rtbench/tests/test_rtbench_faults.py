"""A run with its timed path broken underneath comes out not correct:
a frame that leaves the renderer's state unchanged, half of each
frame's samples left out of the film, and an image altered where the
film makes it.  (One chip: no exchange between chips to leave out.)
Besides, on the heightfield, a leaf test that drops grazing hits on
small triangles, as the port's does on the dragon-class mesh (PERF.md,
Open questions 1)."""

import pytest

from conftest import CELLS, SCENES, small
from rtb import runner



def _unchanged(monkeypatch):
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    def render(self):
        if self._stages is None:
            self.setup()
        self.image_samples += self.config.samples_per_frame
        self.frame_index += 1

    monkeypatch.setattr(WavefrontRenderer, "render", render)


def _film(monkeypatch, change):
    from cuda_raytracer_tpu_torch.ops import filters

    film = filters.film

    def broken(sample_light, final_img, old_weight, new_weight, width,
               height, spp, inv_order=None, sample_major=False):
        sample_light, out_scale = change(sample_light, spp, sample_major)
        return film(sample_light, final_img, old_weight, new_weight, width,
                    height, spp, inv_order, sample_major) * out_scale

    monkeypatch.setattr(filters, "film", broken)


def _half(monkeypatch):
    def change(light, spp, sample_major):
        # the mean over the first half of each pixel's samples
        if sample_major:
            v = light.reshape(spp, -1, 3).clone()
            v[spp // 2:] = v[:spp // 2]
        else:
            v = light.reshape(-1, spp, 3).clone()
            v[:, spp // 2:] = v[:, :spp // 2]
        return v.reshape(-1, 3), 1.0

    _film(monkeypatch, change)


def _altered(monkeypatch):
    _film(monkeypatch, lambda light, spp, sm: (light, 1.01))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, scene, fault, monkeypatch):
    fault(monkeypatch)
    res = runner.run_cell(small(name, scene), 77_000_000_001, 0.2, False,
                          device="cpu", log=lambda m: None)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_grazing_hits_dropped_is_not_correct(name, monkeypatch):
    from cuda_raytracer_tpu_torch.ops import intersect

    # |g.d| < 5e-4 with |g| about 4.8e-3 (twice a triangle's area at
    # n=30): every hit at |cos| under about 0.1 is taken for parallel
    monkeypatch.setattr(intersect.packed_prim_test, "__defaults__", (5e-4,))
    res = runner.run_cell(small(name, "heightfield"), 77_000_000_003, 0.2,
                          False, device="cpu", log=lambda m: None)
    assert not res["correct"], res["compared"]
