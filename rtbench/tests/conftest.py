"""The benchmark's own tests: on the CPU, at small sizes, with the
port's plain versions.  Tests marked ``card`` need a CUDA device and
skip without one (run them on the card: ``python3 -m pytest rtbench/tests
-m card``)."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


#: the cells, and the scenes that their jobs are also run on here
CELLS = ["cbspheres_classic.offline64", "cbspheres_classic.realtime2"]
SCENES = ["config", "heightfield"]

#: scenes/heightfield.py's input at a size the CPU traces in a second:
#: the displaced heightfield that stands in for the dragon-class mesh
#: (PERF.md, Open questions 1), 1,682 triangles of varied orientation
HEIGHTFIELD = {
    "builder": "heightfield", "n": 30, "seed": 7, "octaves": 5,
    "amplitude": 0.25, "height_scale": 0.3, "frequency": [2.0, 4.0],
    "material": {"kind": "diffuse", "albedo": [0.7, 0.7, 0.7]},
    "lights": [{"kind": "area", "radiance": [8.0, 8.0, 8.0],
                "position": [0.0, 1.2, 0.0], "direction": [0.0, -1.0, 0.0],
                "dim_x": [0.5, 0.0, 0.0], "dim_y": [0.0, 0.0, 0.4]}],
    "camera": {"origin": [0, 1.3, 1.3], "look_at": [0, 0, 0],
               "hfov_deg": 50.0, "vfov_deg": 35.0},
}


def small(name: str, scene: str = "config"):
    """Cell ``name`` cut to a size the CPU renders in a second: its
    render settings, job and check as in its files, at 64x32 (offline)
    or 32x32 (realtime) pixels, the median while half an image is
    accumulated; with ``scene="heightfield"`` the job runs on the
    heightfield above in place of the cell's configuration."""
    from rtb import catalog

    cell = copy.deepcopy(catalog.cell(name))
    job, render = cell["job"], cell["job"]["render"]
    if job["frames_per_image"] == 2:
        render.update(width=64, height=32, samples_per_frame=4,
                      post_process_threshold=4)
        job["check"].update(pixels=48, median_pixels=8)
    else:
        render.update(width=32, height=32)
        job["frames_per_image"] = 6
        render["post_process_threshold"] = 6
        job["check"].update(pixels=24, median_pixels=8)
    if scene == "heightfield":
        cell["config"] = copy.deepcopy(HEIGHTFIELD)
    return cell
