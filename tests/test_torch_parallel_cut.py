"""The leaf test's parallel cut is relative to the triangle, and the DFS
tally counts what the plain DFS counts.

The port calls a ray parallel to a triangle where |g.d| <= prim_scale(g)
= 1e-6 |g| (unit d), g the unnormalized normal; the JAX package's cut,
|g.d| < 1e-6, drops every hit at |cos| under 1e-6 / |g|, which on the
dragon-class mesh in the benchmark's box (|g| near 3.5e-6) is more than
a quarter of all directions.  Held
here against the benchmark's float64 reference (rtbench/rtb/reference.py:
plain torch, Moller-Trumbore over every triangle, nothing of the port):

* one triangle at three scales (|g| 1, 1e-4, 1e-6), rays at |cos| 0.3
  down to 1e-5: the same verdict and t at every scale, those of float64;
  the absolute cut misses at the two small scales;
* the dragon cell's job cut to 64x32 at 4 spp (as the benchmark's own
  tests cut a cell) on its box and heightfield, scaled so that the
  heightfield's triangles are as small as n=660's: ``correct`` under the
  port's cut, not under the absolute one;
* the DFS tally over the frames rendered after a profiled span (as
  many as the span held) equals the plain DFS's ``stats`` on the same
  rays, and a profiled frame counts nothing.
"""

import copy
import math
import os
import sys

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu_torch.ops import intersect, packet_dfs
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF
from cuda_raytracer_tpu_torch.utils import timing
from torch_threads import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "rtbench"))

from rtb import catalog, runner  # noqa: E402
from rtb import reference as R  # noqa: E402

CELL = "dragon_terrain.offline64"
#: the heightfield's size here, and the scale of the whole scene (box,
#: mesh, camera and light): 2 x 32^2 triangles whose median |g| (twice
#: the area) is 3.7e-6, as n=660's in the cell (3.5e-6)
N_SMALL, PATCH = 33, 1.0 / 20.0


def reference_t(o, d, v):
    """float64 closest-hit t of rays o, d ([N, 3]) against the one
    triangle v ([3, 3]), inf on a miss: the benchmark's reference."""
    arrays = R.scene_arrays_of(
        [{"positions": np.asarray(v, np.float64),
          "normals": np.tile([0.0, 1.0, 0.0], (3, 1)),
          "indices": [[0, 1, 2]], "material": 0}],
        [], [{"kind": "diffuse", "albedo": [1.0, 1.0, 1.0]}], [])
    sc = R.Scene(arrays, torch.float64, "cpu", {})
    o64 = torch.as_tensor(np.asarray(o, np.float64))
    d64 = torch.as_tensor(np.asarray(d, np.float64))
    t, _ = sc.closest(o64, d64, torch.ones(len(o64), dtype=torch.bool))
    return t.numpy()


def _grazing_rays(scale):
    """Rays into the centroid of the triangle below, from above and
    below, at |cos| 0.3 to 1e-5 and eight azimuths each, one unit away:
    (triangle [3, 3], o [N, 3] f32, d [N, 3] f32)."""
    v = np.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [-0.5, 0.0, 0.5]])
    v = v * scale
    target = v.mean(0)
    rays = []
    for c in (0.3, 0.1, 1e-2, 1e-3, 1e-4, 1e-5):
        s = math.sqrt(1.0 - c * c)
        for k in range(8):
            phi = 0.3 + k * math.pi / 4
            for side in (-1.0, 1.0):
                rays.append((s * math.cos(phi), side * c, s * math.sin(phi)))
    d = np.array(rays)
    o = target - d
    return v, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scale, eps, agrees", [
    (1.0, None, True), (1e-2, None, True), (1e-3, None, True),
    (1e-2, 1e-6, False), (1e-3, 1e-6, False)])
def test_cut_is_scale_free(scale, eps, agrees):
    v, o, d = _grazing_rays(scale)
    mesh = st.Mesh(v, np.tile([0.0, 1.0, 0.0], (3, 1)), np.array([[0, 1, 2]]),
                   DiffuseBSDF([0.7, 0.7, 0.7]))
    fs, _ = flatten_scene(st.Scene([mesh], []), device="cpu")
    row = fs.prim_packed[0]
    g = row[10:13].double().norm().item()
    assert g == pytest.approx(scale * scale, rel=1e-6)
    assert row[22].item() == pytest.approx(1e-6 * g, rel=1e-6)
    ok, t = intersect.packed_prim_test(
        *torch.from_numpy(o).unbind(1), *torch.from_numpy(d).unbind(1),
        *row[10:22], row[9], row[22], eps=eps)
    t64 = reference_t(o, d, v)
    assert np.isfinite(t64).all()  # float64 hits every one
    if not agrees:
        assert not ok.all(), "the absolute cut keeps every grazing hit"
        return
    assert ok.all()
    # about 1 everywhere: t is the ray's length to the centroid
    np.testing.assert_allclose(t.numpy(), t64, rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), 1.0, rtol=1e-6)


@pytest.fixture(scope="module")
def small_cell():
    """The dragon cell's job at 64x32 and 4 spp a frame, on its scene
    with the heightfield at n=33, every position scaled by 1/20."""
    cell = copy.deepcopy(catalog.cell(CELL))
    job, render = cell["job"], cell["job"]["render"]
    render.update(width=64, height=32, samples_per_frame=4,
                  post_process_threshold=4)
    job["check"].update(pixels=48, median_pixels=8)
    cfg = cell["config"]

    def scaled(v):
        return [x * PATCH for x in v]

    mesh = cfg["mesh"]
    mesh.update(n=N_SMALL, scale=mesh["scale"] * PATCH,
                offset=scaled(mesh["offset"]))
    for q in cfg["quads"]:
        q["corners"] = [scaled(c) for c in q["corners"]]
    for li in cfg["lights"]:
        for k in ("position", "dim_x", "dim_y"):
            li[k] = scaled(li[k])
    for k in ("origin", "look_at"):
        cfg["camera"][k] = scaled(cfg["camera"][k])
    return cell


@pytest.fixture
def patch_builder(monkeypatch):
    """The suite's own conftest loads JAX into this process for the JAX
    package's tests; a benchmark run refuses a process that holds it,
    which rtbench/tests checks where nothing loads it."""
    monkeypatch.setattr(runner, "banned_modules", lambda: [])


@pytest.mark.parametrize("eps, correct", [(None, True), (1e-6, False)])
def test_small_dragon_render(small_cell, patch_builder, monkeypatch, eps,
                             correct):
    if eps is not None:
        # the JAX package's absolute cut, in every traversal
        monkeypatch.setattr(intersect.packed_prim_test, "__defaults__",
                            (eps,))
    res = runner.run_cell(small_cell, 2 ** 33 + 22, 0.2, False,
                          device="cpu", log=lambda m: None)
    assert res["correct"] == correct, res["compared"]


def test_tally_counts_frames_after_a_span(small_cell, patch_builder,
                                           monkeypatch):
    config, job = small_cell["config"], small_cell["job"]
    scene = catalog.scene_builder(config["builder"])(config)
    sut = catalog.system(job["system"]).Renderer(
        scene, job["render"], config["camera"], 22, "cpu")
    plain = packet_dfs.dfs_trace_plain
    calls = []

    def keep(*args, stats=None):
        if stats is not None:  # the wrapper counts only while recording
            calls.append(args)
        return plain(*args, stats=stats)

    monkeypatch.setattr(packet_dfs, "dfs_trace_plain", keep)
    sut.frame()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sut.frame()
        sut.frame()
    assert not calls, "a profiled frame counted"
    for _ in range(3):  # the span's two frames are counted, not the third
        sut.frame()
    got = timing.counters()["dfs"]
    sut.frame()  # read back: no longer counted
    assert timing.counters()["dfs"] == got

    want = dict(dict.fromkeys(packet_dfs.TALLY_KEYS, 0), frames=2)
    for args in calls:
        stats = {}
        plain(*args, stats=stats)
        stats.update(packet_dfs.launch_counts(args[0].shape[0], *args[3:7]))
        for k, v in stats.items():
            want[k] += v
    # two frames, each with a DFS camera pass and its shadow pass, a
    # depth-1 bounce and its shadow pass
    assert len(calls) == 8 and want["launches"] == 8
    assert got == want
    assert want["boxes"] > want["visits"] > want["rays"] > 0
    assert want["tris"] > 0 and want["spheres"] == 0
    visits = catalog.metric_reader("dfs_visits_per_ray")({})
    assert visits == pytest.approx(want["visits"] / want["rays"])
