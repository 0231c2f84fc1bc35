"""The arithmetic of the metrics: rays per frame against hand counts,
the 95th percentile, and the interval union behind idle_share."""

import numpy as np
import pytest

from rtb import catalog, rays, readers, stats
from rtb.trace import Op, Trace


@pytest.mark.parametrize("name, lanes, traces", [
    # 800 x 600 x 32 spp; 1 camera + 4 depths x 1 NEE x 1 light + 3 bounces
    ("cbspheres_classic.offline64", 15_360_000, 8),
    # 512 x 512 x 2 spp; 1 camera + (2 + 2 + 1) NEE x 1 light + 2 bounces
    ("cbspheres_classic.realtime2", 524_288, 8),
])
def test_rays_per_frame(name, lanes, traces):
    render = catalog.cell(name)["job"]["render"]
    assert rays.lanes_per_frame(render) == lanes
    assert rays.traces_per_frame(render, 1) == traces
    assert rays.rays_per_frame(render, 1) == lanes * traces


def test_rays_count_lights():
    render = catalog.cell("cbspheres_classic.realtime2")["job"]["render"]
    # two lights: NEE traces double
    assert rays.traces_per_frame(render, 2) == 1 + 10 + 2


@pytest.mark.parametrize("values", [
    list(range(1, 101)), [5.0], [3.0, 1.0, 2.0],
    list(np.random.default_rng(3).exponential(size=257)),
])
def test_percentile_is_numpys(values):
    for q in (0, 50, 95, 100):
        assert stats.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)), rel=1e-12)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(iv, 0.0, 10.0) == pytest.approx(3.0)
    assert stats.covered(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(iv, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0),
                                         (4.0, 6.0)]


def test_idle_share_reads_the_union():
    # two overlapping kernels and a copy in a 10 s span: 5 s busy
    tr = Trace(device=[Op("k1", 1.0, 4.0), Op("k2", 3.0, 5.0),
                       Op("Memcpy DtoH (Device -> Pageable)", 7.0, 8.0)],
               host=[Op("rtbench.render", 0.0, 5.5),
                     Op("rtbench.get_image", 6.5, 9.5)],
               start=0.0, end=10.0, frames=2)
    assert readers.idle_share({}, {"trace": tr}) == pytest.approx(0.5)
    assert tr.busy_s() == pytest.approx(4.0 + 1.0)
    spec = {"kernels": ["k1"]}
    assert readers.kernel_ms(spec, {"trace": tr}) == pytest.approx(1500.0)
    others = readers.kernel_ms({"others": True},
                               {"trace": tr, "port_kernels": {"k1"}})
    assert others == pytest.approx(1000.0)  # k2 alone, the copy is no kernel
    assert sorted(tr.idle_gaps()) == [("host idle", 2.0),
                                      ("rtbench.get_image", 2.0),
                                      ("rtbench.render", 1.0)]
    assert readers.kernel_ms({"kernels": ["nothing"]}, {"trace": tr}) is None


def test_port_kernel_names():
    from rtb import system

    names = system.kernel_names()
    for k in ("dfs_kernel", "compact_kernel", "wf_count_kernel",
              "wf_pack_kernel", "wf_decode_kernel", "shade_hit_kernel",
              "nee_prep_kernel", "nee_accum_kernel", "scatter_kernel",
              "rng_uniform_kernel", "raygen_kernel", "film_kernel",
              "median3x3_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names


@pytest.mark.parametrize("copy, copied", [
    ("every", [0, 1, 2, 3, 4, 5]), ("last", [5]),
])
def test_copy_policy(copy, copied):
    from rtb import traffic

    it = traffic.frames({"frames_per_image": 6, "copy": copy})
    frames = [next(it) for _ in range(12)]
    assert [f.index for f in frames[:6] if f.copy] == copied
    assert [f.reset for f in frames] == [i % 6 == 0 for i in range(12)]
    assert frames[5].last and frames[6].image == 1


@pytest.mark.parametrize("copy", ["some", 2])
def test_copy_policy_refused(copy):
    from rtb import traffic

    with pytest.raises(ValueError):
        next(traffic.frames({"frames_per_image": 6, "copy": copy}))


def test_orbit_sweeps_within_its_span():
    from rtb import traffic

    cam = {"origin": [0.0, 0.75, 2.5], "look_at": [0.0, 0.75, 0.0]}
    job = {"orbit_deg": 5.0, "orbit_span_deg": 40.0}
    deg = []
    for i in range(40):
        o, look = traffic.pose(cam, job, i)
        assert np.allclose(look, cam["look_at"])
        assert np.linalg.norm(o - look) == pytest.approx(2.5)
        deg.append(round(float(np.degrees(np.arctan2(o[0], o[2]))), 6))
    assert deg[:9] == [0, 5, 10, 15, 20, 15, 10, 5, 0]
    assert deg[12] == -20 and deg[16] == 0 and max(deg) == 20
    # without a span the camera goes round
    o, _ = traffic.pose(cam, {"orbit_deg": 5.0}, 36)
    assert np.allclose(o, [0.0, 0.75, -2.5])
