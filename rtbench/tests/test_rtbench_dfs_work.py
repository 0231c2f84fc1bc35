"""The DFS work readers: the bound from the port's tally, the metrics
per frame of a profiled span from the frames the tally counted after
it, and nothing where the port keeps no tally."""

import pytest

from rtb import catalog, dfs_work
from rtb.trace import Op, Trace

#: a tally of two launches over 1,000 lanes each, the second a shadow
#: pass with start bounds, over four frames
COUNTS = {"rays": 1500, "visits": 12_000, "boxes": 40_000, "tris": 60_000,
          "spheres": 10, "lanes": 2000, "start_lanes": 1000, "launches": 2,
          "table_bytes": 2 * 4096, "frames": 4}


def _port_counts(monkeypatch, counts):
    from cuda_raytracer_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "counters", lambda: counts)


def test_bound_counts_each_term():
    ops = 40_000 * 25 + 60_000 * 38 + 10 * 37 + 2000 * 3
    assert dfs_work.operations(COUNTS) == ops
    nbytes = 2000 * (25 + 8) + 1000 * 4 + 2 * 8 + 2 * 4096
    assert dfs_work.nbytes(COUNTS) == nbytes
    assert dfs_work.bound_s(COUNTS) == pytest.approx(
        max(ops / 67e12, nbytes / 3.35e12))


def test_readers_over_a_span(monkeypatch):
    _port_counts(monkeypatch, {"dfs": COUNTS})
    kernel = "void dfs_kernel<4, false, true>(float const*, ...)"
    tr = Trace(device=[Op(kernel, 0.0, 2e-6), Op("other_kernel", 0.0, 1.0),
                       Op(kernel, 1.0, 1.0 + 2e-6)],
               host=[], start=0.0, end=2.0, frames=2)
    visits = catalog.metric_reader("dfs_visits_per_ray")({"trace": tr})
    assert visits == pytest.approx(8.0)
    share = catalog.metric_reader("dfs_kernel_roofline")({"trace": tr})
    # a counted frame's bound over a profiled frame's dfs_kernel time
    assert share == pytest.approx(100 * (dfs_work.bound_s(COUNTS) / 4)
                                  / (4e-6 / 2))


@pytest.mark.parametrize("counts", [
    None, {}, {"dfs": dict(COUNTS, launches=0)},
    {"dfs": dict(COUNTS, frames=0)}])
def test_no_tally_reads_nothing(monkeypatch, counts):
    """A port without the tally (or one that counted nothing, or no
    frame) leaves both metrics out."""
    from cuda_raytracer_tpu_torch.utils import timing

    if counts is None:
        monkeypatch.delattr(timing, "counters", raising=False)
    else:
        _port_counts(monkeypatch, counts)
    tr = Trace(device=[Op("dfs_kernel", 0.0, 1e-3)], host=[], start=0.0,
               end=1.0, frames=1)
    for name in ("dfs_visits_per_ray", "dfs_kernel_roofline"):
        assert catalog.metric_reader(name)({"trace": tr}) is None
