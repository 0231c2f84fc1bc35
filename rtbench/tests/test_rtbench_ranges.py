"""The readers of the port's host ranges (``metrics/prepare_ms.py``,
``launch_ms.py``, ``copy_ms.py``) on synthetic traces: the outermost of
nested ranges only, ms per profiled frame, and no value where the span
holds no ``crt.`` range (a program that opens none)."""

import pytest

from rtb import catalog
from rtb.trace import Op, Trace

#: one frame's host ranges, in seconds: a depth program whose capture
#: opens a nested program range, the film, a pool copy, the wait and an
#: image copy, beside the benchmark's own ranges and a torch op
HOST = [
    Op("rtbench.render", 0.0, 9.0),
    Op("crt.frame.inputs", 0.0, 1.0),
    Op("aten::copy_", 0.5, 0.7),
    Op("crt.frame.raygen", 1.0, 1.5),
    Op("crt.frame.depth0", 1.5, 3.5),
    Op("crt.frame.raygen", 2.0, 2.5),
    Op("crt.frame.partition1", 3.5, 4.0),
    Op("crt.frame.film", 4.0, 4.25),
    Op("crt.frame.copy_out", 4.25, 4.5),
    Op("crt.frame.wait", 4.5, 8.0),
    Op("rtbench.get_image", 9.0, 9.75),
    Op("crt.image.copy", 9.0, 9.5),
    Op("crt.frame.inputs_x", 9.5, 9.75),
]


def trace(host, frames=1):
    return Trace(device=[Op("k", 0.0, 1.0)], host=host, start=0.0,
                 end=10.0, frames=frames)


@pytest.mark.parametrize("name, seconds", [
    ("prepare_ms", 1.0),
    # raygen + depth0 (the nested raygen once) + partition + film + copy
    ("launch_ms", 0.5 + 2.0 + 0.5 + 0.25 + 0.25),
    ("copy_ms", 0.5),
])
@pytest.mark.parametrize("frames", [1, 4])
@pytest.mark.parametrize("suffix", ["", ".realtime"])
def test_range_ms_per_frame(name, seconds, frames, suffix):
    read = catalog.metric_reader(name + suffix)
    assert read({"trace": trace(HOST, frames)}) == pytest.approx(
        seconds * 1e3 / frames)


@pytest.mark.parametrize("name", ["prepare_ms", "launch_ms", "copy_ms"])
def test_no_crt_range_no_value(name):
    read = catalog.metric_reader(name)
    plain = [op for op in HOST if not op.name.startswith("crt.")]
    assert read({"trace": trace(plain)}) is None
    assert read({"trace": trace(HOST, frames=0)}) is None
    # ranges of the port, none of them this metric's: nothing spent there
    other = [Op("crt.frame.wait", 0.0, 1.0)]
    assert read({"trace": trace(other)}) == 0.0


def test_ranges_clipped_to_the_span():
    host = [Op("crt.frame.inputs", -1.0, 0.5), Op("crt.frame.inputs",
                                                  9.5, 11.0)]
    assert catalog.metric_reader("prepare_ms")(
        {"trace": trace(host)}) == pytest.approx(1000.0)
