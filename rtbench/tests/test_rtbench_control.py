"""The control (the reference in bfloat16 in the program's place) comes
out not correct: at a small size on the CPU, and at the cell's own size
on the card."""

import pytest

from conftest import CELLS, SCENES, small
from rtb import catalog, check, control



@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name, scene):
    numbers = control.readings(small(name, scene), 31_337_000_001, 3, "cpu")
    numbers.pop("gaps")
    assert not check.passed(numbers), numbers


def test_records_are_a_runs():
    cell = small("cbspheres_classic.realtime2")
    recs = control.records_for(cell, 5, 4)
    assert {r["median"] for r in recs} == {True, False}
    per = cell["job"]["frames_per_image"]
    for r in recs:
        idx = [f[0] for f in r["frames"]]
        assert idx[0] % per == 0 and idx == list(range(idx[0],
                                                       idx[0] + len(idx)))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, cuda_device):
    numbers = control.readings(catalog.cell(name), 31_337_000_002, 20,
                               cuda_device)
    numbers.pop("gaps")
    assert not check.passed(numbers), numbers
