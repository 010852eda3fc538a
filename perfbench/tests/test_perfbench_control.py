"""The lower-precision control comes out not correct at each cell's own
size on the card: the reference in float8 put in the program's place.
Needs a CUDA card (`python3 -m pytest perfbench/tests -m card` on the
card's machine); skips without one."""

import pytest

from perfbench import harness, readings

CELLS = ["avenet_train_flagship", "fullmodel_train_tube3d"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name, card):
    cell = harness.load_cell(name)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    got = readings.reading(cell, gen, 2 ** 31 + 77, "control", card)
    limits = harness.limits_of(cell)
    assert any(got[k] > v for k, v in limits.items()), (got, limits)
