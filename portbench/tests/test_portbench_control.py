"""The control comes out not correct: the plain reference put in the
program's place and computed in the precision below the configuration's
(the forest's split choice in float32, KNN's distances and the scorer's
compares in bfloat16) fails at least one of each cell's limits.  On the
CPU at small sizes; at the cell's own size on the card, over three
seeds."""

import pytest

from portbench.control import control_readings
from portbench.core import cell_files
from portbench.tests.conftest import SMALL


def _fails(cell, readings):
    limits = cell_files(cell)[0]["limits"]
    return [n for n, v in readings.items() if not v <= limits[n]]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_at_a_small_size(cell):
    assert _fails(cell, control_readings(cell, 2 ** 32 + 3, "cpu",
                                         SMALL[cell]))


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13):
        assert _fails(cell, control_readings(cell, seed, card))
