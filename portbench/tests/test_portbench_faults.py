"""A run whose timed path is broken underneath must come out not correct:
each cell driven on the CPU at a small size, past the harness's look for
a card, with one fault of ``portbench/faults.py`` planted in the program
where the window calls it."""

import pytest

from portbench import faults
from portbench.core import cell_files
from portbench.run import run_cell
from portbench.tests.conftest import SMALL

CASES = [(cell, fault) for cell in SMALL
         for fault in faults.BY_KIND[cell_files(cell)[0]["kind"]][1]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    faults.plant(monkeypatch, cell_files(cell)[0]["kind"], fault)
    result, checks = run_cell(cell, 2 ** 32 + 99, 2.5, False, "cpu",
                              SMALL[cell])
    assert result["attempted"] >= 1
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    result, checks = run_cell(cell, 2 ** 32 + 99, 2.5, False, "cpu",
                              SMALL[cell])
    assert result["correct"] is True, checks
