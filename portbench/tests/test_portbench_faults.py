"""The output check fails runs whose timed path is broken.  Each test
drives a whole run on the CPU at a small size (the harness's look for a
card skipped), with one fault of `faults.FAULTS` planted in the program
underneath, and sees `correct` come out false; a sound run comes out true.
The faults a cell can have: an answer altered where it is produced, half
of the batch left out with the mean of the rest in its place, and, where
the cell carries state, a step that returns its state unchanged.  No cell
spans chips, so none can leave out an exchange."""
from __future__ import annotations

import pytest

from portbench.tests import faults
from portbench.tests.conftest import SMALL, cpu_run


@pytest.mark.parametrize("name", list(SMALL))
def test_a_sound_run_is_correct(name):
    result = cpu_run(name)
    assert result["correct"] is True, result["checks"]


CASES = [(name, fault) for name in SMALL for fault in faults.FAULTS[name]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    faults.FAULTS[name][fault](monkeypatch.setattr)
    result = cpu_run(name)
    assert result["correct"] is False, result["checks"]
