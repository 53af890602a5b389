"""The output check's control, the reference with TF32 operands in the
program's place, fails every cell's check: on the CPU at a small size by
rounding the operands to TF32, and on a card by the library's TF32 mode.
At each cell's own size on the card it is `portbench/control.py`."""
from __future__ import annotations

import pytest

from portbench import control
from portbench.tests.conftest import SMALL, small_cell


@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_fails_on_the_cpu(name):
    for seed in (2 ** 31 + 1, 7):
        checks = control.control_checks(small_cell(name), seed, "cpu")
        assert not all(c.ok for c in checks), [(c.name, c.value)
                                              for c in checks]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_fails_on_the_card(cuda_card, name):
    for seed in (2 ** 31 + 1, 7, 8):
        checks = control.control_checks(small_cell(name), seed, "cuda")
        assert not all(c.ok for c in checks), [(c.name, c.value)
                                              for c in checks]
