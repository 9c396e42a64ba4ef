"""The control, the reference in bfloat16 put in the program's place, has
to come out as not correct: on the CPU at a small size here, and on the
card at the cell's own size (marked ``card``)."""

import pytest

from nbbench import control, harness
from nbbench.tests.conftest import small_cell
from nbbench.tests.test_nbbench_faults import SIZES

CELLS = sorted(SIZES)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_small(name, cpu):
    ok, checks = control.run_control(small_cell(name, SIZES[name]), 3_000_000_777, cpu)
    assert not ok, checks


def test_lower_precision_table():
    assert control.LOWER == {"float32": "bfloat16"}


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name, cuda_device):
    ok, checks = control.run_control(harness.load_cell(name), 3_000_000_778, cuda_device)
    assert not ok, checks
