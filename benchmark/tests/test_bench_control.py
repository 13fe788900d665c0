"""The control of the output check on the card, at each cell's own size:
the reference computed in float8 in the program's place fails at least
one of the cell's limits (run on the chip: `python -m pytest -m cuda
benchmark/tests/test_bench_control.py`)."""
import pytest
import torch

from harness import cell, check, control
from reference.precision import FP8

CELLS = ("zju.train", "zju_strict.frame512", "zju_fast.orbit256", "zju_fast.frame512")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    limits = cell.Cell(name).wl["limits"]
    numbers = control.numbers(name, 3, FP8)
    assert not all(ok for *_, ok in check.judged(numbers, limits))
