"""The cells at their own sizes on the card: a short run of each comes out
correct, and the control (the reference in bfloat16 in the program's
place) does not. Marked ``cuda``; each test skips without a card. Run on
the card with ``python -m pytest -m cuda cvbench/tests``."""

import time

import pytest
import torch

from cvbench_tiny import CELLS

from cvbench import calibrate, harness


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    device = _card()
    result, numbers = harness.run(cell, 2**32 + 3, 2.0, False, device,
                                  time.perf_counter())
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    device = _card()
    records = []
    calibrate.readings(cell, [], [2**32 + 5], 2.0, 2.0, device,
                       records.append)
    assert records and not records[0]["correct"], records
