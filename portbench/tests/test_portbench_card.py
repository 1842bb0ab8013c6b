"""On the card, at each cell's own size: the control (the next precision
down) has to come out not correct. Skips without a card; run with
``python3 -m pytest portbench/tests -m card``."""

import pytest
import torch

from portbench import calibrate, harness

SEED = 3_456_789_013


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(
    w["name"] for w in harness.benchmark()["workloads"]))
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    got = calibrate.reading(cell, SEED, "control", 15.0)
    limits = harness.load_cell(cell)["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)
