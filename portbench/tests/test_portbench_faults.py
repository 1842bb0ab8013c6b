"""Whole runs of each cell, tiny on the CPU, with the timed path sound
and then broken underneath: the check has to come out false for every
fault the cell can have. The chip's own look is skipped (the runs take
``device="cpu"``); the limits are the cells' own."""

import pytest

from portbench import calibrate, harness

SEED = 2**33 + 21

FAULTS = [
    ("train.sc2-7b.pack4k", "unchanged_state"),
    ("train.sc2-7b.pack4k", "half_batch"),
    ("train.sc2-7b.win16k", "unchanged_state"),
    ("train.sc2-7b.win16k", "half_batch"),
    ("serve.sc2-3b.decode", "altered_token"),
    ("gen.sc2-3b.batch384", "altered_token"),
]


@pytest.mark.parametrize("cell", sorted(harness.benchmark() and {
    w["name"] for w in harness.benchmark()["workloads"]}))
def test_sound_run_is_correct(cell, tiny):
    line = harness.run_cell(cell, SEED, 1.0, False, "cpu", **tiny(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in harness.benchmark()["end_to_end"]
           if harness.applies(m, cell, [])}
    assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, tiny):
    got = calibrate.reading(cell, SEED, fault, 1.0, "cpu", **tiny(cell))
    limits = harness.load_cell(cell)["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)
