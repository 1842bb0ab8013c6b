"""The readers of what the port records about itself
(``portbench/program.py``): traced runs of the serving and training
cells, tiny on the CPU, give each reader's value, or None where the CPU
has nothing to read (device events); a port that records nothing reads
as None; and the arithmetic against the program's spans."""

import collections
import functools
import importlib

import pytest

from portbench import harness, program, trace
from portbench.trace import Spans
from portbench.conftest import TINY, TINY_CONFIG

SEED = 2**33 + 7
# the cells' own stretches are seconds of the card; on the CPU a
# shorter one holds admissions and chunks
STRETCH = {"serve.sc2-3b.decode": {"trace_seconds": 0.3},
           "train.sc2-7b.pack4k": {}}
NEW = {
    "serve.sc2-3b.decode": ("admit_prefill_ms.serve",
                            "admit_pool_write_ms.serve",
                            "admit_first_token_ms.serve",
                            "admit_idle_share.serve",
                            "steps_per_chunk.serve", "rows_per_step.serve"),
    "train.sc2-7b.pack4k": ("forward_ms.train", "backward_ms.train",
                            "optimizer_ms.train"),
}


def _reader(name):
    return harness._load_module(harness.HERE / "metrics" / f"{name}.py",
                                "portbench_metric_" + name.replace(".", "_"))


@functools.lru_cache(maxsize=None)
def _traced(cell):
    """(the reading of a traced tiny run of ``cell``, the names of the
    port's spans it recorded)."""
    from tpu_dra_driver_torch.workloads.utils import profiling
    mix, params = TINY[cell]
    merged = dict(harness.load_cell(cell)["params"], **params,
                  **STRETCH[cell])
    run = harness.make_run(cell, SEED, 0.3, True, "cpu",
                           config_override=TINY_CONFIG, mix_override=mix,
                           cell_override={"params": merged},
                           log=lambda s: None)
    buffer = collections.deque(maxlen=profiling.MAX_SPANS)
    saved, profiling._spans = profiling._spans, buffer
    try:
        entry = importlib.import_module(
            f"portbench.entries.{run.cell['entry']}")
        reading = harness.Reading(run, entry.run(run))
        values = {m: _reader(m).read(reading) for m in NEW[cell]}
        if cell.startswith("serve."):
            values["idle_share.serve"] = \
                _reader("idle_share.serve").read(reading)
            values["admit_ms"] = program.admit_ms(reading)
    finally:
        profiling._spans = saved
    return values, {name for name, *_ in buffer}


def test_new_metrics_are_listed_for_their_cells():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert cell in per_layer[name]["workloads"]
            assert (harness.HERE / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("metric", NEW["serve.sc2-3b.decode"])
def test_serving_readers_read_the_engines_records(metric):
    values, _ = _traced("serve.sc2-3b.decode")
    got = values[metric]
    assert got is not None and got > 0, values
    if metric == "rows_per_step.serve":
        assert got <= TINY["serve.sc2-3b.decode"][1]["max_batch"]
    if metric == "steps_per_chunk.serve":
        assert 1 <= got <= 32
    if metric == "admit_idle_share.serve":
        assert got <= values["idle_share.serve"]


def test_admission_children_split_the_windows_admission():
    """The three children's shares of ``serve.admit``, times the
    window's mean admission, add up to no more than it."""
    values, _ = _traced("serve.sc2-3b.decode")
    kids = sum(values[m] for m in NEW["serve.sc2-3b.decode"][:3])
    assert 0.5 * values["admit_ms"] < kids <= values["admit_ms"]


@pytest.mark.parametrize("metric", NEW["train.sc2-7b.pack4k"])
def test_training_readers_are_none_without_device_events(metric):
    values, names = _traced("train.sc2-7b.pack4k")
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer"} <= names
    assert values[metric] is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_no_program_span_takes_a_name_of_the_benchmarks(cell):
    _, names = _traced(cell)
    assert names and not names & set(trace.SPAN_NAMES)


@pytest.mark.parametrize("metric", sorted(
    m for names in NEW.values() for m in names))
def test_a_port_that_records_nothing_reads_none(metric, monkeypatch):
    """As on a port without the recorder and the counters: no spans in
    the buffer, no counter on the engine."""
    from tpu_dra_driver_torch.workloads.models.serving import ServingEngine
    from tpu_dra_driver_torch.workloads.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    for name in ("chunks", "decode_steps", "row_steps"):
        monkeypatch.delattr(ServingEngine, name)

    class Trace:
        spans = [(0, 10, "admit")]
        intervals = []
        window_s = 1.0

    class Reading:
        trace = Trace()

    assert _reader(metric).read(Reading()) is None


def test_idle_inside_the_windows():
    intervals = [(0, 10), (5, 20), (30, 40)]
    # [0, 25): busy 0-20, idle 5 ns; [28, 50): busy 30-40, idle 12 ns
    assert program.idle_inside(intervals, [(0, 25), (28, 50)]) \
        == pytest.approx(17e-9)
    assert program.idle_inside([], [(0, 100)]) == pytest.approx(100e-9)
    assert program.idle_inside(intervals, []) == 0.0


def test_spans_outside_the_stretch_are_left_out(monkeypatch):
    from tpu_dra_driver_torch.workloads.utils import profiling
    edge = program.EDGE_NS
    rec = [("serve.admit", -2 * edge, 10 - 2 * edge, None),
           ("serve.admit", 100 + edge + 1, 200 + edge, None),
           ("serve.admit", 50 - edge, 90, None),
           ("serve.admit.prefill", 60, 80, None)]
    monkeypatch.setattr(profiling, "spans", lambda: rec)

    class Trace:
        spans = [(50, 100, "admit")]

    class Reading:
        trace = Trace()

    assert program.spans(Reading(), "serve.admit") == [rec[2]]


def test_a_child_is_its_share_of_the_windows_admission(monkeypatch):
    """Host time in the stretch gives the split, the window's own
    ``admit`` spans the length: the stretch's admissions and those
    before the window are left out of it."""
    from tpu_dra_driver_torch.workloads.utils import profiling
    rec = [("serve.admit.prefill", 10, 40, None),
           ("serve.admit", 0, 50, None),
           ("serve.admit.prefill", 60, 90, None),
           ("serve.admit", 55, 105, None)]
    monkeypatch.setattr(profiling, "spans", lambda: rec)

    class Trace:
        spans = [(0, 110, "admit")]

    class Reading:
        trace = Trace()
        counters = {"window_since": 10.0, "window_s": 5.0}
        spans = Spans(items=[
            ("admit", 9.0, 9.5),            # set-up
            ("admit", 10.0, 10.02), ("chunk", 10.02, 10.04),
            ("admit", 11.0, 11.04),
            ("admit", 16.0, 16.5)])         # the traced stretch

    assert program.admit_ms(Reading()) == pytest.approx(30.0)
    assert program.admit_child_ms(Reading(), "serve.admit.prefill") \
        == pytest.approx(30.0 * 60 / 100)
    assert program.admit_child_ms(Reading(), "serve.admit.pool_write") \
        is None
