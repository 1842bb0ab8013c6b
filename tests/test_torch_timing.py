"""The port's ``utils/timing.py`` against the JAX package's: the host-side
timing helpers give the same numbers on the same (simulated) clock, the
device-busy time is the union of the card's activity intervals, and
without a card every device figure is None and the chain helpers fall
back to the marginal-chain rate, as the reference's do on the CPU."""

import types

import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.utils import timing as jtiming
from tpu_dra_driver_torch.workloads.utils import timing as ttiming


class FakeClock:
    """A perf_counter that moves only when a simulated run does work: a
    fixed 0.25 s per call, ``step_s`` per chain step, and a jitter drawn
    from a seeded stream, so both modules see the same times."""

    def __init__(self, step_s=0.002, seed=0):
        self.t = 0.0
        self.step_s = step_s
        self.rng = np.random.RandomState(seed)

    def perf_counter(self):
        return self.t

    def make_run(self, n):
        def run():
            self.t += 0.25 + n * self.step_s + self.rng.uniform(0, 1e-3)
        return run


@pytest.fixture
def clocks(monkeypatch):
    """One fresh clock per module, with the same seed."""
    pair = {}
    for name, mod in (("jax", jtiming), ("torch", ttiming)):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(
                                perf_counter=clock.perf_counter))
        pair[name] = clock
    return pair


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("warmup,iters", [(0, 1), (2, 5), (1, 4)])
def test_time_fn_matches_reference(clocks, warmup, iters):
    want = jtiming.time_fn(clocks["jax"].make_run(10), warmup, iters)
    got = ttiming.time_fn(clocks["torch"].make_run(10), warmup, iters)
    assert got.times_s == want.times_s and len(got.times_s) == iters
    assert got.times_s == sorted(got.times_s)
    assert (got.median_s, got.best_s) == (want.median_s, want.best_s)


@pytest.mark.parametrize("short,long_,iters", [(32, 1056, 3), (1, 5, 1)])
def test_marginal_chain_rate_matches_reference(clocks, short, long_, iters):
    want = jtiming.marginal_chain_rate(clocks["jax"].make_run, short, long_,
                                       iters)
    got = ttiming.marginal_chain_rate(clocks["torch"].make_run, short,
                                      long_, iters)
    assert got == want
    # the fixed per-call cost cancels: the slope is the step time, up to
    # the jitter spread over the chain difference
    assert abs(got - 0.002) <= 1e-3 / (long_ - short)


def test_without_a_card_device_time_is_none_and_chains_fall_back(
        clocks, no_card):
    clock = clocks["torch"]
    assert ttiming.device_seconds_per_step(clock.make_run(8), 8) is None
    assert ttiming.device_seconds_total(clock.make_run(8)) is None
    want = jtiming.marginal_chain_rate(clocks["jax"].make_run, 4, 64, 2)
    assert ttiming.chain_seconds_per_step(clock.make_run, 4, 64, 2) == want
    runs = ttiming.chain_seconds_per_step_runs(clock.make_run, 4, 64, 2,
                                               n_runs=3)
    assert len(runs) == 1 and abs(runs[0] - 0.002) <= 1e-3 / 60


def _event(start, dur, cuda=True, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if cuda \
        else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(device_type=lambda: kind,
                                 start_ns=lambda: start,
                                 duration_ns=lambda: dur,
                                 is_user_annotation=lambda: annotation)


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("events,busy_ns", [
    # overlapping kernels count once, gaps not at all
    ([_event(0, 10), _event(5, 10), _event(20, 5)], 20),
    # out of order, one nested in another
    ([_event(100, 50), _event(0, 30), _event(110, 10)], 80),
    # host events and user annotations spanning idle gaps are not busy
    ([_event(0, 10), _event(0, 1000, cuda=False),
      _event(0, 1000, annotation=True), _event(40, 10)], 20),
])
def test_busy_seconds_is_the_union_of_card_intervals(events, busy_ns):
    assert ttiming._busy_seconds(_profile(events)) == pytest.approx(
        busy_ns / 1e9, rel=1e-12)


def test_busy_seconds_is_none_without_card_activity():
    assert ttiming._busy_seconds(_profile([])) is None
    assert ttiming._busy_seconds(
        _profile([_event(0, 10, cuda=False),
                  _event(0, 10, annotation=True)])) is None
