"""Benchmark timing helpers: warm-up, synchronise, best and median.

Port of :mod:`tpu_dra_driver.workloads.utils.timing`, with the same
names and meanings. Host times end in ``torch.cuda.synchronize()``.
Device seconds are the busy time of the card's kernels, memcpys and
memsets in one ``torch.profiler`` run (the union of their intervals, so
host dispatch gaps are excluded), the counterpart of the reference's
"XLA Modules" lane; they are ``None`` when the run did no CUDA work
(on the CPU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch


@dataclass
class Timed:
    median_s: float
    best_s: float
    times_s: List[float]


def _sync() -> None:
    """Wait until the card has finished all queued work (a no-op when
    this process has not used CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], Any], warmup: int = 2, iters: int = 5) -> Timed:
    """Time ``fn``; warm-up calls excluded, each timed call ends when the
    card is idle."""
    for _ in range(warmup):
        fn()
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return Timed(median_s=times[len(times) // 2], best_s=times[0],
                 times_s=times)


def marginal_chain_rate(make_run: Callable[[int], Callable[[], Any]],
                        chain_short: int, chain_long: int,
                        iters: int = 3, warmup: int = 2) -> float:
    """Steady-state seconds per step with the fixed per-call overhead
    cancelled: the best time of an n-step chain (``make_run(n)`` returns
    a zero-argument callable) at two lengths, and the slope between
    them."""
    times = {}
    for n in (chain_short, chain_long):
        run = make_run(n)
        times[n] = time_fn(run, warmup=warmup, iters=iters).best_s
    dt = times[chain_long] - times[chain_short]
    return max(dt, 1e-9) / (chain_long - chain_short)


def _busy_seconds(prof) -> Optional[float]:
    """Seconds during which the card ran at least one kernel, memcpy or
    memset in a finished profile, or None when it ran none."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        # the card's timeline holds kernels, memcpys and memsets, and
        # user annotations, which span idle gaps (not every torch
        # version can tell the latter apart)
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or (annotation is not None and annotation()):
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, t
        else:
            hi = max(hi, t)
    return (busy + hi - lo) / 1e9


def device_seconds_per_step(run: Callable[[], Any],
                            n_steps: int) -> Optional[float]:
    """Device-busy seconds per step of an n-step ``run()``: one warm call,
    then one call under ``torch.profiler``. None when no CUDA device is
    present or the run did no CUDA work; callers then fall back to
    :func:`marginal_chain_rate`."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    run()                              # first-call set-up, untimed
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        _sync()
    busy = _busy_seconds(prof)
    return None if busy is None else busy / n_steps


def device_seconds_total(run: Callable[[], Any]) -> Optional[float]:
    """Total device-busy seconds of one ``run()``: host dispatch gaps
    excluded, so two host loops with different dispatch patterns compare
    by the card's work. None as in :func:`device_seconds_per_step`."""
    return device_seconds_per_step(run, 1)


def chain_seconds_per_step(make_run: Callable[[int], Callable[[], Any]],
                           chain_short: int, chain_long: int,
                           iters: int = 3) -> float:
    """Seconds per step: device time of the long chain when there is a
    card, else the marginal-chain rate."""
    dev = device_seconds_per_step(make_run(chain_long), chain_long)
    if dev is not None:
        return dev
    return marginal_chain_rate(make_run, chain_short, chain_long, iters)


def chain_seconds_per_step_runs(make_run: Callable[[int], Callable[[], Any]],
                                chain_short: int, chain_long: int,
                                iters: int = 3,
                                n_runs: int = 1) -> List[float]:
    """Per-step seconds measured ``n_runs`` times on one long-chain
    callable (``make_run(chain_long)`` is called once): the run-to-run
    spread. One marginal-chain estimate when there is no card."""
    run = make_run(chain_long)
    out: List[float] = []
    for _ in range(n_runs):
        dev = device_seconds_per_step(run, chain_long)
        if dev is None:
            return [marginal_chain_rate(make_run, chain_short, chain_long,
                                        iters)]
        out.append(dev)
    return out
