"""Profiling helpers: ``torch.profiler`` traces, and the port's spans.

Port of :mod:`tpu_dra_driver.workloads.utils.profiling`:

    with trace_to("/tmp/prof"):
        step(params, opt_state, batch)      # traced region

    with annotate("serve.admit"):           # named span inside a trace
        block_prefill(...)

A trace records the host's operators and, on the card, its kernels,
copies and memsets, and lands as a Chrome trace
(``trace.json``, readable by Perfetto and ``chrome://tracing``) under
``<dir>/plugins/profile/<run>/``, the reference's TensorBoard layout, so
:func:`latest_trace` finds the newest run by its sorted name.

**Spans.** :func:`annotate` is the port's one span API: a
``record_function`` range of its name, so the Chrome trace shows it.
While a ``torch.profiler`` profile runs, a span that closes also appends
``(name, start_ns, end_ns, events)`` to an in-memory buffer of at most
``MAX_SPANS`` (the newest kept), which :func:`spans` reads; nothing is
written to disk, the profile's own trace is the exporter. A span's
parent is the span whose extent holds it. ``device=True`` also records a
pair of timing events on the current CUDA stream at open and close
(``events``, else None), for code run eagerly, never inside a captured
graph's body: the card runs behind the host, so the events, not the
host's edges, bound the span's device work.

**Clock.** Start and end are Unix-epoch nanoseconds
(``time.time_ns``), the clock the profiler stamps its host ranges and,
on the card, its kernels and copies with: a span can be set beside the
device intervals of the same trace.

**Off path.** With no profile running a span is one flag test
(``torch.autograd._profiler_enabled``): it opens no range, creates no
event, appends nothing and returns a shared no-op context.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the profiler is process-global: one trace at a time
_active = threading.Lock()

MAX_SPANS = 1 << 16
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_OFF = contextlib.nullcontext()


def _run_name() -> str:
    """A run directory name that sorts by start time (the reference's
    ``YYYY_MM_DD_HH_MM_SS`` runs, with microseconds)."""
    now = time.time()
    return (time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime(now))
            + f"_{int(now * 1e6) % 1_000_000:06d}")


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where the card
    is present) of the with-block into ``log_dir``. Yields the
    directory; nested uses raise (one trace at a time: the profiler is
    process-global)."""
    if not _active.acquire(blocking=False):
        raise RuntimeError("a trace_to trace is already running; the "
                           "profiler is process-global")
    try:
        os.makedirs(log_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        run = os.path.join(log_dir, "plugins", "profile", _run_name())
        prof = profile(activities=activities)
        prof.start()
        try:
            yield log_dir
        finally:
            # the trace is written whether or not the block raised, as
            # the reference's stop_trace writes it
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(run, exist_ok=True)
            prof.export_chrome_trace(os.path.join(run, "trace.json"))
    finally:
        _active.release()


@contextlib.contextmanager
def _recorded(name: str, device: bool) -> Iterator[None]:
    """An open span while a profile runs (see :func:`annotate`)."""
    events = None
    if device and torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    start = time.time_ns()
    with record_function(name):
        yield
    end = time.time_ns()
    if events is not None:
        events[1].record()
    _spans.append((name, start, end, events))


def annotate(name: str, device: bool = False):
    """A named span (see the module's docstring): a context manager
    that, while a profile runs, opens a ``record_function`` range and
    records the span; ``device`` adds CUDA timing events where CUDA is
    in use. Without a profile it does nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _recorded(name, device)


def spans() -> List[Tuple[str, int, int, Optional[tuple]]]:
    """The recorded ``(name, start_ns, end_ns, events)``, in the order
    they closed (a child before its parent)."""
    return list(_spans)


def latest_trace(log_dir: str) -> Optional[str]:
    """Path of the newest capture under ``log_dir`` (TensorBoard layout),
    or None."""
    root = os.path.join(log_dir, "plugins", "profile")
    if not os.path.isdir(root):
        return None
    runs = sorted(os.listdir(root))
    return os.path.join(root, runs[-1]) if runs else None
