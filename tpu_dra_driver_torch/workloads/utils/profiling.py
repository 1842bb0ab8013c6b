"""Profiling helpers: ``torch.profiler`` wrappers for the workload tier.

Port of :mod:`tpu_dra_driver.workloads.utils.profiling`:

    with trace_to("/tmp/prof"):
        step(params, opt_state, batch)      # traced region

    with annotate("prefill"):               # named range inside a trace
        block_prefill(...)

A trace records the host's operators and, on the card, its kernels,
copies and memsets, and lands as a Chrome trace
(``trace.json``, readable by Perfetto and ``chrome://tracing``) under
``<dir>/plugins/profile/<run>/``, the reference's TensorBoard layout, so
:func:`latest_trace` finds the newest run by its sorted name.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the profiler is process-global: one trace at a time
_active = threading.Lock()


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


def annotate(name: str):
    """Named span on the profiler timeline
    (``torch.profiler.record_function``)."""
    return record_function(name)


def latest_trace(log_dir: str) -> Optional[str]:
    """Path of the newest capture under ``log_dir`` (TensorBoard layout),
    or None."""
    root = os.path.join(log_dir, "plugins", "profile")
    if not os.path.isdir(root):
        return None
    runs = sorted(os.listdir(root))
    return os.path.join(root, runs[-1]) if runs else None
