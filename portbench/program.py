"""What the port records about itself, for the per-layer readers: its
spans (``utils/profiling.py``, kept while a profile runs) inside the
traced stretch, and its serving engine's counters (process totals).
A port that records none of them reads as nothing: no spans, None.

Host time under the profiler is not the window's: the traced stretch
records every operator, which slows eager code (an admission about 1.7
times). So a host span is read as its share of its parent's host time
in the stretch, times the parent's mean length in the untraced window;
device time is read from a span's CUDA events."""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.trace import union_seconds

# a span's edge may sit this far outside the run's own spans in the
# trace (the two are stamped on one clock by two readings)
EDGE_NS = 1_000_000


def stretch(trace) -> Optional[Tuple[int, int]]:
    """The traced stretch on the profiler's clock: from the first of the
    run's own spans in the trace to the end of the last, or None."""
    if not trace.spans:
        return None
    return trace.spans[0][0], max(end for _, end, _ in trace.spans)


def spans(r, name: str) -> List[Tuple[str, int, int, Optional[tuple]]]:
    """The port's spans called ``name`` inside the traced stretch, as
    ``utils/profiling.py`` ``spans`` records them: (name, start_ns,
    end_ns, events)."""
    try:
        from tpu_dra_driver_torch.workloads.utils.profiling import (
            spans as recorded,
        )
    except ImportError:
        return []
    extent = stretch(r.trace)
    if extent is None:
        return []
    lo, hi = extent[0] - EDGE_NS, extent[1] + EDGE_NS
    return [s for s in recorded()
            if s[0] == name and lo <= s[1] and s[2] <= hi]


def _host_ns(xs) -> int:
    return sum(end - start for _, start, end, _ in xs)


def admit_ms(r) -> Optional[float]:
    """Mean host milliseconds of one admission in the window: the run's
    own ``admit`` spans there, untraced."""
    lo = r.counters["window_since"]
    hi = lo + r.counters["window_s"]
    xs = [t1 - t0 for name, t0, t1 in r.spans.items
          if name == "admit" and lo <= t0 and t1 <= hi]
    return 1e3 * sum(xs) / len(xs) if xs else None


def admit_child_ms(r, name: str) -> Optional[float]:
    """Milliseconds of an admission in the window spent in the child
    span ``name``: its share of the ``serve.admit`` spans' host time in
    the traced stretch, times :func:`admit_ms`; None without either."""
    kids, admits = spans(r, name), spans(r, "serve.admit")
    whole = admit_ms(r) if kids and admits else None
    return None if whole is None else \
        whole * _host_ns(kids) / _host_ns(admits)


def device_ms_per(r, name: str, per: str) -> Optional[float]:
    """Device milliseconds (the spans' CUDA events) of the ``name`` spans
    over the number of ``per`` spans, or None without either or
    without events."""
    xs, n = spans(r, name), len(spans(r, per))
    if not xs or not n or any(ev is None for *_, ev in xs):
        return None
    total = 0.0
    for *_, (opened, closed) in xs:
        closed.synchronize()
        total += opened.elapsed_time(closed)
    return total / n


def idle_inside(intervals, windows) -> float:
    """Seconds of the [start, end) ns ``windows`` (disjoint) in which no
    one of the [start, end) ns ``intervals`` ran."""
    idle = 0.0
    for lo, hi in windows:
        inside = [(max(s, lo), min(t, hi)) for s, t in intervals
                  if s < hi and t > lo]
        idle += (hi - lo) / 1e9 - union_seconds(inside)
    return idle


def engine_counter(name: str) -> Optional[int]:
    """``ServingEngine``'s class counter ``name``, or None."""
    try:
        from tpu_dra_driver_torch.workloads.models.serving import (
            ServingEngine,
        )
    except ImportError:
        return None
    return getattr(ServingEngine, name, None)
