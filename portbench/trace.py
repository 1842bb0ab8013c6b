"""Spans on the host's clock and the reading of a ``torch.profiler`` trace.

A run records its own spans (``admit``, ``chunk``, ``prefill``,
``gen_call``, ``train_step``) around its calls into the program. With
``--trace 1`` a span is also a ``record_function`` range, so the trace
holds it beside the card's kernels on one clock.

:class:`DeviceTrace` reduces a finished profile to what the per-layer
readers need: each device interval (kernels, copies, sets) with its name
and the host span that launched it, found through the launch's
correlation id (the profiler does not charge a kernel launched through
``ctypes`` to an enclosing range, so ranges alone cannot), the busy time
as the union of the intervals (the arithmetic of the port's
``utils/timing.py:_busy_seconds``), and the idle gaps by the host span
that was open when each began.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
SPAN_NAMES = ("admit", "chunk", "prefill", "gen_call", "train_step")
OUTSIDE = "between_spans"


@dataclass
class Spans:
    """Host spans of a run: (name, start, end) on ``time.perf_counter``,
    kept in memory. With ``annotate`` each span is also a profiler
    range."""

    annotate: bool = False
    items: List[Tuple[str, float, float]] = field(default_factory=list)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        if name not in SPAN_NAMES:
            raise ValueError(f"unknown span {name!r}")
        ctx = torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def seconds(self, name: str, since: float = 0.0) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.items
                if n == name and t0 >= since]


def kernel_patterns(family: str) -> List[re.Pattern]:
    """The name patterns of ``kernels/<family>.json``."""
    path = KERNELS_DIR / f"{family}.json"
    data = json.loads(path.read_text())
    return [re.compile(p) for p in data["patterns"]]


@dataclass
class Interval:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    kind: str           # "kernel", "memcpy" or "memset"
    span: str           # the host span that launched it
    graph: bool         # launched by a CUDA graph replay


def _kind(e) -> Optional[str]:
    """"kernel", "memcpy", "memset" for the card's intervals, None for
    anything else (host events, annotations)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return None
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return None
    kind = getattr(e, "activity_type", None)
    kind = str(kind()).lower() if kind is not None else ""
    if "annotation" in kind:
        return None
    name = e.name()
    if "memcpy" in kind or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in kind or name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_seconds(spans: Sequence[Tuple[int, int]]) -> float:
    """Seconds covered by at least one of the [start, end) ns spans."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, (lo, hi) = 0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, t
        else:
            hi = max(hi, t)
    return (busy + hi - lo) / 1e9


class DeviceTrace:
    """The card's side of one finished profile, and the host spans.
    ``outside`` names the time no recorded span covers (a span opened
    before the profile started is not recorded)."""

    def __init__(self, prof, window_s: float, outside: str = OUTSIDE):
        self.window_s = window_s
        events = list(prof.profiler.kineto_results.events())
        spans, launches, device = [], {}, []
        for e in events:
            kind = _kind(e)
            if kind is not None:
                device.append((e, kind))
                continue
            name = e.name()
            if name in SPAN_NAMES:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
            elif name.startswith("cuda") or name.startswith("cu"):
                launches[e.correlation_id()] = (e.start_ns(), name)
        spans.sort()
        self.spans = spans
        # graph replays the host issued while the profile ran
        self.graph_replays = sum(1 for _, name in launches.values()
                                 if "GraphLaunch" in name)
        starts = [s for s, _, _ in spans]

        def span_at(t: int) -> str:
            i = bisect_right(starts, t) - 1
            while i >= 0:
                s, end, name = spans[i]
                if s <= t < end:
                    return name
                i -= 1
                if i >= 0 and spans[i][1] <= t:
                    break
            return outside

        self.intervals: List[Interval] = []
        for e, kind in device:
            launch = launches.get(e.correlation_id())
            t_launch = launch[0] if launch else e.start_ns()
            graph = bool(launch) and "Graph" in launch[1]
            self.intervals.append(Interval(
                e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), kind,
                span_at(t_launch), graph))
        self.intervals.sort(key=lambda iv: iv.start)
        self._span_at = span_at

    @property
    def busy_s(self) -> float:
        return union_seconds([(iv.start, iv.end) for iv in self.intervals])

    def kernels(self) -> List[Interval]:
        return [iv for iv in self.intervals if iv.kind == "kernel"]

    def family_seconds(self, family: str) -> Tuple[float, int]:
        """(summed seconds, count) of the kernels that ``family``'s
        patterns match."""
        pats = kernel_patterns(family)
        hits = [iv for iv in self.kernels()
                if any(p.search(iv.name) for p in pats)]
        return sum(iv.end - iv.start for iv in hits) / 1e9, len(hits)

    def kernel_seconds(self) -> float:
        return sum(iv.end - iv.start for iv in self.kernels()) / 1e9

    def graph_busy_s(self) -> float:
        """Busy seconds of the intervals that graph replays launched."""
        return union_seconds([(iv.start, iv.end) for iv in self.intervals
                              if iv.graph])

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for iv in self.intervals:
            by[iv.name] += (iv.end - iv.start) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the card between its intervals, inside the
        spans' extent, summed by the host span open when each gap began."""
        ivs = sorted((iv.start, iv.end) for iv in self.intervals)
        if not ivs:
            return []
        lo = self.spans[0][0] if self.spans else ivs[0][0]
        hi = max(end for _, end, _ in self.spans) if self.spans \
            else max(t for _, t in ivs)
        by: Dict[str, float] = defaultdict(float)
        cursor = lo
        for s, t in ivs:
            if s > cursor and cursor < hi:
                gap_end = min(s, hi)
                by[self._span_at(cursor)] += (gap_end - cursor) / 1e9
            cursor = max(cursor, t)
        if cursor < hi:
            by[self._span_at(cursor)] += (hi - cursor) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def check_families(trace: DeviceTrace, families: Sequence[str]) -> List[str]:
    """The families among ``families`` whose patterns match no kernel of
    the trace."""
    return [f for f in families if trace.family_seconds(f)[1] == 0]


# what is not elementwise work: the products and the five attention
# kernels B1-B5
NOT_ELEMENTWISE = ("cublas", "flash_fwd", "flash_bwd", "paged_decode",
                   "decode")


def elementwise_share(kernels: Sequence[Interval]) -> Optional[float]:
    """Percent of the kernels' time in kernels of none of
    ``NOT_ELEMENTWISE``'s families, or None without kernels."""
    total = sum(iv.end - iv.start for iv in kernels)
    if not total:
        return None
    pats = [p for f in NOT_ELEMENTWISE for p in kernel_patterns(f)]
    other = sum(iv.end - iv.start for iv in kernels
                if not any(p.search(iv.name) for p in pats))
    return 100.0 * other / total


def idle_share(trace: DeviceTrace) -> Optional[float]:
    """Percent of the traced window in which the card ran nothing."""
    if not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
