"""Percent of the traced stretch in which the card ran nothing while the
engine's ``serve.admit`` span was open: the trace's device intervals
against the program's spans, on the profiler's clock, over the
stretch."""

from portbench import program


def read(r):
    admits = program.spans(r, "serve.admit")
    if not admits or not r.trace.window_s:
        return None
    idle = program.idle_inside(
        [(iv.start, iv.end) for iv in r.trace.intervals],
        [(start, end) for _, start, end, _ in admits])
    return 100.0 * idle / r.trace.window_s
