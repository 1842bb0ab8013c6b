"""Mean host milliseconds of one ``ServingEngine.add`` in the window: the
run's ``admit`` spans (prefill, pool writes and the first token's read)."""


def read(r):
    xs = r.spans.seconds("admit", since=r.counters["window_since"])
    return 1e3 * sum(xs) / len(xs) if xs else None
