"""Device milliseconds of one replayed decode step: the busy time of the
kernels that CUDA-graph replays launched in the traced stretch, over the
replays."""


def read(r):
    t = r.trace
    if not t.graph_replays:
        return None
    return 1e3 * t.graph_busy_s() / t.graph_replays
