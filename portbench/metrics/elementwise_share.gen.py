"""Percent of the replayed decode steps' kernel time in kernels that are
neither cuBLAS products nor B1-B5: norms, RoPE, GELU, casts, copies."""

from portbench.trace import elementwise_share


def read(r):
    return elementwise_share([iv for iv in r.trace.kernels() if iv.graph])
