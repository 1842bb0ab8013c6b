"""Percent of the traced training steps' kernel time in kernels that are
neither cuBLAS products nor B1-B5: norms, RoPE, GELU, casts, the loss's
softmax and the optimizer."""

from portbench.trace import elementwise_share


def read(r):
    return elementwise_share(r.trace.kernels())
