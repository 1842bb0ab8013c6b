"""Milliseconds of an admission in the window spent in the engine's
``serve.admit.pool_write`` span: the 2 x n_layers writes of the prompt's
K/V into its pool blocks, each with its pad and cast. The span's share
of ``serve.admit`` in the traced stretch, times the window's mean
admission (``portbench/program.py``)."""

from portbench import program


def read(r):
    return program.admit_child_ms(r, "serve.admit.pool_write")
