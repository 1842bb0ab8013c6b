"""Milliseconds of an admission in the window spent in the engine's
``serve.admit.prefill`` span: the prompt's and blocks' copies to the card
and the eager batch-1 ``block_prefill``. The span's share of
``serve.admit`` in the traced stretch, times the window's mean
admission (``portbench/program.py``)."""

from portbench import program


def read(r):
    return program.admit_child_ms(r, "serve.admit.prefill")
