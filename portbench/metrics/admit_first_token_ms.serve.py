"""Milliseconds of an admission in the window spent in the engine's
``serve.admit.first_token`` span: the host's read of the first token,
which waits for the card to finish the admission's work. The span's
share of ``serve.admit`` in the traced stretch, times the window's mean
admission (``portbench/program.py``)."""

from portbench import program


def read(r):
    return program.admit_child_ms(r, "serve.admit.first_token")
