"""Percent of the traced window in which the card ran no kernel, copy or
set."""

from portbench.trace import idle_share


def read(r):
    return idle_share(r.trace)
