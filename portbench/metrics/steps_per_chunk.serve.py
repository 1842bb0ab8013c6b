"""Decode steps per host round trip: ``ServingEngine.decode_steps`` over
``ServingEngine.chunks`` (each chunk ends in a read of its tokens on the
host). Process totals: the window's chunks with set-up's one and the
traced stretch's; a chunk's k follows the rows' remaining tokens, not
the clock."""

from portbench import program


def read(r):
    chunks = program.engine_counter("chunks")
    steps = program.engine_counter("decode_steps")
    if not chunks or steps is None:
        return None
    return steps / chunks
