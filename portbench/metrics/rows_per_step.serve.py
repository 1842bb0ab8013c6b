"""Active rows per decode step: ``ServingEngine.row_steps`` over
``ServingEngine.decode_steps``. Process totals: the window's chunks with
set-up's one and the traced stretch's."""

from portbench import program


def read(r):
    steps = program.engine_counter("decode_steps")
    rows = program.engine_counter("row_steps")
    if not steps or rows is None:
        return None
    return rows / steps
