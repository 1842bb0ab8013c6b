"""Percent of the engine's admissions that a captured CUDA graph's
replay served: ``ServingEngine.admit_replays`` over
``ServingEngine.admits``. Process totals: the window's admissions with
set-up's (the one-row warm engine's, and the first wave's, where each
bucket's first admission warms its graph up and its second captures
it) and the traced stretch's. A port without the counters reads None;
on the CPU no graph is captured, so it reads 0."""

from portbench import program


def read(r):
    admits = program.engine_counter("admits")
    replays = program.engine_counter("admit_replays")
    if not admits or replays is None:
        return None
    return 100.0 * replays / admits
