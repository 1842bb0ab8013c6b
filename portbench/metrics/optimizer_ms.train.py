"""Device milliseconds of the train step's ``train.optimizer`` span per
traced step, between the span's CUDA events: ``OptState.apply``, the
global-norm clip and AdamW."""

from portbench import program


def read(r):
    return program.device_ms_per(r, "train.optimizer", "train.step")
