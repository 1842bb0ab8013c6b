"""Device milliseconds of the train step's ``train.forward`` span per
traced step, between the span's CUDA events: the loss, forward through
every layer and the head."""

from portbench import program


def read(r):
    return program.device_ms_per(r, "train.forward", "train.step")
