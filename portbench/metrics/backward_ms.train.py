"""Device milliseconds of the train step's ``train.backward`` span per
traced step, between the span's CUDA events: the loss's gradient
through the head and every layer."""

from portbench import program


def read(r):
    return program.device_ms_per(r, "train.backward", "train.step")
