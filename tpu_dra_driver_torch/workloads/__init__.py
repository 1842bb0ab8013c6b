"""Validation workloads on PyTorch: the serving and training paths of
:mod:`tpu_dra_driver.workloads`, with their attention kernels (paged
decode, flash forward and backward) written in CUDA C++ for Hopper
(``csrc/``)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no CUDA device is present. Nothing falls back to the CPU: a
    caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev
