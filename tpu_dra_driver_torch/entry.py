"""Entry point of the port: the flagship model's loss with example
inputs, the counterpart of ``entry()`` in ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: ``fn(*example_args)`` is the
next-token loss of a tiny flagship transformer (vocab 512, d_model 256,
4 heads, 2 layers, d_ff 512, learned positions, bf16) on a [4, 128]
batch. Weights come from seed 0 and tokens from numpy seed 0, so they
are not the reference's weights; a caller that wants those converts the
reference's params with ``convert.params_from_jax`` and passes them to
``fn``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, init_params, loss_fn,
)

CONFIG = ModelConfig(vocab=512, d_model=256, n_heads=4, n_layers=2,
                     d_ff=512, max_seq=128)
BATCH, SEQ = 4, 128


def entry(device="cuda"):
    """(fn, example_args) for the tiny flagship config on ``device``."""
    dev = resolve_device(device)
    params = init_params(CONFIG, 0, device=dev)
    rng = np.random.RandomState(0)
    tokens, targets = (
        torch.from_numpy(rng.randint(0, CONFIG.vocab, (BATCH, SEQ))
                         .astype(np.int32)).to(dev)
        for _ in range(2))
    fn = functools.partial(loss_fn, cfg=CONFIG)
    return fn, (params, (tokens, targets))
