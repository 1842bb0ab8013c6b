"""Encoder model family: bidirectional masked-LM (BERT recipe) training.

Port of :mod:`tpu_dra_driver.workloads.models.encoder`. An encoder is
the decoder stack's ``forward`` under a config whose bidirectional
prefix covers the whole sequence (``prefix = max_seq``: the flash
kernels see every pair), trained to reconstruct the original tokens at
a random subset of corrupted positions (80% [MASK], 10% a random token,
10% kept). The [MASK] id is ``vocab - 1``. Corruption is drawn on the
tokens' device from the caller's :class:`torch.Generator`, so a
training step makes a fresh corruption without a host wait.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import torch

from tpu_dra_driver_torch.workloads.models.transformer import (
    AdamW,
    ModelConfig,
    Params,
    forward,
    nll_from_logits,
)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """An encoder is the decoder stack with the whole sequence in the
    bidirectional prefix region. window (causal-only) must be off."""
    if cfg.window:
        raise ValueError("encoder attention is bidirectional; "
                         "cfg.window (causal sliding window) conflicts")
    return replace(cfg, prefix=cfg.max_seq)


def mlm_corrupt(tokens: torch.Tensor, generator: torch.Generator,
                vocab: int, mask_rate: float = 0.15,
                keep_rate: float = 0.1, random_rate: float = 0.1,
                pad_id: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT corruption: select each position with probability
    ``mask_rate``; of those, a share ``1 - keep_rate - random_rate``
    becomes the [MASK] id (vocab-1), ``random_rate`` a random token
    (never [MASK], never ``pad_id``) and ``keep_rate`` stays unchanged
    (but still counts in the loss). ``pad_id`` positions are never
    selected. ``generator`` lives on the tokens' device. Returns
    (corrupted tokens, selected mask)."""
    if not 0.0 < mask_rate < 1.0:
        raise ValueError(f"mask_rate must be in (0, 1), got {mask_rate}")
    if keep_rate < 0 or random_rate < 0 or keep_rate + random_rate > 1:
        raise ValueError(
            f"keep_rate ({keep_rate}) and random_rate ({random_rate}) must "
            f"be >= 0 and sum to <= 1 — the remainder is the [MASK] share")
    shape, dev = tokens.shape, tokens.device
    selected = torch.rand(shape, generator=generator, device=dev) < mask_rate
    if pad_id is not None:
        selected &= tokens != pad_id
    mode = torch.rand(shape, generator=generator, device=dev)
    # the random branch draws real vocabulary tokens only: never the
    # [MASK] id, and never the pad/separator id
    if pad_id is not None and 0 <= pad_id < vocab - 1:
        rand_tok = torch.randint(0, vocab - 2, shape, generator=generator,
                                 device=dev, dtype=tokens.dtype)
        rand_tok += (rand_tok >= pad_id).to(rand_tok.dtype)
    else:
        rand_tok = torch.randint(0, vocab - 1, shape, generator=generator,
                                 device=dev, dtype=tokens.dtype)
    mask_tok = torch.full_like(tokens, vocab - 1)
    corrupted = torch.where(mode < 1.0 - keep_rate - random_rate, mask_tok,
                            torch.where(mode < 1.0 - keep_rate, rand_tok,
                                        tokens))
    return torch.where(selected, corrupted, tokens), selected


def _mlm_loss(params: Params, tokens: torch.Tensor,
              corrupted: torch.Tensor, selected: torch.Tensor,
              cfg: ModelConfig, attn_fn=None) -> torch.Tensor:
    """The NLL of the original ``tokens`` at the ``selected`` positions
    of the logits over ``corrupted``; ``cfg`` is an encoder config."""
    logits = forward(params, corrupted, cfg, attn_fn)
    return nll_from_logits(logits, tokens, selected)


def mlm_loss_fn(params: Params, tokens: torch.Tensor,
                generator: torch.Generator, cfg: ModelConfig, attn_fn=None,
                mask_rate: float = 0.15,
                pad_id: Optional[int] = None) -> torch.Tensor:
    """Masked-LM objective: corrupt on the device, reconstruct the
    originals at the corrupted positions. ``cfg`` is made an encoder
    config (bidirectional over the whole sequence), so a causal config
    cannot train a degraded encoder."""
    cfg = encoder_config(cfg)
    corrupted, selected = mlm_corrupt(tokens, generator, cfg.vocab,
                                      mask_rate, pad_id=pad_id)
    return _mlm_loss(params, tokens, corrupted, selected, cfg, attn_fn)


def make_mlm_train_step(cfg: ModelConfig, optimizer=None, attn_fn=None,
                        mask_rate: float = 0.15,
                        pad_id: Optional[int] = None):
    """Returns (train_step, init_opt_state). ``train_step(params,
    opt_state, tokens, generator) -> (params, opt_state, loss)`` draws a
    fresh corruption from ``generator`` (which advances), updates the
    params IN PLACE and returns the loss detached. The default
    optimizer is ``optax.adamw(1e-3)``: :class:`AdamW`."""
    cfg = encoder_config(cfg)
    opt = optimizer or AdamW(1e-3)

    def train_step(params, opt_state, tokens, generator):
        loss = mlm_loss_fn(params, tokens, generator, cfg, attn_fn,
                           mask_rate, pad_id)
        grads = torch.autograd.grad(loss, opt_state.leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
        opt_state.apply(grads)
        return params, opt_state, loss.detach()

    return train_step, opt.init


@torch.no_grad()
def mlm_accuracy(params: Params, tokens: torch.Tensor,
                 generator: torch.Generator, cfg: ModelConfig,
                 mask_rate: float = 0.15, attn_fn=None,
                 pad_id: Optional[int] = None) -> float:
    """Reconstruction accuracy at the corrupted positions (the MLM eval
    metric)."""
    cfg = encoder_config(cfg)
    corrupted, selected = mlm_corrupt(tokens, generator, cfg.vocab,
                                      mask_rate, pad_id=pad_id)
    pred = forward(params, corrupted, cfg, attn_fn).argmax(-1)
    hits = (selected & (pred == tokens)).sum()
    return float(hits / selected.sum().clamp_min(1))
