"""Beam search over the KV-cache decode path.

Port of :mod:`tpu_dra_driver.workloads.models.beam`: fixed width, fixed
length (no EOS), sequences compared by the total log-probability of
their generated suffix. The prompt is prefilled once per batch row and
the cache tiled to ``b * beam`` rows; each step is one ``decode_step``
over those rows (kernel B5 on the card), a top-``beam`` over the
``beam * vocab`` continuations of each row, and a reorder of the cache
rows by parent.

Ties in the top-k take the lower flat index ``parent * vocab + token``,
as ``lax.top_k`` does (:func:`transformer._top_k`, a stable descending
sort).

The reference scans the steps inside one jit. Here one step is a body
replayed as a CUDA graph (:class:`StepGraph`), two of them in turn: the
cache lives in two buffers, and the step of one graph decodes from the
first and gathers the reordered rows into the second, the other graph
the reverse, so each step reads and writes the whole cache once (as the
reference's ``jnp.take`` does) and no tensor a graph captured changes
its address. The step's position and column, the last tokens, the
scores and the token buffer are device tensors the body updates in
place; nothing in it is read on the host. The prefill and the first
expansion run eagerly.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import torch

from tpu_dra_driver_torch.workloads.models.generate import (
    block_prefill, decode_step, init_kv_cache,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, Params, _top_k, forward,
)
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph


def beam_search(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                steps: int, beam: int = 4, return_all: bool = False):
    """prompt [b, t0] → the best continuation [b, t0 + steps], or with
    ``return_all`` (sequences [b, beam, t0 + steps], scores [b, beam] f32)
    best first. A score is the total log-probability of the generated
    suffix. Runs on the prompt's device (the params must be there)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if beam < 1:
        raise ValueError(f"beam must be >= 1, got {beam}")
    if cfg.window > 0:
        raise ValueError("beam_search requires a full-length cache "
                         "(window == 0)")
    if beam > cfg.vocab:
        raise ValueError(f"beam {beam} exceeds vocab {cfg.vocab}")
    if not cfg.use_rope and prompt.shape[1] + steps > cfg.max_seq:
        raise ValueError(f"t0+steps ({prompt.shape[1] + steps}) exceeds "
                         f"max_seq {cfg.max_seq}")
    seqs, scores = _beam_search(params, cfg, prompt, steps, beam)
    if return_all:
        return seqs, scores
    return seqs[:, 0]


@torch.no_grad()
def _beam_search(params, cfg, prompt, steps, beam):
    b, t0 = prompt.shape
    dev = prompt.device
    cache = init_kv_cache(cfg, b, t0 + steps, device=dev)
    last_logits, cache, _ = block_prefill(params, cfg, cache, prompt,
                                          prefix_lm=cfg.prefix > 0)

    # first expansion: the top-beam tokens of the prefill logits seed the
    # beams (distinct by construction)
    logp0 = torch.log_softmax(last_logits.float(), dim=-1)
    scores, first = _top_k(logp0, beam)                      # [b, beam]
    scores, first = scores.clone(), first.to(prompt.dtype)

    # the prefilled cache tiled to one row per beam (row r = batch *
    # beam + beam index), and the second buffer the steps gather into
    tiled = {k: [a.repeat_interleave(beam, dim=0) for a in v]
             for k, v in cache.items()}
    del cache
    other = {k: [torch.empty_like(a) for a in v] for k, v in tiled.items()}

    toks = torch.zeros((b, beam, steps), dtype=prompt.dtype, device=dev)
    toks[:, :, 0] = first
    last = first.reshape(b * beam).clone()
    pos = torch.full((), t0, dtype=torch.int32, device=dev)
    col = torch.ones((), dtype=torch.int64, device=dev)
    if steps > 1:
        graphs = [StepGraph(_step_body(params, cfg, src, dst, pos, col,
                                       last, scores, toks), dev)
                  for src, dst in ((tiled, other), (other, tiled))]
        for i in range(steps - 1):
            graphs[i % 2]()

    seqs = torch.cat([prompt[:, None].expand(b, beam, t0), toks], dim=2)
    return seqs, scores


def _step_body(params: Params, cfg: ModelConfig, src: Dict, dst: Dict,
               pos: torch.Tensor, col: torch.Tensor, last: torch.Tensor,
               scores: torch.Tensor, toks: torch.Tensor):
    """One beam step as a function of no arguments, for
    :class:`StepGraph`: decode ``last`` [b * beam] (the tokens at
    position ``pos``, 0-d int32) from the cache ``src``, expand each
    beam by every token, keep the top ``beam`` per batch row, gather the
    parents' cache rows from ``src`` into ``dst``, reorder ``toks``
    [b, beam, steps] by parent and write the new tokens at column
    ``col`` (0-d int64), and advance ``pos`` and ``col`` by one. Updates
    ``last``, ``scores`` and ``toks`` in place."""
    b, beam, _ = toks.shape
    V = cfg.vocab
    rows = torch.arange(b, device=toks.device)[:, None] * beam

    def body():
        logits, _ = decode_step(params, cfg, src, pos, last)
        logp = torch.log_softmax(logits.float(), dim=-1)
        total = scores[:, :, None] + logp.reshape(b, beam, V)
        new_scores, flat = _top_k(total.reshape(b, beam * V), beam)
        parent = flat // V                                    # [b, beam]
        tok = (flat % V).to(toks.dtype)
        gather = (rows + parent).reshape(-1)
        for key, leaves in src.items():
            for a, out in zip(leaves, dst[key]):
                torch.index_select(a, 0, gather, out=out)
        toks.copy_(toks.gather(1, parent[:, :, None].expand_as(toks)))
        toks.index_copy_(2, col.view(1), tok[:, :, None])
        scores.copy_(new_scores)
        last.copy_(tok.reshape(-1))
        pos.add_(1)
        col.add_(1)

    return body


@torch.no_grad()
def sequence_logprob(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                     full: torch.Tensor) -> torch.Tensor:
    """Total log-probability [b] f32 of the generated suffix
    ``full[:, t0:]`` with ``full[:, :-1]`` as teacher-forced input: the
    re-scoring oracle for :func:`beam_search`'s scores. A prefix-LM
    model is scored with the whole prompt bidirectional (prefix = t0),
    as the generation prefill attended."""
    t0 = prompt.shape[1]
    if cfg.prefix > 0:
        cfg = replace(cfg, prefix=t0)
    logits = forward(params, full[:, :-1], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(-1, full[:, 1:].long()[..., None])[..., 0]
    return tok_lp[:, t0 - 1:].sum(dim=-1)
