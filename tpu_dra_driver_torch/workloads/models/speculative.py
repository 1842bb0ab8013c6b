"""Speculative decoding: draft-and-verify over the KV-cache path.

Port of :mod:`tpu_dra_driver.workloads.models.speculative`. A draft
model proposes ``gamma`` tokens one decode step at a time (g = 1:
kernel B5 on the card); the target checks them in one wide forward
(``wide_step`` with g = gamma + 1, the masked read). Greedy acceptance
keeps a draft token while the target's own argmax equals it, so the
output is exactly the target's greedy decode for any draft;
:func:`speculative_sample` is the rejection-sampling variant
(Leviathan/Chen), whose output is distributed exactly as the target's
sampling. A batch advances by its smallest accepted count. Each round
begins with a catch-up draft step at ``pos - 1``, which writes the
draft's missing cache entry after a round that accepted everything and
rewrites an identical one otherwise.

The reference loops over rounds in a ``lax.while_loop``. Here one round
(the catch-up step, the gamma draft steps, the verify and the
acceptance) is a body replayed as a CUDA graph (:class:`StepGraph`):
the token buffer, the position, the last token and the counters
(generated, rounds, accepted) are device tensors it updates in place,
with device-side gathers and scatters at the position. The host reads
the counters once per round, to decide whether to run another: a call
makes as many host reads as rounds. The prefill runs eagerly.

``early_exit_real_data_tokens_per_sec`` first trains its byte-level
target on real text through the input pipeline (``data.py``), then
measures the early-exit draft on held-out prompts.

The reference compiles its loop once per configuration and shape and
reuses the program. Here the last call's loop (its caches, its state
and the captured round, :class:`_SpecLoop`) is kept, and a call with
the same configurations, shapes, rule and the very same weight tensors
replays it after a fresh prefill; any other call replaces it. The kept
loop holds those weights, and its caches, until then.
"""

from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.data import (
    byte_corpus, packed_lm_batches, prefetch_to_device,
)
from tpu_dra_driver_torch.workloads.models import transformer as _tf
from tpu_dra_driver_torch.workloads.models.generate import (
    block_prefill, categorical, decode_step, generate, init_kv_cache,
    truncate_top_k, wide_step,
)
from tpu_dra_driver_torch.workloads.models.quantize import (
    QTensor, _leaves, quantize_params,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    AdamW, ModelConfig, Params, init_params, make_train_step,
)
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph
from tpu_dra_driver_torch.workloads.utils.timing import time_fn


def speculative_generate(target_params: Params, target_cfg: ModelConfig,
                         draft_params: Params, draft_cfg: ModelConfig,
                         prompt: torch.Tensor, steps: int, gamma: int = 4,
                         return_stats: bool = False):
    """Greedy generation of ``steps`` tokens, draft-verified in rounds of
    ``gamma``: prompt [b, t0] → [b, t0 + steps], equal to ``generate(
    target_params, target_cfg, prompt, steps)`` for any draft (in bf16 up
    to near-ties, where the g-wide verify and the g = 1 step round
    differently). Prefix-LM models prefill their prompt bidirectionally,
    as ``generate()`` does. ``return_stats=True`` also returns
    ``{"rounds": n, "mean_accepted": k̄}`` (k̄ in [0, gamma])."""
    if steps <= 0:
        return (prompt, {"rounds": 0, "mean_accepted": 0.0}) \
            if return_stats else prompt
    _validate_spec(target_cfg, draft_cfg, gamma)
    out, rounds, acc = _spec_generate(
        target_params, draft_params, prompt, target_cfg, draft_cfg,
        steps, gamma)
    if return_stats:
        return out, {"rounds": rounds,
                     "mean_accepted": float(acc) / max(rounds, 1)}
    return out


def self_speculative_generate(params: Params, cfg: ModelConfig,
                              prompt: torch.Tensor, steps: int,
                              gamma: int = 4, return_stats: bool = False,
                              quantized_params: Optional[Params] = None):
    """Self-speculation with the int8 quantization of the target as the
    draft; the output is the fp target's greedy decode. Pass
    ``quantized_params`` (``quantize_params(params)``, made once) when
    generating repeatedly."""
    draft = (quantized_params if quantized_params is not None
             else quantize_params(params))
    return speculative_generate(params, cfg, draft, cfg, prompt, steps,
                                gamma, return_stats=return_stats)


def early_exit_draft(params: Params, cfg: ModelConfig, n_layers: int,
                     quantized: bool = True):
    """The layer-skipping self-draft: the target's first ``n_layers``
    blocks with its own final norm and tied head, int8 when
    ``quantized``. Returns (draft_params, draft_cfg)."""
    if not (1 <= n_layers <= cfg.n_layers):
        raise ValueError(f"n_layers {n_layers} outside [1, {cfg.n_layers}]")
    if cfg.scan_layers:
        raise ValueError("early_exit_draft needs per-layer params "
                         "(scan_layers=False)")
    draft = dict(params)
    draft["layers"] = list(params["layers"][:n_layers])
    dcfg = replace(cfg, n_layers=n_layers)
    if quantized:
        draft = quantize_params(draft)
    return draft, dcfg


def _validate_spec(target_cfg, draft_cfg, gamma):
    """Checks shared by the greedy and the sampling variants."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if target_cfg.window > 0 or draft_cfg.window > 0:
        raise ValueError("speculative decoding needs full-length caches "
                         "(window == 0) — the wide verify is positional")
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"target/draft vocab mismatch: {target_cfg.vocab} vs "
            f"{draft_cfg.vocab}")


def _spec_setup(target_params, draft_params, prompt, target_cfg,
                draft_cfg, steps, gamma, caches=None):
    """The loop's preamble: capacity check, both caches (``caches``, the
    (target, draft) pair of an earlier call of this shape, zeroed and
    reused; else new ones), both prefills (a prefix-LM prompt
    bidirectional in each model). Returns (last_logits, tcache, dcache,
    pos, max_t)."""
    b, t0 = prompt.shape
    # capacity: prompt + generated + one round's overshoot
    max_t = t0 + steps + gamma + 2
    for cfg in (target_cfg, draft_cfg):
        if not cfg.use_rope and max_t > cfg.max_seq:
            raise ValueError(
                f"t0+steps+gamma+2 ({max_t}) exceeds max_seq {cfg.max_seq} "
                f"(learned pos_embed bounds the sequence)")
    dev = prompt.device
    if caches is None:
        tcache = init_kv_cache(target_cfg, b, max_t, device=dev)
        dcache = init_kv_cache(draft_cfg, b, max_t, device=dev)
    else:
        tcache, dcache = caches
        for cache in caches:
            for leaves in cache.values():
                for a in leaves:
                    a.zero_()
    # block_prefill writes the caches in place
    last_logits, _, pos = block_prefill(
        target_params, target_cfg, tcache, prompt,
        prefix_lm=target_cfg.prefix > 0)
    block_prefill(draft_params, draft_cfg, dcache, prompt,
                  prefix_lm=draft_cfg.prefix > 0)
    return last_logits, tcache, dcache, pos, max_t


def _tensors(params: Params):
    """Every tensor a round reads from ``params`` (int8 weights: their
    codes and scales)."""
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            yield leaf.q
            yield leaf.s
        elif isinstance(leaf, torch.Tensor):
            yield leaf


class _SpecLoop:
    """The device state of a speculative loop, its round and the round's
    :class:`StepGraph`, made for one call's arguments and reused by later
    calls with the same ones. The state: the caches, the token buffer
    ``buf`` [b, max_t] (prompt, then the generated tokens), ``pos`` (0-d
    int32: cache entries are valid below it), ``t_last`` [b] (the token
    at ``pos``, in neither cache yet) and ``counts`` (int32 [3]: tokens
    generated, rounds, draft tokens accepted).

    ``propose(logits [b, V]) -> (token [b], extra)`` picks each draft
    token; ``accept(logits [b, g+1, V], drafts [b, gamma], extras) -> (k
    0-d, out [b, gamma + 1])`` gives the round's accepted count and its
    tokens (the first k drafts, then the target's token at k; slots past
    k are overwritten by the next round)."""

    def __init__(self, key, target_params, target_cfg, draft_params,
                 draft_cfg, tcache: Dict, dcache: Dict, prompt, max_t: int,
                 gamma: int, propose, accept, generator=None):
        b = prompt.shape[0]
        dev = prompt.device
        self.key, self.generator = key, generator
        self.tensors = (tuple(_tensors(target_params))
                        + tuple(_tensors(draft_params)))
        self.tcache, self.dcache = tcache, dcache
        self.buf = torch.zeros((b, max_t), dtype=prompt.dtype, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.t_last = torch.zeros((b,), dtype=prompt.dtype, device=dev)
        self.counts = torch.zeros((3,), dtype=torch.int32, device=dev)
        self.graph = StepGraph(
            self._round(target_params, target_cfg, draft_params, draft_cfg,
                        gamma, propose, accept),
            dev, generator=generator)

    def fits(self, key, target_params, draft_params, generator) -> bool:
        """True when a call with these arguments may replay this loop's
        round: the same configurations, shapes and rule, and the very
        tensors (and generator) the round was made with."""
        if self.key != key or self.generator is not generator:
            return False
        now = tuple(_tensors(target_params)) + tuple(_tensors(draft_params))
        return len(now) == len(self.tensors) and all(
            a is b for a, b in zip(now, self.tensors))

    def _round(self, target_params, target_cfg, draft_params, draft_cfg,
               gamma: int, propose, accept):
        """One round as a function of no arguments, for the graph."""
        buf, pos, t_last = self.buf, self.pos, self.t_last
        tcache, dcache = self.tcache, self.dcache
        cols = torch.arange(gamma + 1, device=buf.device)

        def round_():
            # draft catch-up at pos - 1 (an identical rewrite unless the
            # last round accepted everything)
            prev = buf.index_select(1, (pos - 1).long().view(1))[:, 0]
            decode_step(draft_params, draft_cfg, dcache, pos - 1, prev)
            tok, drafts, extras = t_last, [], []
            for j in range(gamma):
                logits, _ = decode_step(draft_params, draft_cfg, dcache,
                                        pos + j, tok)
                tok, extra = propose(logits)
                tok = tok.to(buf.dtype)
                drafts.append(tok)
                extras.append(extra)
            drafts = torch.stack(drafts, dim=1)                # [b, gamma]
            block = torch.cat([t_last[:, None], drafts], dim=1)
            logits, _ = wide_step(target_params, target_cfg, tcache, pos,
                                  block)
            k, outk = accept(logits, drafts, extras)
            buf.index_copy_(1, (pos + 1).long() + cols, outk.to(buf.dtype))
            t_last.copy_(outk.gather(1, k.view(1, 1).expand(len(outk), 1))
                         [:, 0])
            self.counts.add_(torch.stack([k + 1, torch.ones_like(k), k])
                             .to(torch.int32))
            pos.add_((k + 1).to(torch.int32))

        return round_

    def run(self, prompt: torch.Tensor, first: torch.Tensor, steps: int):
        """Starts the loop after the prefill (``first``: the token after
        the prompt) and replays rounds until ``steps`` tokens are made,
        reading the counters on the host after each. Returns (tokens [b,
        t0 + steps], rounds, accepted)."""
        t0 = prompt.shape[1]
        self.buf.zero_()
        self.buf[:, :t0] = prompt
        self.buf[:, t0] = first
        self.pos.fill_(t0)
        self.t_last.copy_(first)
        self.counts.zero_()
        self.counts[0] = 1
        n, rounds, acc = 1, 0, 0
        while n < steps:
            self.graph()
            n, rounds, acc = self.counts.tolist()
        return self.buf[:, :t0 + steps].clone(), rounds, acc


# the last call's loop, which the next call replays when it fits
_last_loop: Optional[_SpecLoop] = None


@torch.no_grad()
def _run_spec(target_params, draft_params, prompt, target_cfg, draft_cfg,
              steps, gamma, first, rule, make_rule, generator=None):
    """The loop both variants share: the prefill, ``first(last_logits)``
    for the token after the prompt, then the rounds. ``rule`` names the
    acceptance rule and its settings; ``make_rule()`` gives its
    (propose, accept), which draw from ``generator`` if they sample.
    The last call's :class:`_SpecLoop` is kept: a call that fits it
    reuses its caches and replays its captured round, as the
    reference's jit reuses one compiled program; any other call replaces
    it. Returns (tokens, rounds, accepted)."""
    global _last_loop
    key = (target_cfg, draft_cfg, tuple(prompt.shape), prompt.dtype,
           prompt.device, steps, gamma, rule)
    loop = _last_loop
    if loop is not None and not loop.fits(key, target_params, draft_params,
                                          generator):
        loop = _last_loop = None
    last_logits, tcache, dcache, _, max_t = _spec_setup(
        target_params, draft_params, prompt, target_cfg, draft_cfg, steps,
        gamma, caches=None if loop is None else (loop.tcache, loop.dcache))
    if loop is None:
        propose, accept = make_rule()
        loop = _last_loop = _SpecLoop(
            key, target_params, target_cfg, draft_params, draft_cfg, tcache,
            dcache, prompt, max_t, gamma, propose, accept, generator)
    return loop.run(prompt, first(last_logits).to(prompt.dtype), steps)


def _greedy_propose(logits):
    return torch.argmax(logits, dim=-1), None


def _greedy_accept(logits, drafts, _extras):
    """Accept while the target's argmax equals the draft token; the
    token at k is the target's argmax there."""
    greedy = torch.argmax(logits, dim=-1).to(drafts.dtype)      # [b, g+1]
    match = (greedy[:, :-1] == drafts).to(torch.int32)
    k = torch.cumprod(match, dim=1).sum(dim=1).min()
    bonus = greedy.gather(1, k.view(1, 1).expand(greedy.shape[0], 1))
    cols = torch.arange(greedy.shape[1], device=drafts.device)
    return k, torch.where(cols[None, :] < k, F.pad(drafts, (0, 1)), bonus)


def _spec_generate(target_params, draft_params, prompt, target_cfg,
                   draft_cfg, steps, gamma):
    return _run_spec(target_params, draft_params, prompt, target_cfg,
                     draft_cfg, steps, gamma,
                     lambda logits: torch.argmax(logits, dim=-1),
                     ("greedy",), lambda: (_greedy_propose, _greedy_accept))


def speculative_decode_tokens_per_sec(
        b: int = 8, prompt_len: int = 128, gen: int = 256, gamma: int = 4,
        iters: int = 3, cfg: Optional[ModelConfig] = None,
        device="cuda") -> dict:
    """Throughput of int8 self-speculation against plain greedy decode on
    the same model: the best wall time of ``iters`` calls for ``gen``
    tokens each. Reports both rates, the speedup, the mean accepted
    length and the draft economics: the int8 model's decode time over
    the bf16 model's (``draft_cost_ratio`` r) and the speedup perfect
    acceptance would give, (gamma + 1) / (gamma r + 1). Weights and the
    prompt come from fixed seeds."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=8192, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_layers=8, d_ff=8192,
                             max_seq=prompt_len + gen + gamma + 2,
                             use_rope=True)
    params = init_params(cfg, 0, device=dev)
    qdraft = quantize_params(params)
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(dev)

    _, stats = speculative_generate(params, cfg, qdraft, cfg, prompt,
                                    steps=gen, gamma=gamma,
                                    return_stats=True)
    t_spec = time_fn(lambda: speculative_generate(
        params, cfg, qdraft, cfg, prompt, steps=gen, gamma=gamma),
        warmup=1, iters=iters).best_s
    t_plain = time_fn(lambda: generate(params, cfg, prompt, steps=gen),
                      warmup=1, iters=iters).best_s
    t_int8 = time_fn(lambda: generate(qdraft, cfg, prompt, steps=gen),
                     warmup=1, iters=iters).best_s
    r = t_int8 / t_plain
    return {
        "spec_tokens_per_sec": b * gen / t_spec,
        "plain_tokens_per_sec": b * gen / t_plain,
        "speedup": t_plain / t_spec,
        "mean_accepted": stats["mean_accepted"],
        "gamma": gamma,
        "draft_cost_ratio": r,
        "perfect_acceptance_bound": (gamma + 1) / (gamma * r + 1.0),
        "shape": f"b{b} L{cfg.n_layers} d{cfg.d_model} gen{gen}",
    }


def _bigram_chains(perm: torch.Tensor, n: int, t: int,
                   generator: torch.Generator) -> torch.Tensor:
    """[n, t] int32 token chains on the CPU: from a uniform start token,
    each token is ``perm[previous]`` with probability 0.9 and a uniform
    token otherwise (the start itself is not in the chain)."""
    vocab = perm.numel()
    tok = torch.randint(0, vocab, (n,), generator=generator)
    noisy = torch.rand((n, t), generator=generator) < 0.1
    rand = torch.randint(0, vocab, (n, t), generator=generator)
    out = torch.empty((n, t), dtype=torch.int64)
    for i in range(t):
        tok = torch.where(noisy[:, i], rand[:, i], perm[tok])
        out[:, i] = tok
    return out.to(torch.int32)


def early_exit_decode_tokens_per_sec(
        b: int = 1, prompt_len: int = 64, gen: int = 256, gamma: int = 8,
        draft_layers: int = 2, train_steps: int = 150,
        iters: int = 3, cfg: Optional[ModelConfig] = None,
        device="cuda") -> dict:
    """Early-exit speculative decode at b = 1 on a quickly trained model.
    The target first takes ``train_steps`` (rounded up to a multiple of
    10) steps of ``AdamW(3e-4)`` on a peaked synthetic bigram chain
    (each token's successor fixed with probability 0.9, uniform
    otherwise; batches of 8 × 512), which gives every depth the same
    argmax structure to learn; then :func:`_measure_early_exit` runs the
    int8 ``draft_layers``-block draft against it. Chains, weights and
    prompt come from fixed seeds."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=8192, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_layers=8, d_ff=8192,
                             max_seq=prompt_len + gen + gamma + 2,
                             use_rope=True)
    params = init_params(cfg, 0, device=dev)
    perm = torch.randperm(cfg.vocab,
                          generator=torch.Generator().manual_seed(42))
    t_train, nb = 512, 8
    n_chunks = max(1, -(-train_steps // 10))   # ceil; never zero steps
    train_steps = n_chunks * 10                # the count actually run
    chains = _bigram_chains(perm, train_steps * nb, t_train,
                            torch.Generator().manual_seed(100)).to(dev)

    train_step, opt_init = make_train_step(cfg, optimizer=AdamW(3e-4))
    opt_state = opt_init(params)
    loss = None
    for i in range(train_steps):
        toks = chains[i * nb:(i + 1) * nb]
        params, opt_state, loss = train_step(
            params, opt_state, (toks[:, :-1], toks[:, 1:]))
    for leaf in opt_state.leaves:
        leaf.requires_grad_(False)
    del opt_state, chains
    final_loss = float(loss)

    prompt = _bigram_chains(perm, b, prompt_len,
                            torch.Generator().manual_seed(7)).to(dev)
    out = _measure_early_exit(params, cfg, prompt, draft_layers=draft_layers,
                              gen=gen, gamma=gamma, iters=iters)
    out.update(train_steps=train_steps, final_train_loss=final_loss)
    return out


def _measure_early_exit(params: Params, cfg: ModelConfig, prompt,
                        draft_layers: int, gen: int, gamma: int,
                        iters: int) -> dict:
    """Builds the int8 shallow-trunk draft, checks the speculative output
    against the target's greedy decode, then times speculative, plain
    and draft-only decoding and reports the speedup and the draft
    economics.

    A row whose output parts from the plain greedy decode passes only
    if, at its first differing position, the plain path's top-2 logit
    gap (of a fresh ``forward`` over the plain prefix) is at most ``0.1 +
    0.01 |top1|`` (a bf16 near-tie between the g-wide verify and the
    g = 1 step) and both paths' tokens are those top 2; every row is
    checked on its own, anything else raises. Divergences are reported
    (``exact_greedy``, ``divergence``)."""
    b = int(prompt.shape[0])
    draft, dcfg = early_exit_draft(params, cfg, draft_layers,
                                   quantized=True)
    out_spec, stats = speculative_generate(
        params, cfg, draft, dcfg, prompt, steps=gen, gamma=gamma,
        return_stats=True)
    out_plain = generate(params, cfg, prompt, steps=gen)
    spec_np = out_spec[:, :out_plain.shape[1]].cpu().numpy()
    plain_np = out_plain.cpu().numpy()
    exact = bool((spec_np == plain_np).all())
    divergence = None
    if not exact:
        divergence = []
        for bi in range(spec_np.shape[0]):
            mism = np.nonzero(spec_np[bi] != plain_np[bi])[0]
            if not len(mism):
                continue
            pos = int(mism[0])
            with torch.no_grad():
                logits = _tf.forward(params, out_plain[bi:bi + 1, :pos],
                                     cfg)[0, -1].float().cpu().numpy()
            top2 = np.argsort(logits)[-2:][::-1]
            gap = float(logits[top2[0]] - logits[top2[1]])
            tol = 0.1 + 0.01 * abs(float(logits[top2[0]]))
            tokens_ok = {int(spec_np[bi, pos]), int(plain_np[bi, pos])} \
                <= set(map(int, top2))
            if gap > tol or not tokens_ok:
                raise RuntimeError(
                    f"speculative output diverged from the target's "
                    f"greedy decode at row {bi} pos {pos} and it is NOT "
                    f"a bf16 near-tie (top-2 gap {gap:.4f} > tol "
                    f"{tol:.4f}, top-2 {top2}, spec {spec_np[bi, pos]} "
                    f"vs plain {plain_np[bi, pos]}) — the exactness "
                    f"machinery is broken")
            divergence.append({"row": bi, "pos": pos, "top2_gap": gap})

    t_spec = time_fn(lambda: speculative_generate(
        params, cfg, draft, dcfg, prompt, steps=gen, gamma=gamma),
        warmup=1, iters=iters).best_s
    t_plain = time_fn(lambda: generate(params, cfg, prompt, steps=gen),
                      warmup=1, iters=iters).best_s
    t_draft = time_fn(lambda: generate(draft, dcfg, prompt, steps=gen),
                      warmup=1, iters=iters).best_s
    r = t_draft / t_plain
    return {
        "spec_tokens_per_sec": b * gen / t_spec,
        "plain_tokens_per_sec": b * gen / t_plain,
        "speedup": t_plain / t_spec,
        "mean_accepted": stats["mean_accepted"],
        "gamma": gamma,
        "draft_cost_ratio": r,
        "perfect_acceptance_bound": (gamma + 1) / (gamma * r + 1.0),
        "exact_greedy": exact,
        "divergence": divergence,
        "shape": (f"b{b} L{cfg.n_layers} d{cfg.d_model} "
                  f"draft{draft_layers}L-int8 gen{gen}"),
    }


def early_exit_real_data_tokens_per_sec(
        b: int = 1, prompt_len: int = 128, gen: int = 256, gamma: int = 8,
        draft_layers: int = 2, train_steps: int = 600, train_batch: int = 16,
        train_seq: int = 512, iters: int = 3,
        cfg: Optional[ModelConfig] = None,
        corpus_roots=None, exit_aux: bool = True,
        n_prompts: int = 5, device="cuda") -> dict:
    """Early-exit speculative decode on a model trained on real text.

    The byte-level target (vocab 256, seed 0) first trains on
    ``data.byte_corpus(roots=corpus_roots)`` (by default the running
    interpreter's stdlib), streamed through ``packed_lm_batches`` (batches
    of ``train_batch`` x ``train_seq``) and ``prefetch_to_device``, with
    ``AdamW(3e-4)`` and, with ``exit_aux``, the early-exit auxiliary loss
    at ``draft_layers`` (the recipe that keeps the shallow trunk a useful
    draft). Batches are taken in chunks of 10 and a chunk's steps run
    once it is complete, as the reference's scanned chunk, so
    ``train_steps`` reports the count actually run (a multiple of 10);
    the producer is closed before anything is timed.

    Then :func:`_measure_early_exit` runs on ``n_prompts`` prompts from
    the held-out split (never trained on), picked with a stride over its
    documents of at least ``prompt_len`` bytes (shorter documents
    tiled). The headline is the run of median speedup, taken wholesale;
    ``per_prompt`` and ``divergence`` (with each prompt's index) report
    every run."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=256, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_layers=8, d_ff=8192,
                             max_seq=prompt_len + gen + gamma + 2,
                             use_rope=True)
    if cfg.vocab < 256:
        raise ValueError(f"byte-level corpus needs vocab >= 256, "
                         f"got {cfg.vocab}")
    params = init_params(cfg, 0, device=dev)

    train_docs, holdout_docs = byte_corpus(roots=corpus_roots)
    corpus_bytes = int(sum(len(d) for d in train_docs))

    train_step, opt_init = make_train_step(
        cfg, optimizer=AdamW(3e-4),
        exit_layer=draft_layers if exit_aux else None)
    opt_state = opt_init(params)

    chunk = 10
    batches = prefetch_to_device(
        packed_lm_batches(itertools.cycle(train_docs),
                          train_batch, train_seq),
        size=2, device=dev)
    steps_run, loss, pending = 0, None, []
    try:
        for batch in batches:
            pending.append(batch)
            if len(pending) < chunk:
                continue
            for bt in pending:
                params, opt_state, loss = train_step(params, opt_state, bt)
            pending = []
            steps_run += chunk
            if steps_run >= train_steps:
                break
    finally:
        # stop the producer (even after a failed step) before the timed
        # section: nothing else may run during timing
        batches.close()
    final_loss = float(loss)
    for leaf in opt_state.leaves:
        leaf.requires_grad_(False)
    del opt_state, pending

    pools = [d for d in holdout_docs if len(d) >= prompt_len] or holdout_docs
    runs = []
    # picks spread over the whole held-out pool: adjacent files of a
    # sorted walk are correlated (same directory, same style)
    stride = max(1, len(pools) // max(n_prompts * b, 1))
    for pi in range(n_prompts):
        rows = []
        for i in range(b):
            d = pools[((pi * b + i) * stride) % len(pools)]
            row = d[:prompt_len]
            if len(row) < prompt_len:
                row = np.tile(d, -(-prompt_len // len(d)))[:prompt_len]
            rows.append(row)
        prompt = torch.as_tensor(np.stack(rows), dtype=torch.int32,
                                 device=dev)
        runs.append(_measure_early_exit(
            params, cfg, prompt, draft_layers=draft_layers,
            gen=gen, gamma=gamma, iters=iters))

    # the headline is the median-speedup run, wholesale, so its numbers
    # stay consistent with each other (speedup = plain / spec tokens/s)
    mid = sorted(range(len(runs)),
                 key=lambda i: runs[i]["speedup"])[len(runs) // 2]
    out = dict(runs[mid])
    divergence = [dict(d, prompt=i)
                  for i, r in enumerate(runs)
                  for d in (r["divergence"] or [])]
    out.update(
        per_prompt=[{"speedup": round(r["speedup"], 3),
                     "mean_accepted": round(r["mean_accepted"], 2),
                     "exact_greedy": r["exact_greedy"]} for r in runs],
        exact_greedy=all(r["exact_greedy"] for r in runs),
        divergence=divergence or None,
        train_steps=steps_run,
        final_train_loss=final_loss,
        corpus_bytes=corpus_bytes,
        holdout_docs=len(holdout_docs),
        exit_aux=exit_aux,
        shape=runs[mid]["shape"] + " byte-LM",
    )
    return out


def speculative_sample(target_params: Params, target_cfg: ModelConfig,
                       draft_params: Params, draft_cfg: ModelConfig,
                       prompt: torch.Tensor, steps: int,
                       generator: torch.Generator, gamma: int = 4,
                       temperature: float = 1.0, top_k: int = 0,
                       return_stats: bool = False):
    """Sampling speculative decoding (the Leviathan/Chen rejection rule):
    the draft samples gamma tokens from its softmax(logits / T); the
    target verifies them in one wide forward and accepts token x with
    probability min(1, p_t(x) / p_d(x)); the first rejected position
    resamples from normalize(max(p_t - p_d, 0)); a round that accepted
    everything samples its bonus token from the target. The output is
    distributed exactly as the target's sampling at this temperature,
    for any draft. ``top_k > 0`` truncates both models' tempered
    distributions to their own k largest first (the law of
    ``generate(top_k=k)``). ``generator`` is a :class:`torch.Generator`
    on the prompt's device (the counterpart of the reference's ``key``),
    registered with the round's CUDA graph. ``temperature`` must be > 0:
    greedy is :func:`speculative_generate`."""
    if steps <= 0:
        return (prompt, {"rounds": 0, "mean_accepted": 0.0}) \
            if return_stats else prompt
    if temperature <= 0:
        raise ValueError("speculative_sample needs temperature > 0; "
                         "greedy is speculative_generate")
    if top_k < 0 or top_k > target_cfg.vocab:
        raise ValueError(
            f"top_k {top_k} outside [0, vocab={target_cfg.vocab}]")
    if generator is None:
        raise ValueError("speculative_sample needs a torch.Generator on "
                         "the prompt's device")
    _validate_spec(target_cfg, draft_cfg, gamma)
    out, rounds, acc = _spec_sample_generate(
        target_params, draft_params, prompt, generator, target_cfg,
        draft_cfg, steps, gamma, float(temperature), top_k)
    if return_stats:
        return out, {"rounds": rounds,
                     "mean_accepted": float(acc) / max(rounds, 1)}
    return out


def _sample_rule(gamma: int, inv_t: float, top_k: int,
                 generator: torch.Generator):
    """(propose, accept) of the rejection rule for :class:`_SpecLoop`."""

    def tempered(logits):
        return torch.softmax(truncate_top_k(logits.float(), top_k) * inv_t,
                             dim=-1)

    def propose(logits):
        dist = tempered(logits)                                # [b, V]
        return categorical(dist, generator), dist

    def accept(logits, drafts, ddists):
        b, vocab = drafts.shape[0], logits.shape[-1]
        ddists = torch.stack(ddists, dim=1)                    # [b, g, V]
        tdists = tempered(logits)                              # [b, g+1, V]
        d_idx = drafts.long()[..., None]
        pt_d = tdists[:, :-1].gather(2, d_idx)[..., 0]
        pd_d = ddists.gather(2, d_idx)[..., 0]
        u = torch.rand((b, gamma), generator=generator,
                       device=drafts.device)
        accepted = (u * pd_d < pt_d).to(torch.int32)           # [b, g]
        acc_count = torch.cumprod(accepted, dim=1).sum(dim=1)  # [b]
        k = acc_count.min()
        # the token at column k, per row: the residual sample where the
        # row rejected at k, its draft where it accepted past k, a draw
        # from the target's last column where every row accepted all
        kk = k.clamp(max=gamma - 1)
        at_k = kk.view(1, 1, 1).expand(b, 1, vocab)
        pt_k = tdists.gather(1, at_k)[:, 0]                    # [b, V]
        pd_k = ddists.gather(1, at_k)[:, 0]
        resid = (pt_k - pd_k).clamp_min(0.0)
        resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-30)
        use_bonus = k == gamma
        # an all-zero residual (f32 rounding) falls back to the rejected
        # position's target distribution
        fix_dist = torch.where(
            use_bonus, tdists[:, -1],
            torch.where(resid.sum(-1, keepdim=True) > 0, resid, pt_k))
        fixed = categorical(fix_dist, generator).to(drafts.dtype)
        d_at_k = drafts.gather(1, kk.view(1, 1).expand(b, 1))[:, 0]
        tok_k = torch.where(use_bonus | (acc_count == k), fixed, d_at_k)
        cols = torch.arange(gamma + 1, device=drafts.device)
        return k, torch.where(cols[None, :] < k, F.pad(drafts, (0, 1)),
                              tok_k[:, None])

    return propose, accept


def _spec_sample_generate(target_params, draft_params, prompt, generator,
                          target_cfg, draft_cfg, steps, gamma, temperature,
                          top_k=0):
    inv_t = 1.0 / temperature

    def first(logits):
        return categorical(torch.softmax(
            truncate_top_k(logits.float(), top_k) * inv_t, dim=-1),
            generator)

    return _run_spec(target_params, draft_params, prompt, target_cfg,
                     draft_cfg, steps, gamma, first,
                     ("sample", inv_t, top_k),
                     lambda: _sample_rule(gamma, inv_t, top_k, generator),
                     generator)
