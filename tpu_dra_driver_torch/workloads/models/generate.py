"""Autoregressive decoding with a KV cache for the flagship transformer.

Port of :mod:`tpu_dra_driver.workloads.models.generate`: the per-layer
cache ``[b, h_kv, L, hd]`` (a ring of the window's length with
``cfg.window``; int8 codes with per-slot f32 scales with
``cfg.kv_int8``), whole-prompt, chunked and sequential prefill, the
decode step, greedy and sampled generation, the held-out NLL and the
decode-throughput benchmark.

Unlike the reference, cache writes update the cache tensors in place
(the returned cache holds the same tensors): no step copies a whole
cache. A position is a Python int or a 0-d int32 tensor; a tensor is
never read on the host, so a step at a device position can be captured
in a CUDA graph. :func:`generate` runs its decode loop (and the ring
prefill) as one such graph, replayed once per step (the reference jits
the whole loop): the position, the fed-back token and the output live
on the card, and the host never waits for it.

The g = 1 decode read goes through ``flash_decode_attention`` (kernel B5
on the card) where the cache length has a KV_BLOCK-multiple divisor;
the reference keeps it on the masked einsum, which reads the whole
cache where B5 reads only the written slots (see :func:`wide_step`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import (
    embed_lookup, lm_head, mm, param_bytes, quantize_params,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig,
    Params,
    _ffn,
    _rmsnorm,
    apply_rope,
    init_params,
    loss_fn,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.ops.attention import attention_reference
from tpu_dra_driver_torch.workloads.ops.decode_attention import (
    NEG_INF, decode_block_t, flash_decode_attention, round_up_kv,
)
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph
from tpu_dra_driver_torch.workloads.utils.timing import (
    chain_seconds_per_step,
)


def init_kv_cache(cfg: ModelConfig, batch: int, max_t: int,
                  device="cuda") -> Dict:
    """Zeroed per-layer KV cache [batch, h_kv, L, hd]. With cfg.window >
    0 the cache is a ring of length min(max_t, window); otherwise L is
    max_t rounded up to a KV_BLOCK multiple. With cfg.kv_int8 the K/V
    tensors hold int8 codes and the cache gains ``k_s``/``v_s`` fp32
    per-vector scales [batch, h_kv, L]."""
    dev = resolve_device(device)
    n_kv = cfg.n_kv_heads or cfg.n_heads
    hd = cfg.d_model // cfg.n_heads
    if cfg.window > 0:
        length = min(max_t, cfg.window)
    else:
        length = round_up_kv(max_t)
    shape = (batch, n_kv, length, hd)
    dtype = torch.int8 if cfg.kv_int8 else cfg.dtype

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=dev)
                for _ in range(cfg.n_layers)]

    cache = {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    if cfg.kv_int8:
        cache["k_s"] = zeros(shape[:3], torch.float32)
        cache["v_s"] = zeros(shape[:3], torch.float32)
    return cache


def _kv_quantize(vals: torch.Tensor):
    """[..., hd] fp vectors → (int8 codes, fp32 absmax/127 scales [...])."""
    v32 = vals.float()
    s = v32.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    codes = torch.round(v32 / s[..., None]).to(torch.int8)
    return codes, s


def _cache_write(cache: Dict, which: str, li: int, vals: torch.Tensor,
                 slot) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Write [b, h_kv, g, hd] vectors in place at slots ``slot`` to
    ``slot + g`` (an int), or at the g slots of an int64 tensor on the
    cache's device (a device position, the reference's traced
    ``dynamic_update_slice``); returns the (codes-or-values tensor,
    scales tensor or None)."""
    arr = cache[which][li]

    def write(dst, src):
        if isinstance(slot, torch.Tensor):
            dst.index_copy_(2, slot, src)
        else:
            dst[:, :, slot:slot + src.shape[2]] = src

    if which + "_s" in cache:
        codes, s = _kv_quantize(vals)
        write(arr, codes)
        arr_s = cache[which + "_s"][li]
        write(arr_s, s)
        return arr, arr_s
    write(arr, vals.to(arr.dtype))
    return arr, None


def _decode_attention(q, k_cache, v_cache, pos, k_scale=None,
                      v_scale=None):
    """The reference's masked read, in plain torch ops: q [b, h, g, hd]
    against the cache [b, h_kv, L, hd], block row i seeing ``slot <= pos
    + i``. GQA folds each KV head's query groups into rows
    (``[rep * g, hd] @ [hd, L]``), never repeating the cache; int8
    caches factor their per-slot scales out of both contractions."""
    b, h, g, hd = q.shape
    h_kv = k_cache.shape[1]
    rep = h // h_kv
    qg = q.reshape(b, h_kv, rep * g, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.to(q.dtype)).float()
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]                     # per-key scale
    s = s / math.sqrt(hd)
    length = k_cache.shape[2]
    # row r of the folded [rep * g] axis is block row r % g
    row_pos = pos + torch.arange(g, device=q.device).repeat(rep)
    visible = (torch.arange(length, device=q.device)[None, :]
               <= row_pos[:, None])
    s = torch.where(visible[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]                     # per-value scale
    p = p.to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.to(q.dtype))
    return out.reshape(b, h, g, hd)


def block_prefill(params: Params, cfg: ModelConfig, cache: Dict,
                  tokens: torch.Tensor, attn_fn=None,
                  prefix_lm: bool = False, last_index=None):
    """Fill the KV cache from a whole [b, t0] prompt in one forward and
    return (logits [b, vocab] at the last position, cache, t0).
    ``prefix_lm=True`` makes the prompt bidirectional. ``last_index``
    (causal only) reads the logits at that position instead of the last:
    a prompt right-padded to a bucket reads them at its real last
    token."""
    if last_index is not None and prefix_lm:
        raise ValueError("last_index requires causal prefill (prefix_lm "
                         "treats the padded length as the prefix)")
    if cfg.window > 0:
        raise ValueError("block_prefill requires cfg.window == 0 "
                         "(ring caches fill sequentially)")
    b, t0 = tokens.shape
    params = unstack_layer_params(params)
    n_kv = cfg.n_kv_heads or cfg.n_heads
    hd = cfg.d_model // cfg.n_heads
    kv_d = hd * n_kv
    attn = attn_fn or attention_reference
    kw = {"prefix": t0} if prefix_lm else {}

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    if not cfg.use_rope:
        x = x + params["pos_embed"][:t0]

    new_k, new_v, new_ks, new_vs = [], [], [], []
    for li, layer in enumerate(params["layers"]):
        xn = _rmsnorm(x, layer["ln1"]["g"])
        qkv = mm(xn, layer["wqkv"])
        q, k, v = qkv.split([cfg.d_model, kv_d, kv_d], dim=-1)
        q = q.reshape(b, t0, cfg.n_heads, hd).transpose(1, 2)
        k = k.reshape(b, t0, n_kv, hd).transpose(1, 2)
        v = v.reshape(b, t0, n_kv, hd).transpose(1, 2)
        if cfg.use_rope:
            q = apply_rope(q)
            k = apply_rope(k)
        k_cache, k_s = _cache_write(cache, "k", li, k, 0)
        v_cache, v_s = _cache_write(cache, "v", li, v, 0)
        new_k.append(k_cache)
        new_v.append(v_cache)
        if k_s is not None:
            new_ks.append(k_s)
            new_vs.append(v_s)
        # the prefill block attends its own exact fp K/V
        att = attn(q, k, v, True, **kw)
        att = att.transpose(1, 2).reshape(b, t0, cfg.d_model)
        x = x + mm(att, layer["wo"])
        x = x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, cfg)

    if last_index is None:
        x = x[:, -1:]
    else:
        li_ = int(last_index)
        x = x[:, li_:li_ + 1]
    x = _rmsnorm(x, params["final_norm"]["g"])
    logits = lm_head(x, params["embed"])[:, 0]
    new_cache = {"k": new_k, "v": new_v}
    if new_ks:
        new_cache["k_s"] = new_ks
        new_cache["v_s"] = new_vs
    return logits, new_cache, t0


def chunked_prefill(params: Params, cfg: ModelConfig, cache: Dict,
                    tokens: torch.Tensor, chunk: int):
    """Fill the cache from a [b, t0] prompt in t0/chunk wide steps of
    :func:`wide_step` (row i of a chunk at base p sees slots <= p + i),
    bounding the attention transient at O(chunk * L). Full-length cache
    and causal model only. Returns (last-position logits [b, vocab],
    cache, t0)."""
    b, t0 = tokens.shape
    if cfg.window > 0:
        raise ValueError("chunked_prefill requires cfg.window == 0 "
                         "(ring caches fill one slot at a time)")
    if chunk < 1 or t0 % chunk:
        raise ValueError(
            f"prompt length {t0} must divide into chunks of {chunk}")
    last = torch.zeros((b, cfg.vocab), device=tokens.device)
    for pos in range(0, t0, chunk):
        logits, cache = wide_step(params, cfg, cache, pos,
                                  tokens[:, pos:pos + chunk])
        last = logits[:, -1]
    return last, cache, t0


def wide_step(params: Params, cfg: ModelConfig, cache: Dict,
              pos, toks: torch.Tensor):
    """Multi-token decode step: ``toks`` [b, g] at positions [pos, pos+g)
    → (logits [b, g, vocab], cache), the cache written in place. ``pos``
    is an int or a 0-d int32 tensor on the cache's device, which no part
    of the step reads on the host.

    g = 1 is the ordinary decode step; its write slot wraps at the cache
    length (a ring). g > 1 is the wide-verify forward and needs the
    full-length cache (cfg.window == 0).

    The read: g = 1 with a cache length that has a KV_BLOCK-multiple
    divisor (every full-length cache, and rings whose window has one)
    goes through ``flash_decode_attention``, which reads only the
    ``min(pos + 1, L)`` written slots (kernel B5 on the card); g > 1,
    and rings whose window has no such divisor, take the masked read
    :func:`_decode_attention`. Both compute the same function. The
    reference takes the masked read for every g."""
    b, g = toks.shape
    if g > 1 and cfg.window > 0:
        raise ValueError("wide_step with g > 1 requires cfg.window == 0 "
                         "(ring caches fill one slot at a time)")
    length = cache["k"][0].shape[2]
    if not cfg.use_rope and length > round_up_kv(cfg.max_seq):
        raise ValueError(
            f"cache length {length} exceeds max_seq "
            f"{cfg.max_seq} (learned pos_embed bounds positions)")
    n_kv = cfg.n_kv_heads or cfg.n_heads
    hd = cfg.d_model // cfg.n_heads
    kv_d = hd * n_kv
    flash = g == 1 and decode_block_t(length) > 0

    x = embed_lookup(params["embed"], toks, cfg.dtype)           # [b,g,d]
    if not cfg.use_rope:
        rows = pos + torch.arange(g, device=x.device)
        x = x + params["pos_embed"].index_select(0, rows)[None]

    # ring write (g = 1 only): slot = pos % L is the identity while pos <
    # L (the full-length cache) and wraps only in ring mode; a device
    # position becomes the g slots' indices, once per step
    slot = pos % length if g == 1 else pos
    if isinstance(slot, torch.Tensor):
        slot = slot + torch.arange(g, device=slot.device)

    params = unstack_layer_params(params)
    new_k, new_v, new_ks, new_vs = [], [], [], []
    for li, layer in enumerate(params["layers"]):
        xn = _rmsnorm(x, layer["ln1"]["g"])
        qkv = mm(xn, layer["wqkv"])                          # [b,g,d+2kv_d]
        q, k, v = qkv.split([cfg.d_model, kv_d, kv_d], dim=-1)
        q = q.reshape(b, g, cfg.n_heads, hd).transpose(1, 2)
        k = k.reshape(b, g, n_kv, hd).transpose(1, 2)
        v = v.reshape(b, g, n_kv, hd).transpose(1, 2)
        if cfg.use_rope:
            q = apply_rope(q, pos0=pos)
            k = apply_rope(k, pos0=pos)
        k_cache, k_s = _cache_write(cache, "k", li, k, slot)
        v_cache, v_s = _cache_write(cache, "v", li, v, slot)
        new_k.append(k_cache)
        new_v.append(v_cache)
        if k_s is not None:
            new_ks.append(k_s)
            new_vs.append(v_s)
        if flash:
            att = flash_decode_attention(q.contiguous(), k_cache, v_cache,
                                         pos, k_s, v_s)
        else:
            att = _decode_attention(q, k_cache, v_cache, pos, k_s, v_s)
        att = att.transpose(1, 2).reshape(b, g, cfg.d_model)
        x = x + mm(att, layer["wo"])
        x = x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, cfg)

    x = _rmsnorm(x, params["final_norm"]["g"])
    logits = lm_head(x, params["embed"])                     # [b, g, vocab]
    new_cache = {"k": new_k, "v": new_v}
    if new_ks:
        new_cache["k_s"] = new_ks
        new_cache["v_s"] = new_vs
    return logits, new_cache


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                pos, token: torch.Tensor):
    """One token step: token [b] at position ``pos`` (an int or a 0-d
    int32 tensor) → (logits [b, vocab], cache). The g = 1 case of
    :func:`wide_step`."""
    logits, cache = wide_step(params, cfg, cache, pos, token[:, None])
    return logits[:, 0], cache


def decode_tokens_per_sec(b: int = 8, prompt_len: int = 128,
                          gen_short: int = 64, gen_long: int = 1056,
                          iters: int = 5,
                          cfg: Optional[ModelConfig] = None,
                          quantized: bool = False,
                          device="cuda") -> dict:
    """Greedy-decoding throughput (tokens/s) through the KV-cache path:
    seconds per step from the device-busy time of one long chain on the
    card (``chain_seconds_per_step``; the marginal rate between the two
    chain lengths without a card). Both chain lengths get the same cache
    capacity. ``quantized=True`` runs the same model with int8
    weight-only quantization. Weights and the prompt come from fixed
    seeds; default model: a GQA + RoPE block stack."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=4096, d_model=512, n_heads=8,
                             n_kv_heads=2, n_layers=4, d_ff=2048,
                             max_seq=prompt_len + gen_long, use_rope=True)
    params = init_params(cfg, 0, device=dev)
    if quantized:
        params = quantize_params(params)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len), generator=gen,
                           dtype=torch.int32).to(dev)

    def make_run(n):
        # identical cache capacity for both chain lengths
        return lambda: generate(params, cfg, prompt, steps=n,
                                max_t=prompt_len + gen_long)

    per_step = chain_seconds_per_step(make_run, gen_short, gen_long, iters)
    n_kv = cfg.n_kv_heads or cfg.n_heads
    return {"decode_tokens_per_sec": b / per_step,
            "decode_step_ms": per_step * 1e3,
            "param_mib": param_bytes(params) / 2**20,
            "shape": (f"b{b} L{cfg.n_layers} d{cfg.d_model} "
                      f"h{cfg.n_heads}/kv{n_kv} "
                      f"prompt{prompt_len}"
                      + (" int8" if quantized else ""))}


def truncate_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask logits strictly below the k-th largest (last axis) to
    NEG_INF. Ties at the k-th value are all kept, so the surviving set
    can exceed k. top_k == 0 is a no-op."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, NEG_INF))


def categorical(probs: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``probs`` [..., V] from ``generator``: the
    argmax of p / E with E ~ Exp(1); a token of probability 0 is never
    drawn, even where E is 0."""
    e = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax((probs / e).masked_fill(probs == 0, -1.0), dim=-1)


@torch.no_grad()
def generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
             steps: int, max_t: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             prefix_lm: Optional[bool] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Generation: prompt [b, t0] → [b, t0 + steps], on the prompt's
    device (the params must be there too).

    Prefill fills the KV cache from the prompt (one block forward;
    ``prefill_chunk`` wide steps of that length; a sequential decode
    step per token for windowed ring caches), then ``steps`` tokens
    extend it. ``max_t`` overrides the cache capacity (default t0 +
    steps).

    ``temperature == 0`` (default) is greedy argmax; ``temperature > 0``
    samples ``categorical(logits / temperature)`` from ``generator`` (a
    :class:`torch.Generator` on the prompt's device, the counterpart of
    the reference's ``key``), optionally truncated to the ``top_k``
    highest logits first. ``prefix_lm=True`` makes the prompt region
    bidirectional (default: ``cfg.prefix > 0``).

    The cache is written in place, one slot a step. The decode loop
    (and the ring prefill) is :func:`_step_body` run once per step by a
    :class:`StepGraph`: replays of one CUDA graph on the card, the body
    itself on the CPU. The position, the fed-back token and the output
    stay on the prompt's device, and the host never waits for it."""
    if steps <= 0:
        return prompt
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a PRNG key "
                         "(a torch.Generator)")
    if top_k > 0 and temperature == 0:
        raise ValueError("top_k has no effect at temperature=0 (greedy); "
                         "set temperature > 0 to sample")
    if top_k < 0 or top_k > cfg.vocab:
        raise ValueError(f"top_k must be in [0, vocab={cfg.vocab}], "
                         f"got {top_k}")
    b, t0 = prompt.shape
    max_t = max(max_t or 0, t0 + steps)
    if max_t > cfg.max_seq and not cfg.use_rope:
        raise ValueError(f"t0+steps ({max_t}) exceeds max_seq {cfg.max_seq}")
    if prefix_lm is None:
        prefix_lm = cfg.prefix > 0
    if prefix_lm and cfg.window > 0:
        raise ValueError("prefix_lm needs the block prefill, which the "
                         "windowed ring cache cannot host (window == 0)")
    if prefill_chunk is not None:
        if cfg.window > 0:
            raise ValueError("prefill_chunk needs a full-length cache "
                             "(window == 0)")
        if prefix_lm:
            raise ValueError("prefill_chunk is causal-only (prefix_lm "
                             "needs the whole prompt in one block)")
        if prefill_chunk < 1 or t0 % prefill_chunk:
            raise ValueError(f"prompt length {t0} must divide "
                             f"into chunks of {prefill_chunk}")
    temperature = float(temperature)
    dev = prompt.device
    cache = init_kv_cache(cfg, b, max_t, device=dev)
    out = torch.empty((b, t0 + steps), dtype=prompt.dtype, device=dev)
    out[:, :t0] = prompt
    pos = torch.zeros((), dtype=torch.int32, device=dev)

    def pick(logits):
        if temperature == 0:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        s = truncate_top_k(logits.float() / temperature, top_k)
        return categorical(torch.softmax(s, dim=-1),
                           generator).to(prompt.dtype)

    if cfg.window > 0:
        # ring cache: fill one slot at a time (the wrap layout is
        # positional), the token of each step read from the prompt
        prefill = StepGraph(_step_body(params, cfg, cache, out, pos), dev)
        for _ in range(t0):
            last_logits = prefill()
    else:
        if prefill_chunk is not None:
            last_logits, cache, _ = chunked_prefill(params, cfg, cache,
                                                    prompt, prefill_chunk)
        else:
            last_logits, cache, _ = block_prefill(params, cfg, cache,
                                                  prompt,
                                                  prefix_lm=prefix_lm)
        pos.fill_(t0)
    out[:, t0] = pick(last_logits)
    step = StepGraph(_step_body(params, cfg, cache, out, pos, pick), dev,
                     generator=generator if temperature > 0 else None)
    for _ in range(steps - 1):
        step()
    return out


def _step_body(params: Params, cfg: ModelConfig, cache: Dict,
               out: torch.Tensor, pos: torch.Tensor, pick=None):
    """One step of :func:`generate` as a function of no arguments, for
    :class:`StepGraph`: it reads the position ``pos`` (0-d int32) and the
    token ``out[:, pos]`` from their tensors, decodes it into the cache
    and advances ``pos`` by one in place, and returns the logits. With
    ``pick`` (logits → tokens) it also writes the picked tokens to
    ``out[:, pos + 1]``; without it (the ring prefill, whose tokens are
    the prompt's) ``out`` is only read."""

    def body():
        tok = out.index_select(1, pos.view(1))[:, 0]
        logits, _ = decode_step(params, cfg, cache, pos, tok)
        if pick is not None:
            nxt = (pos + 1).long().view(1)
            out.index_copy_(1, nxt, pick(logits)[:, None])
        pos.add_(1)
        return logits

    return body


@torch.no_grad()
def _eval_loss(params, batch, cfg, attn_fn) -> torch.Tensor:
    return loss_fn(params, batch, cfg, attn_fn)


def evaluate_nll(params: Params, cfg: ModelConfig, batches,
                 attn_fn=None) -> Dict[str, float]:
    """Token-weighted mean negative log-likelihood and perplexity over an
    iterator of (tokens, targets) batches."""
    total, tokens = 0.0, 0
    for batch in batches:
        n = batch[0].numel()
        total += float(_eval_loss(params, batch, cfg, attn_fn)) * n
        tokens += n
    if tokens == 0:
        raise ValueError("evaluate_nll got an empty batch iterator")
    nll = total / tokens
    return {"nll": nll, "ppl": math.exp(nll), "tokens": tokens}
