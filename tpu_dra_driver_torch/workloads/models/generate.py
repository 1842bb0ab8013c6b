"""KV cache and whole-prompt prefill for the flagship transformer.

Port of the part of :mod:`tpu_dra_driver.workloads.models.generate`
that serving admission runs: ``init_kv_cache``, ``_kv_quantize``,
``_cache_write`` and ``block_prefill``. ``generate``, ``decode_step``
and the rest of that module are not ported yet.

Unlike the reference, cache writes update the cache tensors in place
(the returned cache holds the same tensors): prefill never copies a
whole cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import (
    embed_lookup, lm_head, mm,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig,
    Params,
    _ffn,
    _rmsnorm,
    apply_rope,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.ops.attention import attention_reference
from tpu_dra_driver_torch.workloads.ops.decode_attention import round_up_kv


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
                 slot: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Write [b, h_kv, g, hd] vectors at ``slot`` in place; returns the
    (codes-or-values tensor, scales tensor or None)."""
    arr = cache[which][li]
    g = vals.shape[2]
    if which + "_s" in cache:
        codes, s = _kv_quantize(vals)
        arr[:, :, slot:slot + g] = codes
        arr_s = cache[which + "_s"][li]
        arr_s[:, :, slot:slot + g] = s
        return arr, arr_s
    arr[:, :, slot:slot + g] = vals.to(arr.dtype)
    return arr, None


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
