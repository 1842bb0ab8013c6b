"""The flagship transformer LM: config, parameters, the layers, the
training forward and loss, the optimizers and the train step.

Port of :mod:`tpu_dra_driver.workloads.models.transformer`. Params are a
plain dict with the reference's keys and shapes, so a JAX pytree
converts one to one (:func:`..convert.params_from_jax`). The FFN half of
a block is the dense MLP, the softmax-gated dense mixture of experts or
the top-k mixture with capacity, as in the reference; the optimizers are
optax's AdamW and Adafactor chains.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import (
    QTensor, _leaves, embed_lookup, ffn_weights, lm_head, mm,
)
from tpu_dra_driver_torch.workloads.ops.attention import (
    attention_reference, flash_attention,
)
from tpu_dra_driver_torch.workloads.utils.profiling import annotate
from tpu_dra_driver_torch.workloads.utils.timing import (
    chain_seconds_per_step,
)


@dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference config; see there for what each
    one does. ``dtype`` is a torch dtype."""

    vocab: int = 1024
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 1024
    max_seq: int = 256
    dtype: torch.dtype = torch.bfloat16
    n_kv_heads: int = 0
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    use_rope: bool = False
    remat: bool = False
    remat_policy: str = ""
    window: int = 0
    scan_layers: bool = False
    scan_unroll: int = 1
    prefix: int = 0
    kv_int8: bool = False


Params = Dict


def _tree_map(fn, *nodes):
    """Map ``fn`` over matching leaves of dict/list/QTensor trees."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(n[k] for n in nodes)) for k in first}
    if isinstance(first, list):
        return [_tree_map(fn, *xs) for xs in zip(*nodes)]
    if isinstance(first, QTensor):
        return QTensor(q=fn(*(n.q for n in nodes)),
                       s=fn(*(n.s for n in nodes)), axis=first.axis)
    return fn(*nodes)


def _first_leaf(node) -> torch.Tensor:
    if isinstance(node, dict):
        return _first_leaf(next(iter(node.values())))
    if isinstance(node, list):
        return _first_leaf(node[0])
    if isinstance(node, QTensor):
        return node.q
    return node


def stack_layer_params(params: Params) -> Params:
    """[n_layers]-list layer dicts → one dict of [L, ...] tensors (the
    ``scan_layers`` storage layout)."""
    layers = params["layers"]
    if isinstance(layers, dict):
        return params
    out = dict(params)
    out["layers"] = _tree_map(lambda *xs: torch.stack(xs), *layers)
    return out


def unstack_layer_params(params: Params) -> Params:
    """Inverse of :func:`stack_layer_params` (views, no copies). Each
    stacked leaf is split by one ``unbind(0)``, whose backward stacks the
    per-layer gradients once; indexing ``a[i]`` per layer would instead
    write a zero gradient of the whole stacked leaf for every layer."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params
    n = _first_leaf(layers).shape[0]
    split = _tree_map(lambda a: a.unbind(0), layers)
    out = dict(params)
    out["layers"] = [_tree_map(lambda parts, i=i: parts[i], split)
                     for i in range(n)]
    return out


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator],
                device="cuda") -> Params:
    """Random params with the reference's keys and shapes: N(0, 0.02)
    weights in ``cfg.dtype``, unit fp32 norm gains. ``key`` is a seed or
    a CPU :class:`torch.Generator`; draws are made on the CPU in fp32 so
    one seed gives the same weights on every device."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) \
        else torch.Generator().manual_seed(int(key))
    scale = 0.02

    def mat(shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (scale * w).to(device=dev, dtype=cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)

    params: Params = {
        "embed": mat((cfg.vocab, cfg.d_model)),
        "layers": [],
        "final_norm": {"g": ones()},
    }
    if not cfg.use_rope:
        params["pos_embed"] = mat((cfg.max_seq, cfg.d_model))
    n_kv = cfg.n_kv_heads or cfg.n_heads
    kv_d = cfg.d_model * n_kv // cfg.n_heads
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": {"g": ones()},
            "wqkv": mat((cfg.d_model, cfg.d_model + 2 * kv_d)),
            "wo": mat((cfg.d_model, cfg.d_model)),
            "ln2": {"g": ones()},
        }
        if cfg.n_experts > 0:
            layer["router"] = mat((cfg.d_model, cfg.n_experts))
            layer["moe_up"] = mat((cfg.n_experts, cfg.d_model, cfg.d_ff))
            layer["moe_down"] = mat((cfg.n_experts, cfg.d_ff, cfg.d_model))
        else:
            layer["w_up"] = mat((cfg.d_model, cfg.d_ff))
            layer["w_down"] = mat((cfg.d_ff, cfg.d_model))
        params["layers"].append(layer)
    if cfg.scan_layers:
        params = stack_layer_params(params)
    return params


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return ((x32 * rms) * g).to(x.dtype)


def apply_rope(x: torch.Tensor, pos0=0, theta: float = 10000.0
               ) -> torch.Tensor:
    """Rotary embedding on [b, h, t, hd] (split-half rotation, fp32).
    ``pos0`` is a scalar start position (an int, or a 0-d tensor), or a
    [b] tensor of per-sequence positions (ragged continuous-batching
    decode). A tensor is never read on the host: the positions are made
    on its device, exactly (integers below 2^24 are exact in f32)."""
    b, h, t, hd = x.shape
    dev = x.device
    half = torch.arange(0, hd // 2, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / (theta ** (half / (hd // 2)))
    if isinstance(pos0, torch.Tensor):
        pos = pos0.float()[..., None] + torch.arange(
            t, dtype=torch.float32, device=dev)              # [t] or [b, t]
    else:
        # made on the device: copying a host number there would wait
        # for the device
        pos = torch.arange(pos0, pos0 + t, dtype=torch.float32, device=dev)
    ang = pos[..., None] * inv_freq                 # [t, hd/2] or [b, t, hd/2]
    ang = ang[:, None] if ang.dim() == 3 else ang[None, None]
    cos = torch.cos(ang)
    sin = torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mlp(x: torch.Tensor, layer: Params, spmd=None) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    out = mm(F.gelu(mm(x, layer["w_up"]), approximate="tanh"),
             layer["w_down"])
    # sharded: w_up column-parallel, w_down row-parallel, partial sums
    return out if spmd is None else spmd.psum(out, ("tp",))


def _moe(x: torch.Tensor, layer: Params, spmd=None) -> torch.Tensor:
    """Softmax-gated dense mixture of experts: every expert runs on every
    token ([b, E, t, ff]) and the outputs are weighted by the gates,
    computed in f32 and cast to x's dtype for the combine. Sharded, the
    gates come from the whole router and each rank combines its own
    experts (over ``ep``, each split over ``tp``), summed over both."""
    gates = torch.softmax((x @ layer["router"]).float(), dim=-1)
    if spmd is not None:
        gates = gates[..., spmd.expert_slice(layer["moe_up"].shape[0])]
    up = torch.einsum("btd,edf->betf", x, layer["moe_up"])
    act = F.gelu(up, approximate="tanh")
    down = torch.einsum("betf,efd->betd", act, layer["moe_down"])
    out = torch.einsum("bte,betd->btd", gates.to(x.dtype), down)
    return out if spmd is None else spmd.psum(out, ("tp", "ep"))


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` on CUDA promises no order on ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_topk(x: torch.Tensor, layer: Params, top_k: int,
              capacity_factor: float, spmd=None) -> torch.Tensor:
    """Top-k mixture of experts with capacity (GShard/Switch dispatch and
    combine). Each token's top_k experts by router logit, weighted by the
    softmax over those k logits; each (token, slot) takes its place in
    its expert's queue in (t, k) order, and those past ``capacity`` are
    dropped (the block's residual carries them). The expert FFN runs on
    the gathered [b, E, C, d] block.

    Every shape comes from the input's shapes and the one-hots are
    comparisons with an ``arange``: nothing is read on the host, so a
    CUDA graph can capture it.

    Sharded, the capacity and the queues are the whole sequence's: the
    capacity counts every sequence shard's tokens, and each rank's
    queue positions start after the slots that earlier shards' tokens
    take. Each rank runs its own experts on its own tokens' slots (the
    others' rows are zeros, which the expert FFN maps to zeros) and the
    outputs are summed over ``tp`` and ``ep``."""
    b, t, d = x.shape
    n_e = layer["router"].shape[-1]
    t_all = t if spmd is None else t * spmd.size(spmd.seq_axis)
    capacity = max(1, int(capacity_factor * top_k * t_all / n_e))
    dev = x.device

    logits = (x @ layer["router"]).float()                     # [b,t,E]
    top_vals, top_idx = _top_k(logits, top_k)                  # [b,t,k]
    weights = torch.softmax(top_vals, dim=-1)                  # renormalized
    assign = (top_idx[..., None]
              == torch.arange(n_e, device=dev)).float()        # [b,t,k,E]
    # each (token, slot)'s place in its expert's queue: an exclusive
    # cumsum over the slots in (t, k) order
    flat = assign.reshape(b, t * top_k, n_e)
    pos = flat.cumsum(1) - flat
    offsets = None if spmd is None else spmd.queue_offsets(flat.sum(1))
    if offsets is not None:
        pos = pos + offsets[:, None, :]
    pos = pos.reshape(b, t, top_k, n_e)
    within = (pos < capacity).float() * assign                 # kept
    slot = (pos * assign).sum(-1)                              # [b,t,k]
    pos_oh = (slot[..., None] == torch.arange(
        capacity, device=dev, dtype=slot.dtype)).float()       # [b,t,k,C]
    # dispatch [b,t,E,C]: does token t go to expert e at slot c; combine
    # weights it by the kept gate (one k at most per (t, e), so the two
    # are one contraction over k each, never a [b,t,k,E,C] product)
    dispatch = torch.einsum("btke,btkc->btec", within, pos_oh)
    combine = torch.einsum("btke,btkc->btec", within * weights[..., None],
                           pos_oh)
    if spmd is not None:
        experts = spmd.expert_slice(layer["moe_up"].shape[0])
        dispatch, combine = dispatch[:, :, experts], combine[:, :, experts]

    xin = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)
    up = torch.einsum("becd,edf->becf", xin, layer["moe_up"])
    act = F.gelu(up, approximate="tanh")
    out = torch.einsum("becf,efd->becd", act, layer["moe_down"])
    out = torch.einsum("btec,becd->btd", combine.to(x.dtype), out)
    return out if spmd is None else spmd.psum(out, ("tp", "ep"))


def _ffn(xn2: torch.Tensor, layer: Params, cfg: ModelConfig,
         spmd=None) -> torch.Tensor:
    """The block's FFN half: the dense MLP, the top-k MoE or the dense
    MoE, by the layer's params and the config; shared by the training
    forward, prefill, decode and the paged engine. Int8 expert banks are
    dequantized for the einsums (the dense leaves stay quantized for
    :func:`mm`). ``spmd``: the sharded step's layout (see
    :func:`_spmd_of`)."""
    if "moe_up" not in layer:
        return _mlp(xn2, layer, spmd)
    layer = ffn_weights(layer, xn2.dtype)
    if cfg.moe_top_k > 0:
        return _moe_topk(xn2, layer, cfg.moe_top_k, cfg.moe_capacity_factor,
                         spmd)
    return _moe(xn2, layer, spmd)


def _attention(x: torch.Tensor, layer: Params, n_heads: int,
               n_kv_heads: int = 0, attn_fn=None, use_rope: bool = False,
               window: int = 0, prefix: int = 0, spmd=None) -> torch.Tensor:
    """``attn_fn(q, k, v) -> out`` on [b, h, t, hd] tensors (default: the
    oracle :func:`attention_reference`); GQA when n_kv_heads < n_heads;
    ``window``/``prefix`` > 0 are passed on to ``attn_fn``. Sharded
    (``spmd``), the rank runs its ``tp`` share of the heads at its
    tokens' global positions, and the row-parallel ``wo``'s partial sums
    are summed over ``tp``."""
    b, t, d = x.shape
    n_kv = n_kv_heads or n_heads
    hd = d // n_heads
    kv_d = hd * n_kv
    wqkv, pos0 = layer["wqkv"], 0
    if spmd is not None:
        wqkv = spmd.qkv_columns(wqkv, d, kv_d)
        n_heads, n_kv = spmd.local_heads(n_heads, n_kv)
        pos0 = spmd.seq_start(t)
    qkv = mm(x, wqkv)                            # [b, t, d + 2 * kv_d]
    q, k, v = qkv.split([hd * n_heads, hd * n_kv, hd * n_kv], dim=-1)

    def heads(z, nh):
        return z.reshape(b, t, nh, hd).transpose(1, 2)

    qh, kh = heads(q, n_heads), heads(k, n_kv)
    if use_rope:
        qh, kh = apply_rope(qh, pos0), apply_rope(kh, pos0)
    attn = attn_fn or attention_reference
    if window > 0:
        attn = functools.partial(attn, window=window)
    if prefix > 0:
        attn = functools.partial(attn, prefix=prefix)
    out = attn(qh, kh, heads(v, n_kv))
    out = out.transpose(1, 2).reshape(b, t, hd * n_heads)
    out = mm(out, layer["wo"])
    return out if spmd is None else spmd.psum(out, ("tp",))


def _spmd_of(attn_fn):
    """The mesh layout that a sharded ``attn_fn`` carries
    (:func:`..parallel.make_ring_attention`,
    :func:`..parallel.make_ulysses_attention`), or None. With one, the
    params are this rank's shards as ``param_shardings`` lays them out,
    the tokens its ``batch_sharding`` shard, and the layers insert the
    collectives that the reference's global arrays leave to XLA."""
    return getattr(attn_fn, "spmd", None)


def _make_block(cfg: ModelConfig, attn_fn):
    """The transformer block as a (x, layer) -> x function, the one
    definition :func:`forward` and :func:`forward_with_exit` run."""
    spmd = _spmd_of(attn_fn)

    def block(x, layer):
        x = x + _attention(_rmsnorm(x, layer["ln1"]["g"]), layer,
                           cfg.n_heads, cfg.n_kv_heads, attn_fn,
                           use_rope=cfg.use_rope, window=cfg.window,
                           prefix=cfg.prefix, spmd=spmd)
        return x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, cfg, spmd)
    return block


# the outputs of the matrix products: the projections (aten.mm, addmm)
# and the batched products (aten.bmm) that the MoE einsums and the
# attention oracle lower to. JAX's dots_with_no_batch_dims_saveable
# keeps only dots without batch dimensions, so it recomputes most MoE
# einsums in the backward where this policy keeps them; the values are
# the same either way, only memory and time differ
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, cfg: ModelConfig):
    """``block`` under activation checkpointing (non-reentrant): the
    whole block is recomputed in the backward (``remat_policy=""``), or
    everything but the projections' outputs (``"dots"``). An opaque
    kernel inside the block (flash attention's forward) runs again in
    the recompute."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, block, use_reentrant=False, **kw)


def _hidden_states(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attn_fn):
    """Yields the embedded tokens, then the hidden state after each
    block in order. Stacked ``[L, ...]`` params (the ``scan_layers``
    layout) are walked as views, so gradients land on the stacked
    leaves. ``remat`` checkpoints each block (see :func:`_remat`).
    Sharded, the embedding is the vocab-parallel lookup and the learned
    positions are the tokens' global ones."""
    spmd = _spmd_of(attn_fn)
    t = tokens.shape[1]
    if spmd is None:
        x = embed_lookup(params["embed"], tokens, cfg.dtype)
        if not cfg.use_rope:
            x = x + params["pos_embed"][:t]
    else:
        x = spmd.embed(params["embed"], tokens)
        if not cfg.use_rope:
            x = x + spmd.pos_rows(params["pos_embed"], t)
    yield x
    block = _make_block(cfg, attn_fn)
    if cfg.remat:
        block = _remat(block, cfg)
    for layer in unstack_layer_params(params)["layers"]:
        x = block(x, layer)
        yield x


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn=None, return_hidden: bool = False) -> torch.Tensor:
    """tokens [b, t] → logits [b, t, vocab] f32, or with
    ``return_hidden`` the final-normed hidden states [b, t, d].
    ``scan_layers`` and ``scan_unroll`` change only the params' layout
    here: PyTorch runs the layer loop eagerly, there is no trace to
    shrink. With a sharded ``attn_fn`` (:func:`_spmd_of`) it runs on this
    rank's shards and returns its shard of the logits: its batch and
    sequence shard, and its ``tp`` share of the vocabulary."""
    for x in _hidden_states(params, tokens, cfg, attn_fn):
        pass
    x = _rmsnorm(x, params["final_norm"]["g"])
    if return_hidden:
        return x
    return lm_head(x, params["embed"])


def forward_with_exit(params: Params, tokens: torch.Tensor,
                      cfg: ModelConfig, exit_layer: int, attn_fn=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full logits, early-exit logits after ``exit_layer`` blocks), both
    through the same final norm and tied head. scan_layers=False only,
    as in the reference."""
    if cfg.scan_layers:
        raise ValueError("forward_with_exit needs per-layer params "
                         "(scan_layers=False)")
    if _spmd_of(attn_fn) is not None:
        raise ValueError("forward_with_exit runs on one device")
    if not (1 <= exit_layer <= cfg.n_layers):
        raise ValueError(
            f"exit_layer {exit_layer} outside [1, {cfg.n_layers}]")
    for i, x in enumerate(_hidden_states(params, tokens, cfg, attn_fn)):
        if i == exit_layer:
            x_exit = x
    g = params["final_norm"]["g"]
    return (lm_head(_rmsnorm(x, g), params["embed"]),
            lm_head(_rmsnorm(x_exit, g), params["embed"]))


def nll_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level negative log-likelihood; ``mask`` ([t] or
    broadcastable bool) selects the positions that count."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    w = mask.broadcast_to(nll.shape).to(nll.dtype)
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def loss_positions(cfg: ModelConfig, t: int, device=None
                   ) -> Optional[torch.Tensor]:
    """Positions whose NLL counts, or None for all: with cfg.prefix the
    bidirectional prefix is excluded (its positions can see their own
    targets)."""
    if cfg.prefix > 0:
        return torch.arange(t, device=device) >= cfg.prefix
    return None


def loss_fn(params: Params, batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: ModelConfig, attn_fn=None, exit_layer: Optional[int] = None,
            exit_weight: float = 0.3) -> torch.Tensor:
    """Next-token NLL; with ``exit_layer``, ``(1 - w) * full + w * exit``
    where exit is the NLL of the early-exit logits. With a sharded
    ``attn_fn`` on more than one rank, the global mean NLL (every rank
    gets the same): the log-softmax reduced over the vocabulary's ``tp``
    shards and the NLL summed over the batch and sequence shards, over
    the global count."""
    tokens, targets = batch
    spmd = _spmd_of(attn_fn)
    if spmd is not None and spmd.world > 1:
        if exit_layer is not None:
            raise ValueError("the sharded loss takes no exit_layer")
        x = forward(params, tokens, cfg, attn_fn, return_hidden=True)
        nll = spmd.token_nll(lm_head(x, params["embed"]), targets)
        return spmd.mean_nll(nll, spmd.positions_mask(
            cfg.prefix, tokens.shape[1], tokens.device))
    pos = loss_positions(cfg, tokens.shape[1], tokens.device)
    if exit_layer is None:
        return nll_from_logits(forward(params, tokens, cfg, attn_fn),
                               targets, pos)
    full, exit_ = forward_with_exit(params, tokens, cfg, exit_layer,
                                    attn_fn)
    return ((1.0 - exit_weight) * nll_from_logits(full, targets, pos)
            + exit_weight * nll_from_logits(exit_, targets, pos))


def _param_leaves(node) -> List:
    """Leaves of a params tree in a fixed order (dict insertion order)."""
    return list(_leaves(node))


def _leaf_paths(node, prefix: str = "") -> List[str]:
    """The path of each leaf of :func:`_param_leaves`, in its order: dict
    keys and list indices joined by dots (``layers.0.wqkv``)."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return [prefix]
    return [p for k, v in items
            for p in _leaf_paths(v, f"{prefix}.{k}" if prefix else str(k))]


def _check_state_keys(got, want, what: str) -> None:
    if set(got) != set(want):
        raise KeyError(f"{what} state_dict does not match its params: "
                       f"missing {sorted(set(want) - set(got))[:4]}, "
                       f"unexpected {sorted(set(got) - set(want))[:4]}")


def param_count(params: Params) -> int:
    return sum((leaf.q if isinstance(leaf, QTensor) else leaf).numel()
               for leaf in _param_leaves(params))


# ------------------------------------------------------------ optimizer

def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps, end)``: linear from 0 over ``warmup_steps``, then a
    cosine from ``peak`` to ``end`` over ``decay_steps - warmup_steps``
    steps, flat after."""
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={span}.")
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak * step / warmup_steps
        n = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * n / span))
        return peak * ((1.0 - alpha) * cosine + alpha)
    return schedule


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` (its defaults: b1 0.9, b2 0.999, eps 1e-8,
    decoupled weight decay 1e-4 on every leaf), optionally preceded by
    ``optax.clip_by_global_norm(clip_norm)``. ``learning_rate`` is a
    number or a schedule ``step -> lr`` evaluated at the step count
    (0 on the first step). :meth:`init` builds the state over a params
    tree (``layout``: see :class:`OptState`)."""

    learning_rate: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: Optional[float] = None

    def init(self, params: Params, layout=None) -> "OptState":
        return OptState(self, params, layout)


def _trainable_leaves(params: Params) -> List[torch.Tensor]:
    """The leaves of ``params`` in a fixed order, each set to require
    grad; quantized or integer leaves are refused."""
    leaves = _param_leaves(params)
    for leaf in leaves:
        if isinstance(leaf, QTensor) or not leaf.is_floating_point():
            raise ValueError("training needs floating-point params "
                             "(quantized params are inference-only)")
        leaf.requires_grad_(True)
    return leaves


class OptState:
    """The optimizer's state over one params tree: ``torch.optim.AdamW``
    over its leaves (moments in each leaf's dtype, as optax keeps them),
    a ``LambdaLR`` that sets step k's rate to ``schedule(k)``, and the
    clip norm. Creating it sets ``requires_grad`` on every leaf.

    ``layout`` (a sharded step's :class:`..parallel.spmd.Layout`, whose
    ``init`` passes it): the params are this rank's shards; the global
    norm sums over the shards, and a leaf with a ZeRO-1 dim keeps the
    moments of its ``dp`` slice only, updates that slice and joins the
    slices back after each step."""

    def __init__(self, spec: AdamW, params: Params, layout=None):
        self.spec = spec
        self.leaves = _trainable_leaves(params)
        self.paths = _leaf_paths(params)
        self.layout = layout
        self.targets = self.leaves if layout is None else [
            layout.zero_view(i, leaf) for i, leaf in enumerate(self.leaves)]
        lr = spec.learning_rate
        schedule = lr if callable(lr) else (lambda step: lr)
        self.optimizer = torch.optim.AdamW(
            self.targets, lr=1.0, betas=(spec.b1, spec.b2), eps=spec.eps,
            weight_decay=spec.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                           schedule)
        self.clip_norm = spec.clip_norm

    def state_dict(self) -> Dict:
        """The state as optax's pytree holds it, every tensor named by its
        leaf's path in the params tree: ``<path>.exp_avg``,
        ``<path>.exp_avg_sq`` (in the leaf's dtype, on its device) and
        ``<path>.step`` (a CPU f32 scalar), and ``count``, the scheduler's
        epoch (updates so far). A leaf not yet updated gives the zeros
        its first update starts from, so the names and shapes are the
        same before the first step."""
        out = {"count": self.scheduler.last_epoch}
        for path, target in zip(self.paths, self.targets):
            st = self.optimizer.state.get(target, {})
            for name in ("exp_avg", "exp_avg_sq"):
                out[f"{path}.{name}"] = st[name] if name in st \
                    else torch.zeros_like(target)
            out[f"{path}.step"] = st["step"] if "step" in st \
                else torch.tensor(0.0, dtype=torch.float32)
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Set the moments, step counts and the scheduler's epoch from a
        :meth:`state_dict` of an optimizer over params of the same paths
        and shapes (copied onto each leaf's device)."""
        _check_state_keys(state, ["count"] + [
            f"{path}.{name}" for path in self.paths
            for name in ("exp_avg", "exp_avg_sq", "step")], "AdamW")
        count = int(state["count"])
        for path, target in zip(self.paths, self.targets):
            self.optimizer.state[target] = {
                "step": state[f"{path}.step"].detach().to(
                    "cpu", torch.float32, copy=True),
                **{name: state[f"{path}.{name}"].detach().to(
                    target.device, target.dtype, copy=True)
                   for name in ("exp_avg", "exp_avg_sq")}}
        # what count updates leave in LambdaLR and the optimizer's group
        self.scheduler.last_epoch = count
        self.scheduler._step_count = count + 1
        lrs = [base * fn(count) for base, fn in
               zip(self.scheduler.base_lrs, self.scheduler.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self.scheduler._last_lr = lrs

    @torch.no_grad()
    def apply(self, grads) -> None:
        """One update of the leaves in place from ``grads`` (one per
        leaf, in the leaves' dtypes)."""
        grads = list(grads)
        if self.clip_norm is not None:
            _clip_by_global_norm(grads, self.clip_norm, self.layout)
        for target, g in zip(self.targets, grads):
            target.grad = g
        self.optimizer.step()
        self.scheduler.step()
        for target in self.targets:
            target.grad = None
        if self.layout is not None:
            self.layout.gather_zero(self.leaves)


# optax.adafactor's defaults, the reference's settings: second moments
# factored over two dims of at least 128, decay 1 - (count + 1)^-0.8,
# eps added to g², updates clipped to block RMS 1, the parameter scale
# at least 1e-3
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP_RMS = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


@dataclass(frozen=True)
class Adafactor:
    """``optax.adafactor(learning_rate)`` (optax 0.2.6, its defaults: no
    momentum, no weight decay), optionally preceded by
    ``optax.clip_by_global_norm(clip_norm)``. The chain, per leaf:
    ``scale_by_factored_rms`` (second moments factored into row and
    column means over the two largest dims when both are at least 128,
    else kept whole), ``clip_by_block_rms(1.0)``,
    ``scale_by_learning_rate(learning_rate, flip_sign=False)``,
    ``scale_by_param_block_rms(1e-3)`` and ``scale(-1)``.
    ``learning_rate`` is a number or a schedule ``step -> lr``."""

    learning_rate: Union[float, Callable[[int], float]] = 1e-3
    clip_norm: Optional[float] = None

    def init(self, params: Params, layout=None) -> "AdafactorState":
        return AdafactorState(self, params, layout)


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's choice: the second-largest and the largest dim (by
    ``np.argsort`` of the shape), or None when the leaf has fewer than
    two dims or the second-largest is below
    ``ADAFACTOR_MIN_DIM_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class AdafactorState:
    """The Adafactor state over one params tree: per leaf, its row and
    column second-moment factors or its whole second moment, in the
    leaf's dtype (as optax keeps them), and the step count. optax keeps
    one count in each transform that has one (the factored RMS and the
    schedule); each advances once per update, so one count stands for
    both. Creating it sets ``requires_grad`` on every leaf.

    ``layout`` (as :class:`OptState`'s): the factoring follows each
    leaf's global shape, the row and column factors are whole on every
    rank (the reference replicates them), a whole second moment follows
    the leaf's shard (its ``dp`` slice under ZeRO-1), and the means over
    a dim or a whole leaf sum over its shards."""

    def __init__(self, spec: Adafactor, params: Params, layout=None):
        self.spec = spec
        self.leaves = _trainable_leaves(params)
        self.paths = _leaf_paths(params)
        self.layout = layout
        self.targets = self.leaves if layout is None else [
            layout.zero_view(i, leaf) for i, leaf in enumerate(self.leaves)]
        self.count = 0
        self.dims, self.v = [], []
        for i, (leaf, target) in enumerate(zip(self.leaves, self.targets)):
            shape = tuple(leaf.shape) if layout is None \
                else layout.global_shapes[i]
            dims = _factored_dims(shape)
            self.dims.append(dims)
            if dims is None:
                self.v.append(torch.zeros_like(target))
            else:
                if layout is not None and layout.zero_dims[i] is not None:
                    raise ValueError(f"{self.paths[i]}: Adafactor's factors "
                                     f"take no ZeRO-1 dim")
                d1, d0 = dims
                self.v.append(tuple(
                    leaf.new_zeros(np.delete(shape, d).tolist())
                    for d in (d0, d1)))                 # (v_row, v_col)

    def _sharded(self) -> bool:
        return self.layout is not None and self.layout.world > 1

    def _mean(self, x: torch.Tensor, dim: int, i: int) -> torch.Tensor:
        """The mean of leaf i's ``x`` over ``dim``, whole (every shard's
        rows, every rank the same)."""
        if not self._sharded():
            return x.mean(dim=dim)
        spec = self.layout.specs[i]
        s = self.layout.sum_over(x.float().sum(dim=dim), (spec[dim],))
        s = s / self.layout.global_shapes[i][dim]
        return self.layout.full(s.to(x.dtype),
                                spec[:dim] + spec[dim + 1:])

    def _block(self, x: torch.Tensor, i: int, dropped: int) -> torch.Tensor:
        """This rank's block of a whole factor of leaf i (the leaf's
        dims less ``dropped``)."""
        if not self._sharded():
            return x
        spec = self.layout.specs[i]
        return self.layout.block(x, spec[:dropped] + spec[dropped + 1:])

    def _mean_all(self, x: torch.Tensor, i: int, spec) -> torch.Tensor:
        """The mean over the whole leaf of ``x``, held under ``spec``."""
        if not self._sharded():
            return x.mean()
        s = self.layout.sum_over(x.float().sum(), spec)
        return (s / math.prod(self.layout.global_shapes[i])).to(x.dtype)

    def state_dict(self) -> Dict:
        """The state as optax's pytree holds it, every tensor named by its
        leaf's path in the params tree: ``<path>.v`` for a whole second
        moment, ``<path>.v_row`` and ``<path>.v_col`` for its factors (in
        the leaf's dtype, on its device), and ``count``, the updates so
        far."""
        out = {"count": self.count}
        for path, v in zip(self.paths, self.v):
            if isinstance(v, tuple):
                out[f"{path}.v_row"], out[f"{path}.v_col"] = v
            else:
                out[f"{path}.v"] = v
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Set the second moments and the count from a :meth:`state_dict`
        of an optimizer over params of the same paths and shapes (copied
        onto each leaf's device)."""
        _check_state_keys(state, self.state_dict(), "Adafactor")

        def load(key, like):
            return state[key].detach().to(like.device, like.dtype,
                                          copy=True)

        for i, (path, v) in enumerate(zip(self.paths, self.v)):
            self.v[i] = (load(f"{path}.v_row", v[0]),
                         load(f"{path}.v_col", v[1])) \
                if isinstance(v, tuple) else load(f"{path}.v", v)
        self.count = int(state["count"])

    @torch.no_grad()
    def apply(self, grads) -> None:
        """One update of the leaves in place from ``grads`` (one per
        leaf, in the leaves' dtypes). Each step's arithmetic follows
        optax's dtypes: the moment averages in f32, stored in the leaf's
        dtype, the update in the leaf's dtype."""
        grads = list(grads)
        if self.spec.clip_norm is not None:
            _clip_by_global_norm(grads, self.spec.clip_norm, self.layout)
        # optax's _decay_rate_pow, in f32
        t = np.float32(self.count + 1)
        decay = float(np.float32(1.0)
                      - t ** np.float32(-ADAFACTOR_DECAY_RATE))
        lr = self.spec.learning_rate
        lr = lr(self.count) if callable(lr) else lr
        for i, (leaf, g) in enumerate(zip(self.leaves, grads)):
            g_sqr = g * g + ADAFACTOR_EPS
            if self.dims[i] is None:
                v = (decay * self.v[i].float()
                     + (1.0 - decay) * g_sqr.float()).to(leaf.dtype)
                self.v[i] = v
                u = g * v ** -0.5
            else:
                d1, d0 = self.dims[i]
                v_row, v_col = (
                    (decay * old.float()
                     + (1.0 - decay) * self._mean(g_sqr, d, i).float()
                     ).to(leaf.dtype)
                    for old, d in zip(self.v[i], (d0, d1)))
                self.v[i] = (v_row, v_col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1,
                                                 keepdim=True)) ** -0.5
                u = (g * self._block(row_factor, i, d0).unsqueeze(d0)
                     * self._block(v_col ** -0.5, i, d1).unsqueeze(d1))
            del g_sqr
            # clip_by_block_rms, the learning rate (rounded to the leaf's
            # dtype, as optax's scale_by_schedule does), the parameter
            # scale, and the step down the gradient
            held = self.layout.held_spec(i) if self._sharded() else ()
            rms = self._mean_all(u.square(), i, held).sqrt()
            u = u / (rms / ADAFACTOR_CLIP_RMS).clamp_min(1.0)
            u = u * float(torch.tensor(lr, dtype=leaf.dtype))
            u = u * self._mean_all(
                leaf.square(), i,
                self.layout.specs[i] if self._sharded() else ()
            ).sqrt().clamp_min(ADAFACTOR_MIN_SCALE)
            self.targets[i].sub_(u)
        self.count += 1
        if self.layout is not None:
            self.layout.gather_zero(self.leaves)


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         layout=None) -> None:
    """``optax.clip_by_global_norm``, in place: when the global norm is at
    least ``max_norm`` each gradient becomes ``g / norm * max_norm``
    (no epsilon, unlike ``clip_grad_norm_``). The norm is taken in f32.
    With a sharded ``layout`` on more than one rank, each gradient is a
    shard (or a ZeRO-1 slice) and its squares are summed over the axes
    that split it."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    if layout is not None and layout.world > 1:
        by_spec: Dict[tuple, List[torch.Tensor]] = {}
        for i, n in enumerate(norms):
            spec = tuple(sorted({a for a in layout.held_spec(i) if a}))
            by_spec.setdefault(spec, []).append(n * n)
        norm = sum(layout.sum_over(torch.stack(sq).sum(), spec)
                   for spec, sq in by_spec.items()).sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def default_optimizer(lr: float = 3e-4, warmup_steps: int = 100,
                      total_steps: int = 10_000, clip_norm: float = 1.0,
                      weight_decay: Optional[float] = None,
                      kind: str = "adamw") -> Union[AdamW, Adafactor]:
    """The reference's training recipe: global-norm clipping, then AdamW
    (weight decay 0.1 unless given) or, with ``kind="adafactor"``,
    optax's Adafactor (factored second moments, no first moment), on a
    linear-warmup cosine-decay schedule from 0 to ``lr`` and down to
    ``0.1 * lr`` at ``total_steps``. With the default warmup the first
    step's rate is 0, so it leaves the params unchanged. ``weight_decay``
    is AdamW's decoupled coefficient and is refused with Adafactor, as
    the reference refuses it."""
    schedule = warmup_cosine_decay(lr, warmup_steps, total_steps, lr * 0.1)
    if kind == "adamw":
        return AdamW(learning_rate=schedule,
                     weight_decay=0.1 if weight_decay is None
                     else weight_decay,
                     clip_norm=clip_norm)
    if kind == "adafactor":
        if weight_decay is not None:
            raise ValueError(
                "weight_decay is the AdamW-style decoupled coefficient; "
                "adafactor's weight_decay_rate has different (per-step "
                "multiplicative) semantics — configure optax.adafactor "
                "directly if you need it")
        return Adafactor(learning_rate=schedule, clip_norm=clip_norm)
    raise ValueError(f"unknown optimizer kind {kind!r} "
                     f"(adamw | adafactor)")


def make_train_step(cfg: ModelConfig,
                    optimizer: Optional[Union[AdamW, Adafactor]] = None,
                    attn_fn=None, accum_steps: int = 1,
                    exit_layer: Optional[int] = None,
                    exit_weight: float = 0.3):
    """Returns (train_step, init_opt_state), as the reference does.
    ``train_step(params, opt_state, batch)`` updates the params IN PLACE
    (the reference returns new arrays) and returns ``(params, opt_state,
    loss)`` with the loss detached. ``init_opt_state(params)`` makes the
    params' leaves require grad. The default optimizer is
    ``optax.adamw(1e-3)``: :class:`AdamW` with weight decay 1e-4.

    ``accum_steps > 1`` splits the batch into that many microbatches,
    accumulates their gradients in f32 and hands the optimizer their
    mean in each param's dtype.

    With a sharded ``attn_fn`` (:func:`..parallel.make_ring_attention`
    over a ``build_mesh_spmd`` mesh) the step runs on this rank's shards
    of the params (``param_shardings``) and of the batch
    (``batch_sharding``) and returns the global loss. The gradient is
    taken of ``loss / world`` (the collectives' backwards are their
    transposes, so each rank's gradient is its share of the sum over
    ranks) and summed, for each leaf, over the axes that hold the leaf
    replicated. ``init_opt_state(params, shardings=None)`` then takes the
    shardings of :func:`..parallel.zero1_opt_shardings` (ZeRO-1) or,
    without them, keeps every moment as its param is sharded. On a mesh
    whose axes are all 1 the step computes what the unsharded step
    computes.

    Spans (``utils/profiling.py``, recorded while a profile runs):
    ``train.step`` around the step, with children ``train.forward``
    (the loss) and ``train.backward`` (its gradient), one pair per
    microbatch, and ``train.optimizer`` (``opt_state.apply``, the clip
    included); the three children carry CUDA timing events on the
    card."""
    opt = optimizer or AdamW(1e-3)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    spmd = _spmd_of(attn_fn)
    scale = 1.0 if spmd is None or spmd.world == 1 else 1.0 / spmd.world

    def loss_and_grads(params, batch, leaves):
        with annotate("train.forward", device=True):
            loss = loss_fn(params, batch, cfg, attn_fn, exit_layer,
                           exit_weight)
        with annotate("train.backward", device=True):
            grads = torch.autograd.grad(
                loss if scale == 1.0 else loss * scale, leaves,
                allow_unused=True, materialize_grads=True)
        return loss.detach(), grads

    def step_body(params, opt_state: Union[OptState, AdafactorState],
                  batch):
        leaves = opt_state.leaves
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, batch, leaves)
        else:
            tokens, targets = batch
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError(
                    f"batch {b} not divisible by accum_steps {accum_steps}")
            mb = b // accum_steps
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            lsum = 0.0
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                loss, g = loss_and_grads(
                    params, (tokens[rows], targets[rows]), leaves)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi.float())
                lsum = lsum + loss
            grads = [(acc / accum_steps).to(p.dtype)
                     for acc, p in zip(gsum, leaves)]
            loss = lsum / accum_steps
        if spmd is not None:
            if opt_state.layout is None:
                raise ValueError("a sharded step takes the optimizer state "
                                 "of its own init_opt_state")
            grads = opt_state.layout.sync(grads)
        with annotate("train.optimizer", device=True):
            opt_state.apply(grads)
        return params, opt_state, loss

    def train_step(params, opt_state: Union[OptState, AdafactorState],
                   batch):
        with annotate("train.step"):
            return step_body(params, opt_state, batch)

    if spmd is None:
        return train_step, opt.init

    def init_opt_state(params, shardings=None):
        return opt.init(params, layout=_sharded_layout(spmd, params,
                                                       shardings))

    return train_step, init_opt_state


def _sharded_layout(spmd, params: Params, shardings=None):
    """The :class:`..parallel.spmd.Layout` of this rank's shards
    ``params``: each leaf's ``param_shardings`` spec, and its ZeRO-1 dim
    where ``shardings`` (:func:`..parallel.zero1_opt_shardings`) puts
    ``dp`` on the moment that mirrors it."""
    from tpu_dra_driver_torch.workloads.parallel.mesh import param_shardings
    from tpu_dra_driver_torch.workloads.parallel.spmd import Layout
    leaves = _param_leaves(params)
    specs = [sh.spec for sh in _param_leaves(
        param_shardings(spmd.mesh, params))]
    zero_dims = []
    for path in _leaf_paths(params):
        dim = None
        for name in ("exp_avg", "v"):
            sh = (shardings or {}).get(f"{path}.{name}")
            if sh is not None and "dp" in sh.spec:
                dim = sh.spec.index("dp")
        zero_dims.append(dim)
    return Layout(spmd, leaves, specs, zero_dims)


def train_tokens_per_sec(b: int = 8, t: int = 2048, iters: int = 3,
                         steps_short: int = 2, steps_long: int = 12,
                         cfg: Optional[ModelConfig] = None,
                         use_flash: bool = True,
                         device="cuda") -> dict:
    """Full-model training throughput: tokens/s and achieved model
    TFLOP/s of chained train steps (gradient and ``default_optimizer()``
    update, in place) on a GPT-class block stack. Seconds per step come
    from ``chain_seconds_per_step``: the device-busy time of the long
    chain on the card, the marginal rate between the two chain lengths
    without one. FLOPs per token: 6 N for the matrix products forward
    and backward plus 6 * n_layers * t * d_model for causal attention,
    an estimate by design. Attention is ``flash_attention`` with
    ``use_flash`` (its kernels on the card, their plain versions on the
    CPU), else ``attention_reference``; the caller chooses (the
    reference picks flash on a TPU when given None)."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=8192, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_layers=8, d_ff=8192,
                             max_seq=t, use_rope=True, remat=True,
                             remat_policy="dots", scan_layers=True,
                             scan_unroll=8)
    params = init_params(cfg, 0, device=dev)
    train_step, opt_init = make_train_step(
        cfg, optimizer=default_optimizer(),
        attn_fn=flash_attention if use_flash else attention_reference)
    opt_state = opt_init(params)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=gen,
                           dtype=torch.int32).to(dev)
    batch = (tokens, tokens)

    def make_run(n):
        def run():
            loss = None
            for _ in range(n):
                _, _, loss = train_step(params, opt_state, batch)
            return loss
        return run

    per_step = chain_seconds_per_step(make_run, steps_short, steps_long,
                                      iters)
    n_params = param_count(params)
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * t * cfg.d_model
    tps = b * t / per_step
    return {"train_tokens_per_sec": tps,
            "train_step_ms": per_step * 1e3,
            "model_tflops": tps * flops_per_token / 1e12,
            "params_m": n_params / 1e6,
            "shape": (f"b{b} t{t} L{cfg.n_layers} d{cfg.d_model}"
                      + (" flash" if use_flash else ""))}
