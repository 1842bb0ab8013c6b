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


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return mm(F.gelu(mm(x, layer["w_up"]), approximate="tanh"),
              layer["w_down"])


def _moe(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """Softmax-gated dense mixture of experts: every expert runs on every
    token ([b, E, t, ff]) and the outputs are weighted by the gates,
    computed in f32 and cast to x's dtype for the combine."""
    gates = torch.softmax((x @ layer["router"]).float(), dim=-1)
    up = torch.einsum("btd,edf->betf", x, layer["moe_up"])
    act = F.gelu(up, approximate="tanh")
    down = torch.einsum("betf,efd->betd", act, layer["moe_down"])
    return torch.einsum("bte,betd->btd", gates.to(x.dtype), down)


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` on CUDA promises no order on ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_topk(x: torch.Tensor, layer: Params, top_k: int,
              capacity_factor: float) -> torch.Tensor:
    """Top-k mixture of experts with capacity (GShard/Switch dispatch and
    combine). Each token's top_k experts by router logit, weighted by the
    softmax over those k logits; each (token, slot) takes its place in
    its expert's queue in (t, k) order, and those past ``capacity`` are
    dropped (the block's residual carries them). The expert FFN runs on
    the gathered [b, E, C, d] block.

    Every shape comes from the input's shapes and the one-hots are
    comparisons with an ``arange``: nothing is read on the host, so a
    CUDA graph can capture it."""
    b, t, d = x.shape
    n_e = layer["router"].shape[-1]
    capacity = max(1, int(capacity_factor * top_k * t / n_e))
    dev = x.device

    logits = (x @ layer["router"]).float()                     # [b,t,E]
    top_vals, top_idx = _top_k(logits, top_k)                  # [b,t,k]
    weights = torch.softmax(top_vals, dim=-1)                  # renormalized
    assign = (top_idx[..., None]
              == torch.arange(n_e, device=dev)).float()        # [b,t,k,E]
    # each (token, slot)'s place in its expert's queue: an exclusive
    # cumsum over the slots in (t, k) order
    flat = assign.reshape(b, t * top_k, n_e)
    pos = (flat.cumsum(1) - flat).reshape(b, t, top_k, n_e)
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

    xin = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)
    up = torch.einsum("becd,edf->becf", xin, layer["moe_up"])
    act = F.gelu(up, approximate="tanh")
    out = torch.einsum("becf,efd->becd", act, layer["moe_down"])
    return torch.einsum("btec,becd->btd", combine.to(x.dtype), out)


def _ffn(xn2: torch.Tensor, layer: Params, cfg: ModelConfig) -> torch.Tensor:
    """The block's FFN half: the dense MLP, the top-k MoE or the dense
    MoE, by the layer's params and the config; shared by the training
    forward, prefill, decode and the paged engine. Int8 expert banks are
    dequantized for the einsums (the dense leaves stay quantized for
    :func:`mm`)."""
    if "moe_up" not in layer:
        return _mlp(xn2, layer)
    layer = ffn_weights(layer, xn2.dtype)
    if cfg.moe_top_k > 0:
        return _moe_topk(xn2, layer, cfg.moe_top_k, cfg.moe_capacity_factor)
    return _moe(xn2, layer)


def _attention(x: torch.Tensor, layer: Params, n_heads: int,
               n_kv_heads: int = 0, attn_fn=None, use_rope: bool = False,
               window: int = 0, prefix: int = 0) -> torch.Tensor:
    """``attn_fn(q, k, v) -> out`` on [b, h, t, hd] tensors (default: the
    oracle :func:`attention_reference`); GQA when n_kv_heads < n_heads;
    ``window``/``prefix`` > 0 are passed on to ``attn_fn``."""
    b, t, d = x.shape
    n_kv = n_kv_heads or n_heads
    hd = d // n_heads
    kv_d = hd * n_kv
    qkv = mm(x, layer["wqkv"])                   # [b, t, d + 2 * kv_d]
    q, k, v = qkv.split([d, kv_d, kv_d], dim=-1)

    def heads(z, nh):
        return z.reshape(b, t, nh, hd).transpose(1, 2)

    qh, kh = heads(q, n_heads), heads(k, n_kv)
    if use_rope:
        qh, kh = apply_rope(qh), apply_rope(kh)
    attn = attn_fn or attention_reference
    if window > 0:
        attn = functools.partial(attn, window=window)
    if prefix > 0:
        attn = functools.partial(attn, prefix=prefix)
    out = attn(qh, kh, heads(v, n_kv))
    out = out.transpose(1, 2).reshape(b, t, d)
    return mm(out, layer["wo"])


def _make_block(cfg: ModelConfig, attn_fn):
    """The transformer block as a (x, layer) -> x function, the one
    definition :func:`forward` and :func:`forward_with_exit` run."""
    def block(x, layer):
        x = x + _attention(_rmsnorm(x, layer["ln1"]["g"]), layer,
                           cfg.n_heads, cfg.n_kv_heads, attn_fn,
                           use_rope=cfg.use_rope, window=cfg.window,
                           prefix=cfg.prefix)
        return x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, cfg)
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
    leaves. ``remat`` checkpoints each block (see :func:`_remat`)."""
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    if not cfg.use_rope:
        x = x + params["pos_embed"][:tokens.shape[1]]
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
    shrink."""
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
    where exit is the NLL of the early-exit logits."""
    tokens, targets = batch
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
    tree."""

    learning_rate: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: Optional[float] = None

    def init(self, params: Params) -> "OptState":
        return OptState(self, params)


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
    clip norm. Creating it sets ``requires_grad`` on every leaf."""

    def __init__(self, spec: AdamW, params: Params):
        self.leaves = _trainable_leaves(params)
        lr = spec.learning_rate
        schedule = lr if callable(lr) else (lambda step: lr)
        self.optimizer = torch.optim.AdamW(
            self.leaves, lr=1.0, betas=(spec.b1, spec.b2), eps=spec.eps,
            weight_decay=spec.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                           schedule)
        self.clip_norm = spec.clip_norm

    @torch.no_grad()
    def apply(self, grads) -> None:
        """One update of the leaves in place from ``grads`` (one per
        leaf, in the leaves' dtypes)."""
        grads = list(grads)
        if self.clip_norm is not None:
            _clip_by_global_norm(grads, self.clip_norm)
        for leaf, g in zip(self.leaves, grads):
            leaf.grad = g
        self.optimizer.step()
        self.scheduler.step()
        for leaf in self.leaves:
            leaf.grad = None


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

    def init(self, params: Params) -> "AdafactorState":
        return AdafactorState(self, params)


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
    both. Creating it sets ``requires_grad`` on every leaf."""

    def __init__(self, spec: Adafactor, params: Params):
        self.spec = spec
        self.leaves = _trainable_leaves(params)
        self.count = 0
        self.dims, self.v = [], []
        for leaf in self.leaves:
            dims = _factored_dims(tuple(leaf.shape))
            self.dims.append(dims)
            if dims is None:
                self.v.append(torch.zeros_like(leaf))
            else:
                d1, d0 = dims
                self.v.append(tuple(
                    leaf.new_zeros(np.delete(leaf.shape, d).tolist())
                    for d in (d0, d1)))                 # (v_row, v_col)

    @torch.no_grad()
    def apply(self, grads) -> None:
        """One update of the leaves in place from ``grads`` (one per
        leaf, in the leaves' dtypes). Each step's arithmetic follows
        optax's dtypes: the moment averages in f32, stored in the leaf's
        dtype, the update in the leaf's dtype."""
        grads = list(grads)
        if self.spec.clip_norm is not None:
            _clip_by_global_norm(grads, self.spec.clip_norm)
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
                     + (1.0 - decay) * g_sqr.mean(dim=d).float()
                     ).to(leaf.dtype)
                    for old, d in zip(self.v[i], (d0, d1)))
                self.v[i] = (v_row, v_col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1,
                                                 keepdim=True)) ** -0.5
                u = (g * row_factor.unsqueeze(d0)
                     * (v_col ** -0.5).unsqueeze(d1))
            del g_sqr
            # clip_by_block_rms, the learning rate (rounded to the leaf's
            # dtype, as optax's scale_by_schedule does), the parameter
            # scale, and the step down the gradient
            rms = u.square().mean().sqrt()
            u = u / (rms / ADAFACTOR_CLIP_RMS).clamp_min(1.0)
            u = u * float(torch.tensor(lr, dtype=leaf.dtype))
            u = u * leaf.square().mean().sqrt().clamp_min(
                ADAFACTOR_MIN_SCALE)
            leaf.sub_(u)
        self.count += 1


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place: when the global norm is at
    least ``max_norm`` each gradient becomes ``g / norm * max_norm``
    (no epsilon, unlike ``clip_grad_norm_``). The norm is taken in f32."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
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
    mean in each param's dtype."""
    opt = optimizer or AdamW(1e-3)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_and_grads(params, batch, leaves):
        loss = loss_fn(params, batch, cfg, attn_fn, exit_layer, exit_weight)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def train_step(params, opt_state: Union[OptState, AdafactorState],
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
        opt_state.apply(grads)
        return params, opt_state, loss

    return train_step, opt.init


def train_tokens_per_sec(b: int = 8, t: int = 2048, iters: int = 3,
                         steps_short: int = 2, steps_long: int = 12,
                         cfg: Optional[ModelConfig] = None,
                         device="cuda") -> dict:
    """Full-model training throughput: tokens/s and achieved model
    TFLOP/s of chained train steps (gradient and ``default_optimizer()``
    update, in place) on a GPT-class block stack. Seconds per step come
    from ``chain_seconds_per_step``: the device-busy time of the long
    chain on the card, the marginal rate between the two chain lengths
    without one. FLOPs per token: 6 N for the matrix products forward
    and backward plus 6 * n_layers * t * d_model for causal attention,
    an estimate by design. Attention is ``flash_attention``: its kernels
    on the card, their plain versions on the CPU."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(vocab=8192, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_layers=8, d_ff=8192,
                             max_seq=t, use_rope=True, remat=True,
                             remat_policy="dots", scan_layers=True,
                             scan_unroll=8)
    params = init_params(cfg, 0, device=dev)
    train_step, opt_init = make_train_step(
        cfg, optimizer=default_optimizer(), attn_fn=flash_attention)
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
            "shape": f"b{b} t{t} L{cfg.n_layers} d{cfg.d_model} flash"}
