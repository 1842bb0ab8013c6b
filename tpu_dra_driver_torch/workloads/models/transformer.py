"""The flagship transformer LM: config, parameters, the layers, the
training forward and loss, the optimizer and the train step.

Port of :mod:`tpu_dra_driver.workloads.models.transformer`. Params are a
plain dict with the reference's keys and shapes, so a JAX pytree
converts one to one (:func:`..convert.params_from_jax`). The MoE layers,
``default_optimizer(kind="adafactor")`` and ``train_tokens_per_sec``
are not ported yet.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import (
    QTensor, embed_lookup, lm_head, mm,
)
from tpu_dra_driver_torch.workloads.ops.attention import attention_reference


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
    ``pos0`` is a scalar start position or a [b] tensor of per-sequence
    positions (ragged continuous-batching decode)."""
    b, h, t, hd = x.shape
    dev = x.device
    half = torch.arange(0, hd // 2, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / (theta ** (half / (hd // 2)))
    p0 = torch.as_tensor(pos0, device=dev).float()
    steps = torch.arange(t, dtype=torch.float32, device=dev)
    if p0.ndim == 1:                       # per-sequence positions [b]
        ang = (p0[:, None] + steps)[:, :, None] * inv_freq   # [b,t,hd/2]
        cos = torch.cos(ang)[:, None]                        # [b,1,t,hd/2]
        sin = torch.sin(ang)[:, None]
    else:
        ang = (p0 + steps)[:, None] * inv_freq               # [t,hd/2]
        cos = torch.cos(ang)[None, None]
        sin = torch.sin(ang)[None, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return mm(F.gelu(mm(x, layer["w_up"]), approximate="tanh"),
              layer["w_down"])


def _ffn(xn2: torch.Tensor, layer: Params, cfg: ModelConfig) -> torch.Tensor:
    """The block's FFN half. Only the dense MLP is ported."""
    if "moe_up" in layer or cfg.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet")
    return _mlp(xn2, layer)


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


# the outputs of the un-batched projections, which is what JAX's
# dots_with_no_batch_dims_saveable keeps (batched products, as in the
# attention oracle, are aten.bmm and are recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


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
    if isinstance(node, dict):
        return [x for v in node.values() for x in _param_leaves(v)]
    if isinstance(node, list):
        return [x for v in node for x in _param_leaves(v)]
    return [node]


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


class OptState:
    """The optimizer's state over one params tree: ``torch.optim.AdamW``
    over its leaves (moments in each leaf's dtype, as optax keeps them),
    a ``LambdaLR`` that sets step k's rate to ``schedule(k)``, and the
    clip norm. Creating it sets ``requires_grad`` on every leaf."""

    def __init__(self, spec: AdamW, params: Params):
        self.leaves = _param_leaves(params)
        for leaf in self.leaves:
            if isinstance(leaf, QTensor) or not leaf.is_floating_point():
                raise ValueError("training needs floating-point params "
                                 "(quantized params are inference-only)")
            leaf.requires_grad_(True)
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
                      kind: str = "adamw") -> AdamW:
    """The reference's training recipe: global-norm clipping, then AdamW
    (weight decay 0.1 unless given) on a linear-warmup cosine-decay
    schedule from 0 to ``lr`` and down to ``0.1 * lr`` at
    ``total_steps``. With the default warmup the first step's rate is 0,
    so it leaves the params unchanged."""
    if kind == "adafactor":
        raise NotImplementedError("default_optimizer(kind='adafactor') is "
                                  "not ported yet")
    if kind != "adamw":
        raise ValueError(f"unknown optimizer kind {kind!r} "
                         f"(adamw | adafactor)")
    schedule = warmup_cosine_decay(lr, warmup_steps, total_steps, lr * 0.1)
    return AdamW(learning_rate=schedule,
                 weight_decay=0.1 if weight_decay is None else weight_decay,
                 clip_norm=clip_norm)


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
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

    def train_step(params, opt_state: OptState, batch):
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
