"""The flagship transformer LM: config, parameters and the layer pieces
the serving path runs.

Port of :mod:`tpu_dra_driver.workloads.models.transformer`. Params are a
plain dict with the reference's keys and shapes, so a JAX pytree
converts one to one (:func:`..convert.params_from_jax`). The training
forward, the loss and the MoE layers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import torch
import torch.nn.functional as F

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import QTensor, mm


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
    """Inverse of :func:`stack_layer_params` (views, no copies)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params
    n = _first_leaf(layers).shape[0]
    out = dict(params)
    out["layers"] = [_tree_map(lambda a, i=i: a[i], layers)
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
