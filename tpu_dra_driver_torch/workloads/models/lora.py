"""LoRA: low-rank adapter fine-tuning over the flagship transformer.

Port of :mod:`tpu_dra_driver.workloads.models.lora`. Adapters are a
sparse mirror of the params tree holding ``{"a": [.., in, r], "b":
[.., r, out]}`` pairs at the chosen weight leaves (lists of layers or
stacked ``[L, ...]`` layers alike); :func:`merge_lora` rebuilds a full
params tree as ``W + scale * (a @ b)`` and the ordinary
``forward``/``loss_fn`` run unchanged, so LoRA composes with everything
the base model does (remat, scan_layers, GQA, MoE, flash attention).
Gradients reach the adapters only, and the optimizer's state lives on
them alone.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from tpu_dra_driver_torch.workloads.models.quantize import _leaves
from tpu_dra_driver_torch.workloads.models.transformer import (
    AdamW,
    ModelConfig,
    Params,
    loss_fn,
    param_count,
)

# weight leaves that take adapters by default: the attention projections
# (the standard LoRA target set; w_up/w_down opt-in via `targets`)
DEFAULT_TARGETS = ("wqkv", "wo")


def init_lora(params: Params, rank: int, key: Union[int, torch.Generator],
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              dtype=torch.bfloat16) -> Dict:
    """Adapter tree mirroring ``params``' structure at the targeted 2-D
    (or stacked [L, in, out]) weight leaves: ``{"a": N(0, 0.02) [.., in,
    r], "b": zeros [.., r, out]}``, on each weight's device; b = 0 makes
    step 0 the base model exactly. ``key`` is a seed or a CPU
    :class:`torch.Generator`; draws are made on the CPU in fp32, as
    :func:`..transformer.init_params` makes them."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    gen = key if isinstance(key, torch.Generator) \
        else torch.Generator().manual_seed(int(key))

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if not isinstance(node, dict):
            return None
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                sub = walk(v)
                if sub is not None and any(True for _ in _leaves(sub)):
                    out[k] = sub
            elif k in targets and isinstance(v, torch.Tensor) \
                    and v.ndim >= 2:
                lead = tuple(v.shape[:-2])
                a = 0.02 * torch.randn((*lead, v.shape[-2], rank),
                                       generator=gen, dtype=torch.float32)
                out[k] = {"a": a.to(device=v.device, dtype=dtype),
                          "b": torch.zeros((*lead, rank, v.shape[-1]),
                                           dtype=dtype, device=v.device)}
        return out

    adapters = walk(params)
    if not any(True for _ in _leaves(adapters)):
        raise ValueError(f"no adapter targets {targets} found in params")
    return adapters


def merge_lora(params: Params, adapters: Dict,
               scale: float = 1.0) -> Params:
    """Full params tree with ``W + scale * (a @ b)`` at every adapted
    leaf, computed in f32 and cast back to W's dtype (other leaves pass
    through by reference)."""

    def walk(p, ad):
        if ad is None:
            return p
        if isinstance(p, list):
            return [walk(x, ad[i] if isinstance(ad, list) else None)
                    for i, x in enumerate(p)]
        if not isinstance(p, dict):
            return p
        out = {}
        for k, v in p.items():
            sub = ad.get(k) if isinstance(ad, dict) else None
            if (isinstance(sub, dict) and set(sub) == {"a", "b"}
                    and not isinstance(sub["a"], dict)):
                delta = sub["a"].float() @ sub["b"].float()
                out[k] = (v.float() + scale * delta).to(v.dtype)
            elif isinstance(v, (dict, list)):
                out[k] = walk(v, sub)
            else:
                out[k] = v
        return out

    return walk(params, adapters)


def make_lora_train_step(cfg: ModelConfig, rank_scale: float = 1.0,
                         optimizer=None, attn_fn=None):
    """Returns (train_step, init_opt_state). ``train_step(base_params,
    adapters, opt_state, batch) -> (adapters, opt_state, loss)`` updates
    the adapters IN PLACE (the reference returns new arrays), the loss
    detached; ``init_opt_state(adapters)`` makes the adapters' leaves,
    and only those, require grad, so the base is never touched. The
    default optimizer is ``optax.adamw(1e-3)``: :class:`AdamW`."""
    opt = optimizer or AdamW(1e-3)

    def train_step(base_params, adapters, opt_state, batch):
        merged = merge_lora(base_params, adapters, rank_scale)
        loss = loss_fn(merged, batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, opt_state.leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
        opt_state.apply(grads)
        return adapters, opt_state, loss.detach()

    return train_step, opt.init


def lora_param_counts(params: Params, adapters: Dict) -> Dict[str, int]:
    return {"base": param_count(params),
            "adapters": sum(x.numel() for x in _leaves(adapters))}
