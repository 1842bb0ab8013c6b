"""Int8 weight-only quantization for the inference path.

Port of :mod:`tpu_dra_driver.workloads.models.quantize`: symmetric
per-channel int8 over the contraction axis of every matmul weight
(scale applied after the product), the embedding table quantized per
row (which serves both the lookup and the tied ``lm_head``).
Quantized params keep the fp params' dict structure, with each selected
weight replaced by a :class:`QTensor`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Union

import torch


@dataclass(frozen=True)
class QTensor:
    """Symmetric int8 weight + fp32 per-channel scale. ``axis`` is the
    reduced (quantization) axis, stored negative so stacked [L, ...]
    layers keep its meaning; ``s`` has ``q``'s shape minus that axis."""

    q: torch.Tensor       # int8, same shape as the fp weight
    s: torch.Tensor       # fp32 scale, shape = q.shape minus `axis`
    axis: int = -2

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.s.numel() * 4

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        s = self.s.unsqueeze(self.axis)
        return (self.q.float() * s).to(dtype)


def quantize(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Symmetric absmax int8 quantization, one scale per channel along
    every axis except ``axis``."""
    axis = axis % w.ndim
    w32 = w.float()
    absmax = w32.abs().amax(dim=axis)
    s = absmax.clamp_min(1e-12) / 127.0
    q = torch.round(w32 / s.unsqueeze(axis)).to(torch.int8)
    return QTensor(q=q, s=s, axis=axis - w.ndim)


def block_scales(w: QTensor, dim: int, index: int, n: int) -> QTensor:
    """``w`` whose codes are block ``index`` of ``n`` along ``dim`` of a
    larger weight and whose scales are still the whole weight's (as a
    sharding that splits the codes by the weight's rule and replicates
    the scales leaves them), with the scales narrowed to the codes'
    block. A block along the quantized axis keeps every scale: each
    scale covers the whole contraction, and the rank's partial product
    takes it as the whole product does."""
    ndim = w.q.dim()
    dim, axis = dim % ndim, w.axis % ndim
    if n == 1 or dim == axis:
        return w
    sdim = dim if dim < axis else dim - 1
    size = w.s.shape[sdim] // n
    return QTensor(q=w.q, s=w.s.narrow(sdim, index * size, size),
                   axis=w.axis)


# weight names quantized over the matmul contraction axis (-2); the MoE
# router stays fp (tiny, and its rounding flips discrete expert choices)
_MATMUL_KEYS = ("wqkv", "wo", "w_up", "w_down", "moe_up", "moe_down")


def quantize_params(params: Dict, include_embed: bool = True) -> Dict:
    """fp params → same-structure dict with int8 :class:`QTensor`
    weights (norm gains, pos_embed and the router stay fp)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                out[k] = ([walk(x) for x in v] if isinstance(v, list)
                          else walk(v))
            elif k in _MATMUL_KEYS:
                out[k] = quantize(v, axis=-2)
            elif k == "embed" and include_embed:
                out[k] = quantize(v, axis=-1)       # per vocab row
            else:
                out[k] = v
        return out

    return walk(params)


def ffn_weights(layer: Dict, dtype=torch.bfloat16) -> Dict:
    """The layer with its int8 MoE banks (``moe_up``, ``moe_down``)
    dequantized to ``dtype`` for the einsum paths. The dense leaves stay
    quantized (:func:`mm` takes them) and the router is never quantized
    (:data:`_MATMUL_KEYS`)."""
    if not any(isinstance(layer.get(k), QTensor)
               for k in ("moe_up", "moe_down")):
        return layer
    out = dict(layer)
    for k in ("moe_up", "moe_down"):
        if isinstance(out.get(k), QTensor):
            out[k] = out[k].dequant(dtype)
    return out


def _leaves(node) -> Iterator[Union[torch.Tensor, QTensor]]:
    """Tensor and :class:`QTensor` leaves of a dict/list params tree."""
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def is_quantized(params: Dict) -> bool:
    return any(isinstance(leaf, QTensor) for leaf in _leaves(params))


def param_bytes(params: Dict) -> int:
    """Total parameter storage in bytes (QTensor-aware): the bytes a
    decode step streams."""
    return sum(leaf.nbytes if isinstance(leaf, QTensor)
               else leaf.numel() * leaf.element_size()
               for leaf in _leaves(params))


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for fp or quantized ``w``. Quantized: the int8 codes
    widen to x's dtype and the fp32 per-output-channel scale multiplies
    the product at full precision before the cast back."""
    if isinstance(w, QTensor):
        if w.axis != -2:
            raise ValueError(
                f"mm() needs contraction-axis scales (axis=-2), got {w.axis}")
        return ((x @ w.q.to(x.dtype)) * w.s).to(x.dtype)
    return x @ w


def embed_lookup(embed, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding-table row gather for fp or row-quantized tables. The fp
    table returns its own dtype; the quantized one ``dtype`` (bf16 by
    default)."""
    if isinstance(embed, QTensor):
        if embed.axis != -1:
            raise ValueError(
                f"embed_lookup() needs per-row scales (axis=-1), "
                f"got {embed.axis}")
        rows = embed.q[tokens].float()
        return (rows * embed.s[tokens][..., None]).to(
            dtype or torch.bfloat16)
    return embed[tokens]


def lm_head(x: torch.Tensor, embed) -> torch.Tensor:
    """Tied output projection ``x @ embed.T`` → fp32 logits. For the
    row-quantized table the row scale becomes the logit column scale."""
    if isinstance(embed, QTensor):
        if embed.axis != -1:
            raise ValueError(
                f"lm_head() needs per-row scales (axis=-1), "
                f"got {embed.axis}")
        logits = x @ embed.q.T.to(x.dtype)
        return logits.float() * embed.s
    return (x @ embed.T).float()
