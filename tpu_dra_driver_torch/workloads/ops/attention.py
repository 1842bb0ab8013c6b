"""Plain PyTorch attention: the oracle the prefill path runs.

Port of ``attention_reference`` from
:mod:`tpu_dra_driver.workloads.ops.attention`. The flash-attention
kernels of that module (forward and backward) belong to the training
slice and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None,
                        row_offset: int = 0,
                        prefix: Optional[int] = None) -> torch.Tensor:
    """Oracle attention. q: [b, h, t, d], k/v: [b, h_kv, tkv, d] with
    h % h_kv == 0 (GQA: kv heads repeat over query groups).
    ``window`` (causal only): row r sees cols (r-window, r].
    ``row_offset`` (causal only): q rows sit at global positions
    [row_offset, row_offset + t). ``prefix`` (causal only): cols <
    prefix are visible to every row. A row with an empty band gives 0,
    not softmax's uniform mean."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if row_offset and (not causal or row_offset < 0):
        raise ValueError("row_offset requires causal=True and >= 0")
    if prefix is not None and (not causal or prefix < 0):
        raise ValueError("prefix requires causal=True and >= 0")
    if prefix is not None and window is not None:
        raise ValueError("prefix and window are mutually exclusive")
    *_, t, d = q.shape
    tkv = k.shape[2]
    h, h_kv = q.shape[1], k.shape[1]
    if h != h_kv:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    mask = None
    if causal:
        rows = torch.arange(t, device=q.device)[:, None] + row_offset
        cols = torch.arange(tkv, device=q.device)[None, :]
        mask = rows >= cols
        if window is not None:
            mask = mask & (rows - cols < window)
        if prefix is not None:
            mask = mask | (cols < prefix)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if mask is not None:
        probs = torch.where(mask.any(-1)[:, None], probs,
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
