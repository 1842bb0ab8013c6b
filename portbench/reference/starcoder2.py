"""Plain float32 reference of the decoder that the benchmark's StarCoder2
configurations run.

It is written from the configuration, not from the program under test,
and imports nothing of it. It computes what the port's block computes
for these configurations, departures from the published StarCoder2
included (``configs/*.json`` lists them):

- RMSNorm with a gain and eps 1e-6, where StarCoder2 has LayerNorm with
  bias; no bias on any linear layer;
- grouped-query attention, rotary embedding with base 10,000 on the
  split halves of each head, causal, optionally a sliding window: row r
  sees the columns (r - window, r];
- an MLP of ``gelu(x W_up, tanh approximation) W_down``;
- the output head tied to the embedding.

Parameters use the same layout the benchmark makes them in: ``embed``
[vocab, d], ``final_norm.g`` [d], and per layer ``ln1.g``, ``wqkv``
[d, d + 2 kv_d] (q, then k, then v columns), ``wo`` [d, d], ``ln2.g``,
``w_up`` [d, d_ff], ``w_down`` [d_ff, d].

Every matrix product runs in float32 with TF32 off (:func:`strict_f32`),
unless ``precision`` asks for the lower-precision control (``"fp8"``,
as float8 training computes a product: both operands in e4m3 forward,
the incoming gradient in e5m2 backward, each under a per-tensor scale;
the parameters and the optimizer stay in float32). Attention is
computed in blocks of query rows, and training checkpoints each layer,
so that the reference fits beside nothing else on one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NORM_EPS = 1e-6
ROPE_BASE = 10000.0
NEG_INF = float("-inf")


@dataclass(frozen=True)
class Shape:
    """The sizes the reference needs; ``window`` 0 means none."""

    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    n_layers: int
    d_ff: int
    window: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def strict_f32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` under a per-tensor absmax
    scale, back in x's dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w as float8 training computes it: e4m3 operands forward, and
    the incoming gradient in e5m2 for both backward products."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _quantize(x, torch.float8_e4m3fn)
        wq = _quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _quantize(g, torch.float8_e5m2)
        dx = gq @ wq.transpose(-1, -2)
        dw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(x, w)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + NORM_EPS) * g


def rope(x: torch.Tensor, start: int) -> torch.Tensor:
    """Rotary embedding of [b, h, t, hd] at positions start..start+t-1,
    rotating the first half of each head against the second."""
    hd = x.shape[-1]
    half = hd // 2
    inv_freq = 1.0 / (ROPE_BASE ** (torch.arange(half, dtype=torch.float64,
                                                 device=x.device) / half))
    pos = torch.arange(start, start + x.shape[2], dtype=torch.float64,
                       device=x.device)
    ang = (pos[:, None] * inv_freq[None, :]).to(x.dtype)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, q_block: int = 1024) -> torch.Tensor:
    """Causal attention of q [b, h, t, hd] over k, v [b, h_kv, t, hd],
    in blocks of ``q_block`` query rows, each against only the keys its
    band can reach."""
    t = q.shape[2]
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = []
    for r0 in range(0, t, q_block):
        r1 = min(t, r0 + q_block)
        c0 = max(0, r0 - window + 1) if window > 0 else 0
        args = (q[:, :, r0:r1], k[:, :, c0:r1], v[:, :, c0:r1], r0, c0,
                window)
        # recomputed in the backward, so that one block's scores live
        # at a time
        out.append(checkpoint(_attention_rows, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _attention_rows(*args))
    return torch.cat(out, dim=2)


def _attention_rows(q, k, v, r0: int, c0: int, window: int) -> torch.Tensor:
    """Query rows r0.. against key columns c0.. under the causal band."""
    rows = torch.arange(r0, r0 + q.shape[2], device=q.device)[:, None]
    cols = torch.arange(c0, c0 + k.shape[2], device=q.device)[None, :]
    visible = cols <= rows
    if window > 0:
        visible = visible & (rows - cols < window)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~visible, NEG_INF)
    return torch.softmax(s, dim=-1) @ v


def block(x: torch.Tensor, layer: Dict, shape: Shape,
          precision: str = "f32") -> torch.Tensor:
    """One decoder layer on x [b, t, d] at positions 0..t-1."""
    b, t, d = x.shape
    hd, h, h_kv = shape.head_dim, shape.n_heads, shape.n_kv_heads
    qkv = matmul(rmsnorm(x, layer["ln1"]["g"]), layer["wqkv"], precision)
    q, k, v = qkv.split([h * hd, h_kv * hd, h_kv * hd], dim=-1)
    q = rope(q.reshape(b, t, h, hd).transpose(1, 2), 0)
    k = rope(k.reshape(b, t, h_kv, hd).transpose(1, 2), 0)
    v = v.reshape(b, t, h_kv, hd).transpose(1, 2)
    att = attention(q, k, v, shape.window)
    att = att.transpose(1, 2).reshape(b, t, h * hd)
    x = x + matmul(att, layer["wo"], precision)
    up = matmul(rmsnorm(x, layer["ln2"]["g"]), layer["w_up"], precision)
    return x + matmul(F.gelu(up, approximate="tanh"), layer["w_down"],
                      precision)


def hidden(params: Dict, tokens: torch.Tensor, shape: Shape,
           precision: str = "f32", remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states [b, t, d] of tokens [b, t]. With
    ``remat`` each layer is recomputed in the backward."""
    x = params["embed"][tokens.long()]
    for layer in params["layers"]:
        if remat:
            x = checkpoint(block, x, layer, shape, precision,
                           use_reentrant=False)
        else:
            x = block(x, layer, shape, precision)
    return rmsnorm(x, params["final_norm"]["g"])


def logits(params: Dict, tokens: torch.Tensor, shape: Shape,
           precision: str = "f32") -> torch.Tensor:
    """Logits [b, t, vocab] of tokens [b, t] (no gradient)."""
    with torch.no_grad():
        x = hidden(params, tokens, shape, precision)
        return matmul(x, params["embed"].T, precision)


def nll_sum(params: Dict, tokens: torch.Tensor, targets: torch.Tensor,
            shape: Shape, precision: str = "f32",
            head_rows: int = 1024) -> torch.Tensor:
    """Summed next-token NLL of one batch, the head and its softmax taken
    over blocks of ``head_rows`` positions (each block checkpointed, so
    its logits are not kept for the backward)."""
    x = hidden(params, tokens, shape, precision, remat=True)
    x = x.reshape(-1, x.shape[-1])
    tg = targets.reshape(-1).long()

    def head(xs, ts, embed):
        lg = matmul(xs, embed.T, precision)
        return F.cross_entropy(lg, ts, reduction="sum")

    total = x.new_zeros(())
    for r0 in range(0, x.shape[0], head_rows):
        total = total + checkpoint(head, x[r0:r0 + head_rows],
                                   tg[r0:r0 + head_rows], params["embed"],
                                   use_reentrant=False)
    return total


def leaves(params: Dict) -> List[torch.Tensor]:
    """The parameters in a fixed order: embed, then each layer's, then the
    final norm's gain."""
    out = [params["embed"]]
    for layer in params["layers"]:
        out += [layer["ln1"]["g"], layer["wqkv"], layer["wo"],
                layer["ln2"]["g"], layer["w_up"], layer["w_down"]]
    return out + [params["final_norm"]["g"]]


def leaf_names(n_layers: int) -> List[str]:
    names = ["embed"]
    for i in range(n_layers):
        names += [f"layers.{i}.{k}" for k in
                  ("ln1.g", "wqkv", "wo", "ln2.g", "w_up", "w_down")]
    return names + ["final_norm.g"]


@dataclass(frozen=True)
class AdamW:
    """optax.adamw after optax.clip_by_global_norm: decoupled weight decay
    on every leaf, a constant rate."""

    lr: float
    weight_decay: float
    clip_norm: Optional[float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class TrainReference:
    """Training in float32 (or the control's precision) from given
    params: each :meth:`step` takes a list of [rows, t + 1] token blocks
    that together make the batch, and returns the mean NLL. It keeps the
    norm of each leaf's first-step gradient, as the optimizer gets it."""

    def __init__(self, params: Dict, shape: Shape, opt: AdamW,
                 precision: str = "f32"):
        self.params, self.shape, self.opt = params, shape, opt
        self.precision = precision
        self.leaves = leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0
        self.first_grad_norms: Optional[List[float]] = None

    def step(self, blocks: Sequence[torch.Tensor]) -> float:
        n_tokens = sum(bl[:, 1:].numel() for bl in blocks)
        total = 0.0
        for bl in blocks:
            loss = nll_sum(self.params, bl[:, :-1], bl[:, 1:], self.shape,
                           self.precision) / n_tokens
            loss.backward()
            total += float(loss.detach())
        grads = [p.grad for p in self.leaves]
        o = self.opt
        with torch.no_grad():
            if o.clip_norm is not None:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                if norm >= o.clip_norm:
                    for g in grads:
                        g.mul_(o.clip_norm / norm)
            if self.first_grad_norms is None:
                self.first_grad_norms = [float(torch.linalg.vector_norm(g))
                                         for g in grads]
            self.count += 1
            c1 = 1.0 - o.b1 ** self.count
            c2 = 1.0 - o.b2 ** self.count
            for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
                m.mul_(o.b1).add_(g, alpha=1.0 - o.b1)
                v.mul_(o.b2).addcmul_(g, g, value=1.0 - o.b2)
                upd = (m / c1) / ((v / c2).sqrt() + o.eps) \
                    + o.weight_decay * p
                p.sub_(o.lr * upd)
                p.grad = None
        return total
