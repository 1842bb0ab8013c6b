"""The work that the rooflines and MFU divide by: operations and bytes
computed from the shapes and masks a cell ran, whatever kernel did the
work, and the published peaks of the card.

Conventions. A multiply-add is two operations. Attention counts the
(row, column) pairs its mask leaves visible, never the square it could
have computed. The flash backward counts five products a pair (S again,
dP, dV, dK, dQ), the least a backward that keeps no P computes, which is
2.5 times the forward. Model operations count each product once, with no
recomputation. Bytes count each input read once and each output written
once, in the types the cell serves.
"""

from __future__ import annotations

from typing import Iterable, Optional

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def band_pairs(t: int, window: int = 0) -> int:
    """Visible (row, column) pairs of a causal [t, t] mask; with a window
    w, row r sees the columns (r - w, r]: min(r + 1, w) of them."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def flash_fwd_flops(batch: int, heads: int, t: int, head_dim: int,
                    window: int = 0) -> float:
    """Q K^T and P V over the visible pairs."""
    return 4.0 * batch * heads * head_dim * band_pairs(t, window)


def flash_bwd_flops(batch: int, heads: int, t: int, head_dim: int,
                    window: int = 0) -> float:
    """Five products over the visible pairs."""
    return 2.5 * flash_fwd_flops(batch, heads, t, head_dim, window)


def matmul_params(d_model: int, n_heads: int, n_kv_heads: int, d_ff: int,
                  n_layers: int, vocab: int) -> int:
    """Weights that a token multiplies: every layer's projections and the
    tied head (the embedding lookup multiplies nothing)."""
    kv_d = d_model // n_heads * n_kv_heads
    per_layer = d_model * (d_model + 2 * kv_d) + d_model * d_model \
        + 2 * d_model * d_ff
    return n_layers * per_layer + vocab * d_model


def train_step_flops(tokens: int, seq: int, d_model: int, n_heads: int,
                     n_kv_heads: int, d_ff: int, n_layers: int, vocab: int,
                     window: int = 0) -> float:
    """One training step of ``tokens`` tokens in rows of ``seq``: six
    operations a weight a token (forward, and a backward of twice the
    forward), and attention's forward and a backward of twice it over
    the band. No recomputation is counted."""
    head_dim = d_model // n_heads
    rows = tokens // seq
    dense = 6.0 * matmul_params(d_model, n_heads, n_kv_heads, d_ff,
                                n_layers, vocab) * tokens
    attn = 3.0 * n_layers * flash_fwd_flops(rows, n_heads, seq, head_dim,
                                            window)
    return dense + attn


def decode_token_flops(context: int, d_model: int, n_heads: int,
                       n_kv_heads: int, d_ff: int, n_layers: int,
                       vocab: int) -> float:
    """One generated token at a row whose attention reads ``context``
    keys: two operations a weight, and Q K^T and P V over those keys in
    every layer."""
    return 2.0 * matmul_params(d_model, n_heads, n_kv_heads, d_ff, n_layers,
                               vocab) + 4.0 * n_layers * d_model * context


def decode_attn_bytes(contexts: Iterable[int], n_heads: int, n_kv_heads: int,
                      head_dim: int, n_layers: int,
                      elem_bytes: int = 2) -> float:
    """Bytes one decode read of every layer needs, summed over rows: each
    row's live K and V at its length, its q in and its output out."""
    total = 0.0
    per_key = 2 * n_kv_heads * head_dim * elem_bytes
    q_out = 2 * n_heads * head_dim * elem_bytes
    for ctx in contexts:
        total += ctx * per_key + q_out
    return total * n_layers


def share(work: float, peak: float, seconds: float) -> Optional[float]:
    """Percent of ``peak`` that ``work`` in ``seconds`` reaches, None
    where nothing was timed."""
    if not seconds or seconds <= 0 or work <= 0:
        return None
    return 100.0 * work / peak / seconds
