"""Attention: the plain oracle and flash attention for training.

Port of :mod:`tpu_dra_driver.workloads.ops.attention`:

- ``attention_reference``: plain causal attention, the oracle (and the
  attention the prefill path runs).
- ``flash_attention`` / ``flash_attention_with_lse``: one
  :class:`torch.autograd.Function` whose forward is the kernel B1 and
  whose backward is the kernels B2 (dq) and B3 (dk, dv), all written by
  hand in CUDA C++ in ``csrc/flash_attention.cu``; they replace the
  Pallas kernels ``_flash_kernel``, ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``.
- ``merge_partials``: the exact merge of two partial attentions.
- the benchmarks ``flash_attention_tflops``,
  ``flash_attention_train_tflops`` and their long-context, sliding-window
  counterparts, with the reference's defaults, FLOP accounting and
  result keys.

The kernel wrappers :func:`flash_forward`, :func:`flash_backward_dq` and
:func:`flash_backward_dkv` dispatch on the device of their inputs: CPU
tensors take the plain versions (:func:`_flash_forward_plain`,
:func:`_flash_backward_dq_plain`, :func:`_flash_backward_dkv_plain`),
CUDA tensors launch the kernel or raise.
Each launch adds one to the wrapper's ``launches``.

One deliberate difference from the reference: on a row whose band is
empty (``window`` with ``row_offset``) the reference's Pallas backward
rebuilds P as ``exp2(NEG_INF - lse * LOG2E)``, which is 1 there, and
gives nonzero gradients. Here P is masked explicitly, so such rows get
gradient 0, as the gradient of ``attention_reference`` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.ops import _build
from tpu_dra_driver_torch.workloads.utils.timing import (
    chain_seconds_per_step, chain_seconds_per_step_runs,
)

NEG_INF = -1e30
# scores are kept in base 2 inside the kernels (exp2 with log2(e) folded
# into the scale); the lse at the API boundary is in natural log
LOG2E = 1.4426950408889634
_SUPER_KV = 4096

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


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
    _check_mask_args(causal, window, row_offset, prefix)
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
        mask = _visible(t, tkv, causal, window, row_offset, prefix, q.device)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if mask is not None:
        probs = torch.where(mask.any(-1)[:, None], probs,
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check_mask_args(causal, window, row_offset, prefix) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if row_offset and (not causal or row_offset < 0):
        raise ValueError("row_offset requires causal=True and >= 0")
    if prefix is not None and (not causal or prefix < 0):
        raise ValueError("prefix requires causal=True and >= 0")
    if prefix is not None and window is not None:
        raise ValueError("prefix and window are mutually exclusive")


def _visible(t: int, tkv: int, causal: bool, window, row_offset: int,
             prefix, device) -> torch.Tensor:
    """[t, tkv] bool: which (row, col) pairs the mask leaves visible."""
    rows = torch.arange(t, device=device)[:, None] + row_offset
    cols = torch.arange(tkv, device=device)[None, :]
    if not causal:
        return torch.ones((t, tkv), dtype=torch.bool, device=device)
    mask = rows >= cols
    if window is not None:
        mask = mask & (rows - cols < window)
    if prefix is not None:
        mask = mask | (cols < prefix)
    return mask


def _gqa_group(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int]:
    h, h_kv = q.shape[1], k.shape[1]
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {h_kv}")
    return h_kv, h // h_kv


def _fit_block(req: int, t: int) -> int:
    """Largest divisor of t not exceeding the requested block; raises for
    a t whose only small divisors are degenerate, as the reference does."""
    blk = min(req, t)
    while t % blk:
        blk -= 1
    if blk < min(128, t, req):
        raise ValueError(
            f"seq len {t} has no block divisor >= 128 (got {blk}); pad the "
            f"sequence to a multiple of 128 for the MXU")
    return blk


def _check_flash_args(q, k, v, causal, block_q, block_kv, window,
                      row_offset, prefix) -> None:
    """The reference ``_flash_forward``'s argument checks, in its order.
    The blocks are only checked: the kernels choose their own tiles."""
    t, tkv = q.shape[2], k.shape[2]
    if causal and row_offset == 0 and tkv != t:
        raise ValueError(
            f"causal flash attention needs t_q == t_kv (got {t} vs {tkv}); "
            f"chunked-causal takes row_offset (see ring_attention)")
    _check_mask_args(causal, window, row_offset, prefix)
    _gqa_group(q, k)
    super_kv = _fit_block(
        _SUPER_KV if window is None else max(block_kv, _SUPER_KV), tkv)
    _fit_block(block_q, t)
    _fit_block(block_kv, super_kv)
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")


# ------------------------------------------------------- plain versions

def _grouped(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """[b, h, t, d] → [b, h_kv, group, t, d] (a view)."""
    b, h, t, d = x.shape
    return x.reshape(b, h_kv, h // h_kv, t, d)


def _scores2(q, k, causal, window, row_offset, prefix):
    """Base-2 f32 scores [b, h_kv, group, t, tkv] and the visibility mask
    [t, tkv], as the kernels form them."""
    h_kv = k.shape[1]
    d = q.shape[-1]
    s = torch.einsum("bkgtd,bksd->bkgts", _grouped(q, h_kv).float(),
                     k.float())
    s = s * ((1.0 / math.sqrt(d)) * LOG2E)
    vis = _visible(q.shape[2], k.shape[2], causal, window, row_offset,
                   prefix, q.device)
    return s, vis


def _flash_forward_plain(q, k, v, causal=True, window=None, row_offset=0,
                         prefix=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1's function in plain PyTorch with its numerics: f32 base-2
    scores, masked scores filled below the m sentinel, P rounded to V's
    dtype for P.V, ``l`` clamped at 1e-30. Returns (out [b, h, t, d] in
    q's dtype, lse [b, h, t] f32). A row with an empty band gives out 0
    and lse (NEG_INF + log2(1e-30)) / LOG2E."""
    b, h, t, d = q.shape
    s, vis = _scores2(q, k, causal, window, row_offset, prefix)
    s = torch.where(vis, s, 2 * NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgts,bksd->bkgtd", p.to(v.dtype).float(),
                       v.float())
    out = (acc / l).to(q.dtype).reshape(b, h, t, d)
    lse = ((m + torch.log2(l)) / LOG2E).reshape(b, h, t)
    return out, lse


def _backward_terms(q, k, v, dout, lse, dd, causal, window, row_offset,
                    prefix):
    """(P, dS, dO) of the backward kernels' numerics, grouped
    [b, h_kv, group, ...] f32: P rebuilt from (q, k, lse) and set to 0
    wherever the mask hides a column, dS = P * (dP - D) rounded to the
    inputs' dtype."""
    b, h, t, _ = q.shape
    h_kv = k.shape[1]
    s, vis = _scores2(q, k, causal, window, row_offset, prefix)
    lse2 = (lse.float() * LOG2E).reshape(b, h_kv, h // h_kv, t, 1)
    p = torch.where(vis, torch.exp2(s - lse2), 0.0)
    do = _grouped(dout, h_kv).float()
    dp = torch.einsum("bkgtd,bksd->bkgts", do, v.float())
    ds = p * (dp - dd.float().reshape(b, h_kv, h // h_kv, t, 1))
    return p, ds.to(q.dtype).float(), do


def _grad_dtype(x: torch.Tensor, f32_out: bool) -> torch.dtype:
    return torch.float32 if f32_out else x.dtype


def _flash_backward_dq_plain(q, k, v, dout, lse, dd, causal=True,
                             window=None, row_offset=0, prefix=None,
                             f32_out=False):
    """Kernel B2 in plain PyTorch with its numerics
    (:func:`_backward_terms`): dq = dS . K / sqrt(d) in q's dtype, or in
    f32 with ``f32_out``."""
    _, ds, _ = _backward_terms(q, k, v, dout, lse, dd, causal, window,
                               row_offset, prefix)
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, k.float())
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (dq * scale).to(_grad_dtype(q, f32_out)).reshape(q.shape)


def _flash_backward_dkv_plain(q, k, v, dout, lse, dd, causal=True,
                              window=None, row_offset=0, prefix=None,
                              f32_out=False):
    """Kernel B3 in plain PyTorch with its numerics
    (:func:`_backward_terms`): dk = dS^T . Q / sqrt(d) and dv = P^T . dO,
    each summed over the GQA group, with P rounded to V's dtype; in K/V's
    dtype, or in f32 with ``f32_out``."""
    p, ds, do = _backward_terms(q, k, v, dout, lse, dd, causal, window,
                                row_offset, prefix)
    dk = torch.einsum("bkgts,bkgtd->bksd", ds,
                      _grouped(q, k.shape[1]).float())
    dv = torch.einsum("bkgts,bkgtd->bksd", p.to(v.dtype).float(), do)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return ((dk * scale).to(_grad_dtype(k, f32_out)),
            dv.to(_grad_dtype(v, f32_out)))


def _flash_backward_plain(q, k, v, dout, lse, dd, causal=True, window=None,
                          row_offset=0, prefix=None):
    """Kernels B2 and B3 in plain PyTorch. ``dd`` is D = rowsum(dO * O)
    - g_lse [b, h, t] f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    args = (q, k, v, dout, lse, dd, causal, window, row_offset, prefix)
    return (_flash_backward_dq_plain(*args),
            *_flash_backward_dkv_plain(*args))


# ------------------------------------------------------ kernel wrappers

def _on_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _kernel_checks(name: str, q, k, v, *others) -> None:
    tensors = (q, k, v) + others
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name} needs all inputs on the CPU or all on one "
                         f"CUDA device; got "
                         f"{[str(x.device) for x in tensors]}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}'s kernel takes q, k and v all bf16 or all "
                         f"f32; got {q.dtype}, {k.dtype}, {v.dtype}")
    check_head_dim(name, q.shape[-1])


def check_head_dim(name: str, d: int) -> None:
    """B1-B3's rule for the head dim, which needs no card: a multiple of
    16, at most ``_MAX_HEAD_DIM``; raises ``ValueError`` naming
    ``name``."""
    if d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{name}'s kernel takes a head dim that is a "
                         f"multiple of 16 and at most {_MAX_HEAD_DIM}; "
                         f"got {d}")


def _mask_ints(causal, window, row_offset, prefix):
    return (int(bool(causal)), int(window or 0), int(row_offset),
            int(prefix or 0))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str, lib) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()} "
            f"(cudaError {rc})")


def flash_forward(q, k, v, causal=True, window=None, row_offset=0,
                  prefix=None, with_lse=True):
    """Kernel B1: (out [b, h, t, d], lse [b, h, t] f32 or None when
    ``with_lse`` is False). CPU tensors take
    :func:`_flash_forward_plain`; CUDA tensors launch the kernel."""
    if _on_cpu(q, k, v):
        out, lse = _flash_forward_plain(q, k, v, causal, window,
                                        row_offset, prefix)
        return out, (lse if with_lse else None)
    _kernel_checks("flash_forward", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, t, d = q.shape
    h_kv, tkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_forward_launch(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, h_kv, t, tkv, d,
            *_mask_ints(causal, window, row_offset, prefix),
            _stream(q.device))
    _raise_on(rc, "flash_forward", lib)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def _backward_inputs(q, k, v, dout, lse, dd):
    _kernel_checks("flash backward", q, k, v, dout, lse, dd)
    if dout.dtype != q.dtype or lse.dtype != torch.float32 \
            or dd.dtype != torch.float32:
        raise ValueError(f"flash backward takes dO in q's dtype and lse, D "
                         f"in f32; got {dout.dtype}, {lse.dtype}, "
                         f"{dd.dtype}")
    return tuple(x.contiguous() for x in (q, k, v, dout, lse, dd))


def flash_backward_dq(q, k, v, dout, lse, dd, causal=True, window=None,
                      row_offset=0, prefix=None,
                      f32_out=False) -> torch.Tensor:
    """Kernel B2: dq [b, h, t, d] from (q, k, v, dO, lse, D), in q's
    dtype or, with ``f32_out``, in f32 (a sum of several calls' dq then
    rounds once). CPU tensors take :func:`_flash_backward_dq_plain`."""
    if _on_cpu(q, k, v, dout, lse, dd):
        return _flash_backward_dq_plain(q, k, v, dout, lse, dd, causal,
                                        window, row_offset, prefix, f32_out)
    q, k, v, dout, lse, dd = _backward_inputs(q, k, v, dout, lse, dd)
    b, h, t, d = q.shape
    h_kv, tkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, dtype=_grad_dtype(q, f32_out))
    if q.numel() == 0:
        return dq
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward_dq_launch(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), b, h, h_kv, t, tkv, d,
            *_mask_ints(causal, window, row_offset, prefix), int(f32_out),
            _stream(q.device))
    _raise_on(rc, "flash_backward_dq", lib)
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_dkv(q, k, v, dout, lse, dd, causal=True, window=None,
                       row_offset=0, prefix=None, f32_out=False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3: (dk, dv) [b, h_kv, tkv, d], each summed over its GQA
    group, in K/V's dtype or, with ``f32_out``, in f32. CPU tensors take
    :func:`_flash_backward_dkv_plain`."""
    if _on_cpu(q, k, v, dout, lse, dd):
        return _flash_backward_dkv_plain(q, k, v, dout, lse, dd, causal,
                                         window, row_offset, prefix,
                                         f32_out)
    q, k, v, dout, lse, dd = _backward_inputs(q, k, v, dout, lse, dd)
    b, h, t, d = q.shape
    h_kv, tkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, dtype=_grad_dtype(k, f32_out))
    dv = torch.empty_like(v, dtype=_grad_dtype(v, f32_out))
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward_dkv_launch(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, h_kv, t, tkv, d,
            *_mask_ints(causal, window, row_offset, prefix), int(f32_out),
            _stream(q.device))
    _raise_on(rc, "flash_backward_dkv", lib)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_forward_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        mask = [i, i, i, i]
        lib.flash_attention_forward_launch.argtypes = (
            [i, p, p, p, p, p] + [i] * 6 + mask + [p])
        lib.flash_attention_backward_dq_launch.argtypes = (
            [i, p, p, p, p, p, p, p] + [i] * 6 + mask + [i, p])
        lib.flash_attention_backward_dkv_launch.argtypes = (
            [i, p, p, p, p, p, p, p, p] + [i] * 6 + mask + [i, p])
        for fn in (lib.flash_attention_forward_launch,
                   lib.flash_attention_backward_dq_launch,
                   lib.flash_attention_backward_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


# ------------------------------------------------- the autograd Function

class _FlashAttention(torch.autograd.Function):
    """Forward: kernel B1 (saving q, k, v, out, lse). Backward: D =
    rowsum(dO * O) - g_lse in plain torch, then kernels B2 and B3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, row_offset, prefix, with_lse):
        need_lse = with_lse or any(ctx.needs_input_grad[:3])
        out, lse = flash_forward(q, k, v, causal, window, row_offset,
                                 prefix, with_lse=need_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, row_offset, prefix)
        if with_lse:
            return out, lse
        return out

    @staticmethod
    def backward(ctx, g_out, g_lse=None):
        q, k, v, out, lse = ctx.saved_tensors
        dd = (g_out.float() * out.float()).sum(dim=-1)
        if g_lse is not None:
            dd = dd - g_lse.float()
        g_out = g_out.to(q.dtype)
        dq = flash_backward_dq(q, k, v, g_out, lse, dd, *ctx.mask)
        dk, dv = flash_backward_dkv(q, k, v, g_out, lse, dd, *ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, window: Optional[int] = None,
                    row_offset: int = 0,
                    prefix: Optional[int] = None) -> torch.Tensor:
    """Blockwise flash attention. q: [b, h, t, d], k/v: [b, h_kv, tkv, d]
    → [b, h, t, d], differentiable in q, k and v. ``window``,
    ``row_offset`` and ``prefix`` are the masks of
    :func:`attention_reference`. ``block_q`` and ``block_kv`` are
    checked as the reference checks them (a sequence with no block
    divisor of at least 128 raises) but do not set the tiles: the CUDA
    kernels choose their own (in bf16, 128 q rows by 128 KV rows in the
    forward, 128 KV rows by 64 q rows in dk/dv, 128 q rows by 64 KV rows
    in dq; at head dims above 128, 64, 64 and 32 of the second; 32 rows
    in f32). The kernels take a head dim that is a multiple of 16, at
    most 256."""
    _check_flash_args(q, k, v, causal, block_q, block_kv, window,
                      row_offset, prefix)
    return _FlashAttention.apply(q, k, v, causal, window, row_offset,
                                 prefix, False)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             block_q: int = 512, block_kv: int = 512,
                             window: Optional[int] = None,
                             row_offset: int = 0,
                             prefix: Optional[int] = None):
    """Like :func:`flash_attention` but also returns the per-row
    natural-log logsumexp ``[b, h, t]`` f32, the mergeable partial form
    (:func:`merge_partials`). A row whose band is empty comes back with
    out 0 and lse about -6.93e29 (zero merge weight, still finite).
    Gradients flow through both outputs."""
    _check_flash_args(q, k, v, causal, block_q, block_kv, window,
                      row_offset, prefix)
    return _FlashAttention.apply(q, k, v, causal, window, row_offset,
                                 prefix, True)


def merge_partials(o1: torch.Tensor, lse1: torch.Tensor,
                   o2: torch.Tensor, lse2: torch.Tensor):
    """Exactly combine two partial-attention results over disjoint KV
    sets. o: [b, h, t, d], lse: [b, h, t] natural log. The merged output
    is returned in f32, with the merged lse."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    lse = m + torch.log(denom)
    out = (o1.float() * (w1 / denom)[..., None]
           + o2.float() * (w2 / denom)[..., None])
    return out, lse


# ------------------------------------------------------------ benchmarks

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _bench_inputs(b, h, t, d, dtype, device):
    """q, k, v [b, h, t, d] drawn on the CPU from seed 0, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    return tuple(torch.randn((b, h, t, d), generator=gen).to(dev, dtype)
                 for _ in range(3))


def _band_pairs(t: int, window: int) -> int:
    """(row, col) pairs a causal window of ``window`` leaves visible in a
    [t, t] score matrix: the reference's count, w(w+1)/2 + (t - w) w."""
    return window * (window + 1) // 2 + (t - window) * window


def _forward_chain(attn, q, k, v, dtype):
    """make_run(n) for a chain of n forwards, each output fed back as
    the next q (the reference's ``fori_loop``)."""
    def make_run(n):
        @torch.no_grad()
        def run():
            qq = q
            for _ in range(n):
                qq = attn(qq, k, v).to(dtype)
            return qq
        return run
    return make_run


def _train_chain(attn, q, k, v, dtype):
    """make_run(n) for a chain of n training steps: the gradients of
    sum(attn(q, k, v)²) in q, k and v, and the update x - 1e-4 dx (in
    f32, cast back) fed into the next step, so no gradient is dead."""
    def step(qkv):
        qkv = tuple(x.detach().requires_grad_() for x in qkv)
        loss = attn(*qkv).float().square().sum()
        grads = torch.autograd.grad(loss, qkv)
        with torch.no_grad():
            return tuple((x.float() - 1e-4 * g.float()).to(dtype)
                         for x, g in zip(qkv, grads))

    def make_run(n):
        def run():
            qkv = (q, k, v)
            for _ in range(n):
                qkv = step(qkv)
            return qkv
        return run
    return make_run


def flash_attention_tflops(b: int = 4, h: int = 8, t: int = 2048,
                           d: int = 128, dtype=torch.bfloat16,
                           iters: int = 3, chain_short: int = 64,
                           chain_long: int = 192, device="cuda") -> dict:
    """Causal flash-attention forward throughput (TFLOP/s) and its speedup
    over the oracle attention at the same shape. Seconds per step come
    from :func:`chain_seconds_per_step` (the device-busy time of the long
    chain on the card, the marginal rate between the two chain lengths
    without one). FLOP accounting: 4 b h t² d (QKᵀ and PV), halved for
    causality. The oracle (``ref_attn_tflops``, ``speedup_vs_ref``) runs
    while its score matrix stays under 4 GiB, as in the reference;
    ``library_attn_tflops`` times ``F.scaled_dot_product_attention`` at
    the same shape as a yardstick (nothing of the port computes with
    it)."""
    q, k, v = _bench_inputs(b, h, t, d, dtype, device)

    def measure(attn):
        return chain_seconds_per_step(_forward_chain(attn, q, k, v, dtype),
                                      chain_short, chain_long, iters)

    per_flash = measure(lambda q, k, v: flash_attention(q, k, v, True))
    flops = 4 * b * h * t * t * d / 2
    out = {
        "flash_attn_tflops": flops / per_flash / 1e12,
        "shape": f"b{b} h{h} t{t} d{d} {_dtype_name(dtype)}",
    }
    # the oracle materializes the [t, t] score matrix
    if b * h * t * t * 4 < 4 << 30:
        per_ref = measure(lambda q, k, v: attention_reference(q, k, v, True))
        out["ref_attn_tflops"] = flops / per_ref / 1e12
        out["speedup_vs_ref"] = per_ref / per_flash
    per_lib = measure(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    out["library_attn_tflops"] = flops / per_lib / 1e12
    return out


def flash_attention_long_context_tflops(b: int = 1, h: int = 8,
                                        t: int = 16384, d: int = 128,
                                        window: int = 2048,
                                        dtype=torch.bfloat16, iters: int = 3,
                                        chain_short: int = 8,
                                        chain_long: int = 24,
                                        n_runs: int = 1,
                                        device="cuda") -> dict:
    """Sliding-window flash attention at long context: the banded kernel
    touches O(t · window) where the oracle's score matrix would take
    b h t² 4 bytes (8 GiB at these defaults). Useful-FLOP accounting
    counts only the visible band, w(w+1)/2 + (t - w) w pairs of 4 d
    FLOPs. ``n_runs`` > 1 re-times the same chain and returns every
    sample in ``runs_tflops`` (the headline is their median)."""
    q, k, v = _bench_inputs(b, h, t, d, dtype, device)
    make_run = _forward_chain(
        lambda q, k, v: flash_attention(q, k, v, True, window=window,
                                        block_q=512, block_kv=1024),
        q, k, v, dtype)
    pers = chain_seconds_per_step_runs(make_run, chain_short, chain_long,
                                       iters, n_runs)
    flops = 4 * b * h * d * _band_pairs(t, window)
    runs = sorted(flops / p / 1e12 for p in pers)
    per = sorted(pers)[len(pers) // 2]
    return {"flash_attn_long_ctx_tflops": runs[len(runs) // 2],
            "runs_tflops": runs,
            "long_ctx_step_ms": per * 1e3,
            "shape": f"b{b} h{h} t{t} w{window} d{d} {_dtype_name(dtype)}"}


def flash_attention_train_tflops(b: int = 4, h: int = 8, t: int = 2048,
                                 d: int = 128, dtype=torch.bfloat16,
                                 iters: int = 3, chain_short: int = 16,
                                 chain_long: int = 48,
                                 device="cuda") -> dict:
    """Forward and backward (training) flash-attention throughput: a
    chain of steps that each take the gradients of sum(out²) in q, k and
    v (kernels B1, B2, B3) and feed the updated q, k, v into the next.
    FLOP accounting: 2 forward and 5 backward products, 3.5x the
    forward's 4 b h t² d / 2 (causal)."""
    q, k, v = _bench_inputs(b, h, t, d, dtype, device)
    make_run = _train_chain(lambda q, k, v: flash_attention(q, k, v, True),
                            q, k, v, dtype)
    per = chain_seconds_per_step(make_run, chain_short, chain_long, iters)
    flops = 3.5 * 4 * b * h * t * t * d / 2
    return {"flash_attn_train_tflops": flops / per / 1e12,
            "shape": f"b{b} h{h} t{t} d{d} {_dtype_name(dtype)}"}


def flash_attention_long_context_train_tflops(
        b: int = 1, h: int = 8, t: int = 16384, d: int = 128,
        window: int = 2048, dtype=torch.bfloat16, iters: int = 3,
        chain_short: int = 4, chain_long: int = 12, n_runs: int = 1,
        device="cuda") -> dict:
    """Forward and backward sliding-window attention at long context:
    the training chain of :func:`flash_attention_train_tflops` under the
    window mask. FLOP accounting: 3.5x the forward's band-visible pairs.
    ``n_runs`` > 1 re-times the same chain and returns every sample in
    ``runs_tflops`` (the headline is their median)."""
    q, k, v = _bench_inputs(b, h, t, d, dtype, device)
    make_run = _train_chain(
        lambda q, k, v: flash_attention(q, k, v, True, window=window,
                                        block_q=512, block_kv=1024),
        q, k, v, dtype)
    pers = chain_seconds_per_step_runs(make_run, chain_short, chain_long,
                                       iters, n_runs)
    flops = 3.5 * 4 * b * h * d * _band_pairs(t, window)
    runs = sorted(flops / p / 1e12 for p in pers)
    per = sorted(pers)[len(pers) // 2]
    return {"flash_attn_long_ctx_train_tflops": runs[len(runs) // 2],
            "runs_tflops": runs,
            "long_ctx_train_step_ms": per * 1e3,
            "shape": f"b{b} h{h} t{t} w{window} d{d} {_dtype_name(dtype)}"}
