"""Paged attention: decode reads over a block-pooled KV cache.

Port of :mod:`tpu_dra_driver.workloads.ops.paged_attention`. K/V live in
a shared pool of fixed-size blocks ``[n_blocks, h_kv, block_t, hd]``;
each sequence owns an int32 block table of physical block ids, and
block 0 is the null block that inactive rows point at.

``paged_decode_attention`` is the wrapper over the hand-written CUDA
kernel ``csrc/paged_attention.cu`` (it replaces the Pallas
``_paged_kernel``). It dispatches on the device of its inputs: CPU
tensors take :func:`paged_decode_attention_plain`, CUDA tensors launch
the kernel, and anything else raises. Each launch adds one to
``paged_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.ops import _build

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
# tokens of a row's live range per CTA of the kernel's split (kChunk in
# csrc/paged_attention.cu): the FMA kernel's, which f32 takes, and the
# tensor-core kernel's (kMmaChunk), which bf16 takes
_CHUNK = 64
_MMA_CHUNK = 32


def _chunk(dtype: torch.dtype) -> int:
    """The kernel's chunk for q's dtype, which picks the kernel:
    ``_MMA_CHUNK`` (the tensor-core kernel) for bf16, ``_CHUNK`` (the FMA
    kernel) for f32."""
    return _MMA_CHUNK if dtype == torch.bfloat16 else _CHUNK


def _n_split(n_live_blocks: int, block_t: int, chunk: int = _CHUNK) -> int:
    """CTAs per (sequence, KV head) of the kernel: the chunks of ``chunk``
    tokens that cover ``n_live_blocks`` blocks. Host integers only, so a
    launch never waits for the card."""
    return -(-n_live_blocks * block_t // chunk)


def init_pool(n_blocks: int, block_t: int, h_kv: int, hd: int,
              dtype=torch.bfloat16, device="cuda"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V pools [n_blocks, h_kv, block_t, hd]. Block 0 is the
    null block (never read as part of a live sequence)."""
    dev = resolve_device(device)
    shape = (n_blocks, h_kv, block_t, hd)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def pool_append(pool_k: torch.Tensor, pool_v: torch.Tensor,
                table: torch.Tensor, lens: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor):
    """Write one new K/V vector per sequence at its next position, in
    place (one ``index_put_`` per pool); returns (pool_k, pool_v).

    table: [b, max_blocks] int32; lens: [b] tokens already written; k/v:
    [b, h_kv, hd]. The caller guarantees each sequence's table maps
    block ``lens // block_t``. Inactive rows (table row 0) all collide
    on the null block, which nothing reads, so which of them lands
    there does not matter."""
    block_t = pool_k.shape[2]
    rows = torch.arange(k.shape[0], device=k.device)
    lens = lens.long()
    blk = table[rows, lens // block_t].long()              # [b]
    off = lens % block_t                                   # [b]
    pool_k[blk, :, off, :] = k.to(pool_k.dtype)
    pool_v[blk, :, off, :] = v.to(pool_v.dtype)
    return pool_k, pool_v


def paged_attention_reference(q, pool_k, pool_v, table, lens):
    """Oracle: gather each sequence's blocks and run masked attention,
    as the JAX oracle does (a ``lens == 0`` row gives the uniform mean
    of V, unlike the kernel). q: [b, h, 1, hd]; table: [b, max_blocks];
    lens: [b]."""
    b, h, _, hd = q.shape
    n_blocks, h_kv, block_t, _ = pool_k.shape
    max_blocks = table.shape[1]

    def gather(pool):
        g = pool[table.long()]                    # [b, mb, h_kv, bt, hd]
        g = g.transpose(1, 2)
        return g.reshape(b, h_kv, max_blocks * block_t, hd)

    kc, vc = gather(pool_k), gather(pool_v)
    rep = h // h_kv
    qg = q.reshape(b, h_kv, rep, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, kc.to(q.dtype)).float()
    s = s / math.sqrt(hd)
    slots = torch.arange(max_blocks * block_t, device=q.device)
    visible = slots[None, :] < lens[:, None]
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", p, vc.to(q.dtype))
    return out.reshape(b, h, 1, hd)


def _check(q, pool_k, pool_v, table, lens, n_live_blocks):
    """Shape checks shared by the kernel and its plain version; returns
    the resolved ``n_live_blocks``."""
    b, h, g, hd = q.shape
    if g != 1:
        raise ValueError(f"paged_decode_attention is the g=1 decode read "
                         f"(got g={g})")
    n_blocks, h_kv, block_t, hd_p = pool_k.shape
    if hd_p != hd:
        raise ValueError(f"pool head dim {hd_p} != query head dim {hd}")
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"pool shapes differ: {tuple(pool_k.shape)} vs "
                         f"{tuple(pool_v.shape)}")
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {h_kv}")
    if table.ndim != 2 or table.shape[0] != b or lens.shape != (b,):
        raise ValueError("table/lens batch mismatch")
    max_blocks = table.shape[1]
    if n_live_blocks is None:
        n_live_blocks = max_blocks
    if not 1 <= n_live_blocks <= max_blocks:
        raise ValueError(f"n_live_blocks {n_live_blocks} outside "
                         f"[1, {max_blocks}]")
    return n_live_blocks


def paged_decode_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, table: torch.Tensor,
                                 lens: torch.Tensor,
                                 n_live_blocks: Optional[int] = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a masked gather of the
    first ``n_live_blocks`` table columns and a softmax, with the
    kernel's numerics (f32 scores from K in q's dtype, P cast to V's
    dtype for the P.V product, ``lens == 0`` rows give 0). Table entries
    past a row's live range are never read."""
    n_live_blocks = _check(q, pool_k, pool_v, table, lens, n_live_blocks)
    b, h, _, hd = q.shape
    _, h_kv, block_t, _ = pool_k.shape
    rep = h // h_kv
    lens = lens.long()
    # columns past a row's last live block clamp to it, as the TPU
    # kernel's index map does, and a length-0 row reads the null block,
    # so entries past a row's live range are never followed
    jmax = (lens - 1).clamp_min(0) // block_t                      # [b]
    cols = torch.minimum(torch.arange(n_live_blocks, device=q.device),
                         jmax[:, None])                            # [b, nl]
    blocks = table.long().gather(1, cols).masked_fill(
        lens[:, None] == 0, 0)                                     # [b, nl]
    n_slots = n_live_blocks * block_t

    def gather(pool):
        g = pool[blocks].to(q.dtype)              # [b, nl, h_kv, bt, hd]
        return g.transpose(1, 2).reshape(b, h_kv, n_slots, hd)

    kc, vc = gather(pool_k), gather(pool_v)
    qg = q.reshape(b, h_kv, rep, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg.float(), kc.float())
    s = s * (1.0 / math.sqrt(hd))
    slots = torch.arange(n_slots, device=q.device)
    visible = (slots[None, :] < lens[:, None])[:, None, None, :]
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgt,bktd->bkgd", p.to(vc.dtype).float(), vc.float())
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, h, 1, hd)


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, table: torch.Tensor,
                           lens: torch.Tensor,
                           n_live_blocks: Optional[int] = None
                           ) -> torch.Tensor:
    """Block-table decode read: q [b, h, 1, hd] against pooled caches
    [n_blocks, h_kv, block_t, hd] → [b, h, 1, hd].

    table [b, max_blocks] int32 physical block ids (entries past a
    row's live range may hold anything; they are never read); lens [b]
    int32 visible-token counts. At most ``n_live_blocks`` table columns
    are walked; the caller guarantees ``max(lens) <= n_live_blocks *
    block_t`` (the engine derives it from the lens it tracks). Device
    reads per sequence are O(lens[i]).

    CPU tensors run :func:`paged_decode_attention_plain`. CUDA tensors
    launch the kernel of ``csrc/paged_attention.cu`` (built at first
    use) and must be contiguous, on one device, q and pools both bf16
    or both f32 with rows of a multiple of 16 bytes, table and lens
    int32; anything else raises."""
    tensors = (q, pool_k, pool_v, table, lens)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_plain(q, pool_k, pool_v, table, lens,
                                            n_live_blocks)
    n_live_blocks = _check(q, pool_k, pool_v, table, lens, n_live_blocks)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_decode_attention needs all inputs on the "
                         "CPU or all on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _KERNEL_DTYPES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"kernel takes q and pools both bf16 or both f32; "
                         f"got {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"table and lens must be int32; got "
                         f"{table.dtype}, {lens.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention's kernel needs contiguous "
                         "inputs")
    # The kernel replaces the Pallas `_paged_kernel` of
    # tpu_dra_driver/workloads/ops/paged_attention.py. Its bound on the
    # H100 is bytes: each sequence's live K and V, read once, over
    # 3.35 TB/s (about one operation per byte). Each row's live range is
    # split into chunks of `_chunk` tokens, one CTA each (its GQA group
    # together, so every K/V byte is read once, and only live slots),
    # and a second kernel merges the chunks' partial softmax states into
    # ``part``; bf16 takes the tensor-core kernel; see
    # csrc/paged_attention.cu.
    b, h, _, hd = q.shape
    n_blocks, h_kv, block_t, _ = pool_k.shape
    check_head_dim(hd, q.dtype)
    out = torch.empty_like(q)
    if b == 0:
        return out
    n_split = _n_split(n_live_blocks, block_t, _chunk(q.dtype))
    part = None
    if n_split > 1:
        part = torch.empty((b, h, n_split, hd + 2), dtype=torch.float32,
                           device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention_launch(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), table.data_ptr(), lens.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            b, h, h_kv, hd, block_t, table.shape[1], n_live_blocks,
            n_split, stream)
    if rc != 0:
        raise RuntimeError(
            "paged_decode_attention kernel launch failed: "
            f"{lib.paged_attention_error_string(rc).decode()} "
            f"(cudaError {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def check_head_dim(hd: int, dtype: torch.dtype) -> None:
    """B4's rule for the head dim, which needs no card: rows of a multiple
    of 16 bytes in ``dtype``, at most ``_MAX_HEAD_DIM`` values; raises
    ``ValueError``."""
    if hd > _MAX_HEAD_DIM or hd * dtype.itemsize % 16:
        raise ValueError(f"kernel takes head dims of a multiple of 16 bytes "
                         f"up to {_MAX_HEAD_DIM}; got {hd} in {dtype}")


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        err = lib.paged_attention_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib
