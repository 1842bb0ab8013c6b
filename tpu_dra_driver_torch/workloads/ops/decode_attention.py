"""Flash-decode: single-query attention reads over a contiguous KV cache.

Port of :mod:`tpu_dra_driver.workloads.ops.decode_attention`. The cache
is ``[b, h_kv, L, hd]`` per layer (bf16/f32 values, or int8 codes with
per-slot f32 scales ``[b, h_kv, L]``), and one decode step reads it for
q ``[b, h, 1, hd]`` with visibility ``slot <= pos``: a full-length cache
(slot index == position) or a ring whose every slot is visible once
``pos >= L``.

``flash_decode_attention`` is the wrapper over the hand-written CUDA
kernel ``csrc/decode_attention.cu`` (it replaces the Pallas
``_decode_kernel``). It dispatches on the device of its inputs: CPU
tensors take :func:`flash_decode_attention_plain`, CUDA tensors launch
the kernel, and anything else raises. Each launch adds one to
``flash_decode_attention.launches``.

``pos`` is a Python int, or an int32 tensor of shape ``[]`` or ``[1]``
(the reference's ``atleast_1d(pos)``). On the card the kernel reads a
device ``pos`` itself: its grid depends on L, ``b * h_kv`` and the SM
count only (:func:`decode_n_split`), and each CTA takes its own run of
slots from ``pos`` (:func:`decode_partition`), so a launch can be
captured in a CUDA graph and replayed at any position. A device ``pos``
is never read on the host, so it is not checked: a value below 0 sees
no slot and gives 0. A call is one launch: the splits of a row are one
thread-block cluster and merge through distributed shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import List, Optional, Tuple, Union

import torch

from tpu_dra_driver_torch.workloads.ops import _build

NEG_INF = -1e30

# cache-block width full-length caches are padded to a multiple of
KV_BLOCK = 128

# slots of K and V in one tile of the kernel's ring
_TILE = 64
# splits of a row: the CTAs of one thread-block cluster, at most the
# portable cluster size (kMaxSplits in csrc/decode_attention.cu)
_MAX_SPLITS = 8
# resident CTAs of the kernel an SM holds; one of the tensor-core
# kernel past head dim 128, whose ring takes most of an SM's shared
# memory (kMmaWideRingBytes in csrc/decode_attention.cu)
_CTAS_PER_SM = 2
_CTAS_PER_SM_WIDE = 1
_MAX_HEAD_DIM = 256
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def round_up_kv(n: int) -> int:
    """n rounded up to the next KV_BLOCK multiple."""
    return -(-n // KV_BLOCK) * KV_BLOCK


def decode_block_t(L: int, requested: int = 512) -> int:
    """The largest KV_BLOCK-multiple divisor of L that is <= requested,
    or 0 when none exists (callers then take the masked read). Cache
    lengths padded to KV_BLOCK multiples (``init_kv_cache`` does this
    for full-length caches) always qualify."""
    top = (min(requested, L) // KV_BLOCK) * KV_BLOCK
    for blk in range(top, KV_BLOCK - 1, -KV_BLOCK):
        if L % blk == 0:
            return blk
    return 0


def decode_n_split(L: int, bh: int, n_sm: int,
                   ctas_per_sm: int = _CTAS_PER_SM) -> int:
    """The kernel's number of splits of each (sequence, KV head)'s live
    range: enough that ``bh`` (= b * h_kv) times it fills ``n_sm`` SMs
    with about ``ctas_per_sm`` CTAs each (:func:`ctas_per_sm`), at most
    one split per 64-slot tile of the cache, and at most 8, the CTAs of
    one portable thread-block cluster, which merges the splits. A GPC
    packs a cluster's CTAs onto as few SMs as fit, so clusters of more
    than two CTAs are kept to about 1.5 CTAs per SM (at the generation
    read, b * h_kv = 32 on 132 SMs, 6 splits read as fast as a separate
    merge kernel did, 4 and 8 slower). It depends on no position."""
    bh = max(bh, 1)
    n = max(1, min(_MAX_SPLITS, L // _TILE, ctas_per_sm * n_sm // bh))
    return n if n <= 2 else max(2, min(n, 3 * n_sm // (2 * bh)))


def ctas_per_sm(q_dtype: torch.dtype, hd: int) -> int:
    """Resident CTAs per SM of the kernel that q's dtype and the head dim
    take: one for bf16 queries past head dim 128 (the tensor-core kernel
    with its 192 KiB ring, so that each split holds a few tiles in
    flight), else two."""
    if q_dtype == torch.bfloat16 and hd > 128:
        return _CTAS_PER_SM_WIDE
    return _CTAS_PER_SM


def decode_partition(L: int, n_live: int,
                     n_split: int) -> List[Tuple[int, int]]:
    """The kernel's partition (``split_tiles`` in
    ``csrc/decode_attention.cu``): split s reads the slots
    ``[start, end)`` of the live range ``[0, n_live)`` (n_live =
    min(pos + 1, L)), balanced runs of whole 64-slot tiles of which only
    the last may end short; an empty run is ``(x, x)``."""
    n_live = max(0, min(n_live, L))
    n_tiles = -(-n_live // _TILE)
    out = []
    for s in range(n_split):
        t0, t1 = s * n_tiles // n_split, (s + 1) * n_tiles // n_split
        out.append((min(t0 * _TILE, n_live), min(t1 * _TILE, n_live)))
    return out


def _check(q, k_cache, v_cache, pos, k_scale, v_scale, block_t):
    """The reference's argument checks; returns ``pos`` as an int, or as
    the int32 tensor it was given when that is not on the CPU (unchecked:
    reading a CUDA tensor would make the host wait for the card)."""
    b, h, g, hd = q.shape
    if g != 1:
        raise ValueError(f"flash_decode_attention is the g=1 decode read "
                         f"(got g={g}); wide verifies use the einsum path")
    h_kv, L = k_cache.shape[1], k_cache.shape[2]
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {h_kv}")
    if k_scale is not None and (
            v_scale is None or tuple(k_scale.shape) != (b, h_kv, L)
            or tuple(v_scale.shape) != (b, h_kv, L)):
        raise ValueError("int8 cache needs k_scale and v_scale [b, h_kv, L]")
    if not decode_block_t(L, block_t):
        raise ValueError(
            f"cache length {L} has no block divisor >= {KV_BLOCK}; "
            f"pad cache lengths to a multiple of {KV_BLOCK}")
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dim() > 1 or pos.dtype != torch.int32:
            raise ValueError(f"a tensor pos is an int32 of shape [] or [1]; "
                             f"got {pos.dtype} {tuple(pos.shape)}")
        if pos.device.type != "cpu":
            return pos
        # a CPU tensor is host memory: read through numpy, which takes
        # no device value (a CUDA pos is never read, above)
        pos = int(pos.numpy().reshape(()))
    pos = operator.index(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    return pos


def flash_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: int,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the Pallas kernel's
    numerics: scores in f32 from K cast to q's dtype, the per-slot
    ``k_scale`` applied before the softmax scale, slots ``<= pos``
    visible, ``l`` summed from the unscaled probabilities, which are
    then multiplied by the per-slot ``v_scale`` and cast to q's dtype
    for the P.V product, and ``acc / l`` last, in q's dtype. Only the
    visible slots ``[0, min(pos + 1, L))`` are read."""
    b, h, _, hd = q.shape
    h_kv, L = k_cache.shape[1], k_cache.shape[2]
    rep = h // h_kv
    n = min(operator.index(pos) + 1, L)
    k = k_cache[:, :, :n].to(q.dtype).float()
    v = v_cache[:, :, :n].to(q.dtype)
    qg = q.reshape(b, h_kv, rep, hd).float()
    s = torch.einsum("bkrd,bktd->bkrt", qg, k)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :n].float()
    s = s * (1.0 / math.sqrt(hd))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :n].float()
    acc = torch.einsum("bkrt,bktd->bkrd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype).reshape(b, h, 1, hd)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: Union[int, torch.Tensor],
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           block_t: int = 512) -> torch.Tensor:
    """Single-step decode attention: q [b, h, 1, hd] against the cache
    [b, h_kv, L, hd], visibility ``slot <= pos`` → [b, h, 1, hd] in q's
    dtype. int8 caches pass ``k_scale``/``v_scale`` [b, h_kv, L] f32.
    ``block_t`` is the reference's cache-block request: L must have a
    KV_BLOCK-multiple divisor up to it, as there.

    ``pos`` is an int or an int32 tensor of shape [] or [1]. An int, or a
    tensor on the CPU, must be >= 0; a tensor on the inputs' CUDA device
    is read by the kernel and never on the host, so it is not checked (a
    value below 0 gives 0).

    CPU tensors run :func:`flash_decode_attention_plain`. CUDA tensors
    launch the kernel of ``csrc/decode_attention.cu`` (built at first
    use) and must be contiguous and on one device, q bf16 or f32, the
    cache of q's dtype or int8, scales f32, head dim a multiple of 16 up
    to 256; anything else raises (a cluster launch the card refuses
    included). Device reads are O(min(pos + 1, L)). The launch's grid
    does not depend on ``pos``."""
    pos = _check(q, k_cache, v_cache, pos, k_scale, v_scale, block_t)
    on_device = isinstance(pos, torch.Tensor)
    tensors = [q, k_cache, v_cache]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    devices = [t.device for t in tensors] + ([pos.device] if on_device
                                             else [])
    if all(d.type == "cpu" for d in devices):
        return flash_decode_attention_plain(q, k_cache, v_cache, pos,
                                            k_scale, v_scale)
    if any(d != q.device for d in devices) or q.device.type != "cuda":
        raise ValueError("flash_decode_attention needs all inputs on the "
                         "CPU or all on one CUDA device; got "
                         f"{[str(d) for d in devices]}")
    quantized = k_cache.dtype == torch.int8
    if q.dtype not in _Q_DTYPES or v_cache.dtype != k_cache.dtype \
            or k_cache.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"kernel takes q bf16 or f32 and a cache of q's "
                         f"dtype or int8; got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if quantized != (k_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and "
                         "only an int8 cache takes them")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError(f"scales must be f32; got {k_scale.dtype}, "
                         f"{v_scale.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_attention's kernel needs contiguous "
                         "inputs")
    b, h, _, hd = q.shape
    h_kv, L = k_cache.shape[1], k_cache.shape[2]
    if tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    check_head_dim(hd)
    # The kernel replaces the Pallas `_decode_kernel` of
    # tpu_dra_driver/workloads/ops/decode_attention.py. Its bound on the
    # H100 is bytes: the live K and V (and scales), read once, over
    # 3.35 TB/s. The live slots are split over enough CTAs to fill the
    # card, and the splits of a row, one thread-block cluster, merge
    # their partial softmax states through distributed shared memory in
    # the same launch; see csrc/decode_attention.cu.
    out = torch.empty_like(q)
    if b == 0:
        return out
    rep = h // h_kv
    n_split = decode_n_split(L, b * h_kv, _sm_count(q.device),
                             ctas_per_sm(q.dtype, hd))
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_attention_launch(
            _Q_DTYPES[q.dtype], int(quantized), q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            pos.data_ptr() if on_device else None,
            0 if on_device else min(pos, L),   # the same n_live, in int32
            out.data_ptr(), b, h_kv, rep, hd, L, n_split, stream)
    if rc != 0:
        raise RuntimeError(
            "flash_decode_attention kernel launch failed: "
            f"{lib.decode_attention_error_string(rc).decode()} "
            f"(cudaError {rc})")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def check_head_dim(hd: int) -> None:
    """B5's rule for the head dim, which needs no card: a multiple of 16,
    at most ``_MAX_HEAD_DIM``; raises ``ValueError``."""
    if hd % 16 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head dims that are multiples of 16 "
                         f"up to {_MAX_HEAD_DIM}; got {hd}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.flash_decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        err = lib.decode_attention_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib
