#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_dra_driver_torch``).

Drives the port's serving and training paths on one CUDA card and
checks them; imports no JAX. Phases, each of which fails the run when
it fails:

1. card: the card's name and power limit from nvidia-smi;
2. build: the CUDA kernels from the sources in the checkout, one nvcc
   per source, all started together (sm_90a);
3. paged kernel: the paged-attention decode kernel (B4) against its
   plain PyTorch version at the full-width serving shapes, in bf16
   (timed, with its bound and a library call as yardstick) and in f32;
4. flash kernels: the flash-attention forward (B1), dq (B2) and dk/dv
   (B3) kernels against their plain versions over every mask form in
   f32, and at the full-width training shapes in bf16 row by row against
   an f32 reference (timed likewise);
5. engine parity: the ``ServingTraffic`` configuration in fp32 through
   the engine on the card and on the CPU, same weights and prompts;
6. serving: the full-width serving configuration (vocab 8192, d_model
   1024, 8 heads over 4 KV heads, 6 layers, RoPE, bf16; six prompts of
   256-512 tokens, 96 new tokens each) through ``ServingEngine.run``,
   with B4's launches counted over that run;
7. training parity: a small GQA/RoPE config in fp32, three
   ``make_train_step`` steps on the card and on the CPU from one seed,
   and the loss of ``entry()`` on both;
8. training: the flagship training configuration (vocab 8192, d_model
   2048, 16 heads over 4 KV heads, 8 layers, d_ff 8192, RoPE, bf16,
   ``remat`` with the ``"dots"`` policy, ``scan_layers``; batch 8 x 2048;
   ``default_optimizer()``; flash attention) for one untimed and three
   timed steps, with B1-B3's launches counted over the timed steps, one
   more step under ``torch.profiler`` for its device time by kernel, and
   one of its blocks at b=1 on the card against the CPU.

It then prints one ``{"kernels": [...]}`` line and, last, the device
line ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero and prints no result.

Run from the repo root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dra_driver_torch import entry
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.models.serving import (
    ServingEngine, paged_decode_step,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, init_params,
)
from tpu_dra_driver_torch.workloads.ops import _build
from tpu_dra_driver_torch.workloads.ops import attention as fa
from tpu_dra_driver_torch.workloads.ops import paged_attention as pa

DEV = "cuda"
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# kernel vs plain tolerances. bf16: P is rounded to bf16 against the
# running max in the kernel and against the final max in the plain
# version, and the output is rounded to bf16 (2^-8 relative) on both
# sides; outputs are O(1) at most, so 1e-2 absolute. f32: summation
# order only, over at most 1024 terms; one token masked wrongly moves a
# row by ~1/len >= 1e-3.
TOL_BF16 = 1e-2
TOL_F32 = 1e-5
# card vs CPU, fp32 engine: cuBLAS and the CPU BLAS sum in other orders
TOL_ENGINE_LOGITS = 1e-4
# card vs CPU, one full-width bf16 decode step from identical pools,
# relative to the largest logit: bf16 rounding (2^-8) through six layers
TOL_FULL_WIDTH_REL = 5e-2

FULL = ModelConfig(vocab=8192, d_model=1024, n_heads=8, n_kv_heads=4,
                   n_layers=6, d_ff=4096, max_seq=1664, use_rope=True)
FULL_PROMPT_LENS = (512, 256, 384, 256, 512, 384)
FULL_NEW_TOKENS = 96
FULL_ENGINE = dict(n_blocks=64, block_t=128, max_batch=8)
SMALL = ModelConfig(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                    n_layers=2, d_ff=128, max_seq=256, use_rope=True,
                    dtype=torch.float32)
SMALL_ENGINE = dict(n_blocks=24, block_t=8, max_batch=4,
                    max_blocks_per_seq=8)

KERNEL_SOURCES = ("paged_attention", "flash_attention")

# bf16 against an f32 reference, row by row. Under a causal mask the
# outputs' scale falls off along the sequence (out[0] is v[0], dk and dv
# of the first columns sum over every row), so a bound relative to a
# tensor's largest value would pass a tile left out of a typical row.
# Each row (the last axis) of the kernel's output is instead held
# against the same row of an f32 reference computed from the same bf16
# inputs: its largest error may be TOL_BF16_VS_PLAIN times that of the
# bf16 plain version (or of the block on the CPU) in the same row, which
# is what rounding to bf16 costs there (rows whose value cancels, as dq
# of the first rows, cost more), plus TOL_BF16_ROW_ATOL (one bf16 ulp)
# of the row's largest reference value (at least 1e-3 of the tensor's).
TOL_BF16_VS_PLAIN = 2.0
TOL_BF16_ROW_ATOL = 2.0 ** -8
# the 64 x 64 tiles (first q row, first KV column) whose omission the
# full-width bf16 allowance must see in every output: the diagonal tile of
# the middle rows, and a tile of the middle columns seen from the last
# rows
FLASH_MUTANT_TILES = ((1024, 1024), (1984, 1024))
FLASH_MUTANT_TILE = 64
# lse is f32 on both sides: summation order only
TOL_FLASH_LSE = 1e-4
# f32 mask cases: summation order only, relative to max(1, largest value)
TOL_FLASH_F32 = 1e-5
# (b, h, h_kv, t, d) of one attention call of the training configuration
FLASH_FULL = (8, 16, 4, 2048, 128)
# name -> ((b, h, h_kv, t, tkv, d), mask keywords), f32
FLASH_CASES = {
    "causal": ((2, 4, 2, 256, 256, 64), {}),
    "causal_gqa_4to1": ((1, 8, 2, 256, 256, 32), {}),
    "window": ((1, 4, 2, 256, 256, 64), dict(window=48)),
    "window_row_offset_empty_rows": ((1, 2, 1, 128, 128, 64),
                                     dict(window=32, row_offset=64)),
    "prefix": ((1, 4, 2, 256, 256, 32), dict(prefix=100)),
    "noncausal_tkv_ne_t": ((1, 4, 2, 128, 320, 32), dict(causal=False)),
    "causal_ragged_tiles": ((1, 2, 1, 80, 80, 128), {}),
}

# training, card vs CPU in fp32: losses to cuBLAS-vs-CPU summation
# order; params after three AdamW steps to 1% of one step's largest
# move for all but 1% of elements, the rest within the largest move of
# three steps (Adam divides each gradient by its own RMS, so elements
# whose gradient is near zero move by up to lr either way)
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_PARAM = 3e-6
SMALL_TRAIN = ModelConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=256, max_seq=128, use_rope=True,
                          dtype=torch.float32)
SMALL_TRAIN_BATCH = (4, 128)
# the flagship training configuration (the default of the reference's
# train_tokens_per_sec), one step of batch 8 x 2048
FULL_TRAIN = ModelConfig(vocab=8192, d_model=2048, n_heads=16, n_kv_heads=4,
                         n_layers=8, d_ff=8192, max_seq=2048, use_rope=True,
                         remat=True, remat_policy="dots", scan_layers=True,
                         scan_unroll=8)
FULL_TRAIN_BATCH = (8, 2048)
TIMED_STEPS = 3
# random N(0, 0.02) weights, tied head: logits of variance ~ d * 0.02^2,
# so the first loss is about ln(8192) + 0.4 = 9.4
FIRST_LOSS_RANGE = (8.5, 10.5)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, iters: int = 50,
            flush: Optional[torch.Tensor] = None) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around each
    call, after warm-up; ``flush`` is overwritten before each call so
    the call finds the L2 cache cold, as the engine's calls do."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def paged_inputs(dtype, gen):
    """Full-width decode shapes: b=8, h=8, h_kv=4, hd=128, block_t=128,
    64 pool blocks, 32 table columns of which 8 are walked. Rows: a
    length-0 row, rows ending on a block edge (512, 1024), a 1-token row;
    table entries past each row's live range are not valid block ids."""
    b, h, h_kv, hd, block_t, n_blocks, max_blocks = 8, 8, 4, 128, 128, 64, 32
    lens = [0, 512, 1024, 1, 700, 129, 383, 960]
    dev = DEV
    pool_k = torch.randn((n_blocks, h_kv, block_t, hd), generator=gen)
    pool_v = torch.randn((n_blocks, h_kv, block_t, hd), generator=gen)
    q = torch.randn((b, h, 1, hd), generator=gen)
    phys = (torch.randperm(n_blocks - 1, generator=gen) + 1).tolist()
    table = torch.full((b, max_blocks), -7, dtype=torch.int32)
    for i, n in enumerate(lens):
        live = -(-n // block_t)
        table[i, :live] = torch.tensor(phys[:live], dtype=torch.int32)
        phys = phys[live:]
        table[i, live:] = 1_000_000 + i
    return (q.to(dev, dtype), pool_k.to(dev, dtype), pool_v.to(dev, dtype),
            table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev),
            8)


def kernel_phase(gen) -> dict:
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    result = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        q, pk, pv, table, lens, n_live = paged_inputs(dtype, gen)
        got = pa.paged_decode_attention(q, pk, pv, table, lens, n_live)
        want = pa.paged_decode_attention_plain(q, pk, pv, table, lens, n_live)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        zero_row = got[0].abs().max().item()
        print(f"{dtype}: max_abs_err {err:.3e} (tolerance {tol:.0e}); "
              f"length-0 row max |out| {zero_row}")
        if not err <= tol or zero_row != 0.0:
            raise AssertionError(f"paged kernel disagrees with its plain "
                                 f"version in {dtype}: {err} > {tol}")
        result[str(dtype)] = err
    # timings at the serving dtype: the inputs of the last (bf16) pass
    b, h, _, hd = q.shape
    h_kv, block_t = pk.shape[1], pk.shape[2]
    rep = h // h_kv
    ms = time_ms(lambda: pa.paged_decode_attention(q, pk, pv, table, lens,
                                                   n_live), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
        q, pk, pv, table, lens, n_live), iters=20, flush=flush)
    # yardstick only (the port never calls it): SDPA over the gathered
    # caches of the rows with len >= 1
    lens_l = lens.long()
    keep = (lens_l > 0).nonzero().flatten()
    n_slots = n_live * block_t
    cols = torch.minimum(torch.arange(n_live, device=DEV),
                         ((lens_l - 1).clamp_min(0) // block_t)[:, None])
    blocks = table.long().gather(1, cols)[keep]

    def gathered(pool):
        g = pool[blocks].transpose(1, 2).reshape(len(keep), h_kv, n_slots, hd)
        return g.repeat_interleave(rep, dim=1)

    kc, vc = gathered(pk), gathered(pv)
    mask = (torch.arange(n_slots, device=DEV)[None, :]
            < lens_l[keep][:, None])[:, None, None, :]
    qk = q[keep]
    lib_out = F.scaled_dot_product_attention(qk, kc, vc, attn_mask=mask)
    lib_err = (lib_out.float() - got[keep].float()).abs().max().item()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qk, kc, vc, attn_mask=mask), flush=flush)
    # bound: each input read once, each output written once; live K/V only
    live_tokens = lens_l.clamp_max(n_slots).sum().item()
    live_blocks = (-(-lens_l.clamp_max(n_slots) // block_t)).sum().item()
    esize = q.element_size()
    n_bytes = (2 * live_tokens * h_kv * hd * esize       # K and V
               + 2 * b * h * hd * esize                  # q and out
               + b * 4 + live_blocks * 4)                # lens, table
    n_flops = 4 * h * hd * live_tokens                   # QK and PV
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms (max |SDPA - kernel| {lib_err:.2e}); bound "
          f"{bound_ms:.4f} ms ({n_bytes} bytes, {n_flops} flops); kernel "
          f"at {100 * bound_ms / ms:.1f}% of bound")
    return {"max_abs_err": result[str(torch.bfloat16)],
            "max_abs_err_f32": result[str(torch.float32)],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def small_engine_phase() -> None:
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, SMALL.vocab, 6)]
               for _ in range(16)]
    engines = {dev: ServingEngine(init_params(SMALL, 0, device=dev), SMALL,
                                  device=dev, **SMALL_ENGINE)
               for dev in (DEV, "cpu")}
    logits, firsts = {}, {}
    for dev, eng in engines.items():
        for p in prompts[:4]:
            eng.add(p, 8)
        firsts[dev] = [r.pending for r in eng.rows]
        tokens = torch.tensor(firsts[dev], dtype=torch.int32)
        out, _, _ = paged_decode_step(
            eng.params, SMALL, [p.clone() for p in eng.pool_ks],
            [p.clone() for p in eng.pool_vs], eng._to_device(eng.tables),
            eng._to_device(eng.lens), tokens.to(dev),
            n_live_blocks=eng._live_blocks_bucket(1))
        logits[dev] = out.float().cpu()
    diff = (logits[DEV] - logits["cpu"]).abs().max().item()
    print(f"prefill first tokens equal: {firsts[DEV] == firsts['cpu']}; "
          f"decode-step logits max |card - cpu| {diff:.3e} "
          f"(tolerance {TOL_ENGINE_LOGITS:.0e})")
    if firsts[DEV] != firsts["cpu"] or not diff <= TOL_ENGINE_LOGITS:
        raise AssertionError("card and CPU engines disagree")
    outs = {dev: ServingEngine(init_params(SMALL, 0, device=dev), SMALL,
                               device=dev, **SMALL_ENGINE).run(prompts, 8)
            for dev in (DEV, "cpu")}
    print(f"16 requests x 8 tokens, card tokens == cpu tokens: "
          f"{outs[DEV] == outs['cpu']}")
    if outs[DEV] != outs["cpu"]:
        raise AssertionError(f"card and CPU tokens differ: {outs}")


def full_width_phase(card: str) -> dict:
    t0 = time.perf_counter()
    params = init_params(FULL, 3, device=DEV)
    n_params = tt.param_count(params)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, FULL.vocab, n)]
               for n in FULL_PROMPT_LENS]
    print(f"{n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    warm = ServingEngine(params, FULL, device=DEV, **FULL_ENGINE).run(
        prompts, FULL_NEW_TOKENS)           # first-call set-up, untimed
    eng = ServingEngine(params, FULL, device=DEV, **FULL_ENGINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    got = eng.run(prompts, FULL_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    outs = [got[rid] for rid in sorted(got)]
    n_tok = sum(len(o) for o in outs)
    print(f"{card}: {n_tok} tokens in {wall:.3f} s wall = "
          f"{n_tok / wall:.1f} tok/s (prefill included); peak memory "
          f"{peak / 2**20:.1f} MiB; paged kernel launches {launches}; "
          f"same tokens as the warm-up run: {got == warm}")
    expect = (FULL_NEW_TOKENS - 1) * FULL.n_layers
    if len(outs) != len(prompts) or any(
            len(o) != FULL_NEW_TOKENS or not all(0 <= t < FULL.vocab
                                                 for t in o) for o in outs):
        raise AssertionError("full-width run produced malformed outputs")
    if launches != expect:
        raise AssertionError(f"paged kernel launched {launches} times, "
                             f"expected {expect}")

    # one decode step on the card against the same step on the CPU from
    # identical pools (the CPU takes the kernel's plain version)
    eng = ServingEngine(params, FULL, device=DEV, **FULL_ENGINE)
    for p in prompts:
        eng.add(p, FULL_NEW_TOKENS)
    tokens = np.zeros((FULL_ENGINE["max_batch"],), np.int32)
    for r in eng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    args = (eng.pool_ks, eng.pool_vs, torch.from_numpy(eng.tables),
            torch.from_numpy(eng.lens), torch.from_numpy(tokens))
    n_live = eng._live_blocks_bucket(1)
    card_logits, _, _ = paged_decode_step(
        params, FULL, [p.clone() for p in args[0]],
        [p.clone() for p in args[1]], *(a.to(DEV) for a in args[2:]),
        n_live_blocks=n_live)
    cpu_params = _to_cpu(params)
    cpu_logits, _, _ = paged_decode_step(
        cpu_params, FULL, [p.cpu() for p in args[0]],
        [p.cpu() for p in args[1]], *args[2:], n_live_blocks=n_live)
    active = [r.row for r in eng.rows if r is not None]
    a, c = card_logits.float().cpu()[active], cpu_logits.float()[active]
    rel = ((a - c).abs().max() / c.abs().max()).item()
    finite = bool(torch.isfinite(a).all())
    print(f"full-width decode step: logits finite {finite}, max |card - "
          f"cpu| / max |cpu| {rel:.3e} (tolerance {TOL_FULL_WIDTH_REL:.0e})")
    if not finite or not rel <= TOL_FULL_WIDTH_REL:
        raise AssertionError("full-width card and CPU decode steps disagree")
    return {"launches": launches, "tokens_per_s_wall": n_tok / wall,
            "peak_mib": peak / 2**20}


FLASH_KERNELS = (
    ("flash_forward", "tpu_dra_driver/workloads/ops/attention.py:105"),
    ("flash_backward_dq", "tpu_dra_driver/workloads/ops/attention.py:528"),
    ("flash_backward_dkv", "tpu_dra_driver/workloads/ops/attention.py:635"),
)


def _flash_wrappers():
    return {name: getattr(fa, name) for name, _ in FLASH_KERNELS}


def _flash_inputs(shape, dtype, gen):
    """(q, k, v, dO, g_lse) drawn on the CPU from ``gen``, on the card."""
    b, h, h_kv, t, tkv, d = shape

    def randn(*size):
        return torch.randn(size, generator=gen).to(DEV, dtype)

    return (randn(b, h, t, d), randn(b, h_kv, tkv, d), randn(b, h_kv, tkv, d),
            randn(b, h, t, d), randn(b, h, t).float())


def _flash_pairs(q, k, v, dout, g_lse, mask):
    """{output: (kernel's, plain version's)} for out, lse, dq, dk and dv
    on the same inputs; both backward versions take the kernel forward's
    out and lse."""
    out, lse = fa.flash_forward(q, k, v, **mask)
    want_out, want_lse = fa._flash_forward_plain(q, k, v, **mask)
    dd = (dout.float() * out.float()).sum(-1) - g_lse
    args = (q, k, v, dout, lse, dd)
    dq = fa.flash_backward_dq(*args, **mask)
    dk, dv = fa.flash_backward_dkv(*args, **mask)
    want_dq, want_dk, want_dv = fa._flash_backward_plain(*args, **mask)
    torch.cuda.synchronize()
    return {"out": (out, want_out), "lse": (lse, want_lse),
            "dq": (dq, want_dq), "dk": (dk, want_dk), "dv": (dv, want_dv)}


def _errors(pairs):
    """{output: (max abs error, largest |plain value|)}"""
    return {name: ((a.float() - b.float()).abs().max().item(),
                   b.float().abs().max().item())
            for name, (a, b) in pairs.items()}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 with at least one axis: its rows are its last axis."""
    x = x.float()
    return x[None] if x.ndim == 0 else x


def _row_err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Largest |x - ref| of each row."""
    return (_rows(x) - _rows(ref)).abs().amax(-1)


def _row_scale(ref: torch.Tensor) -> torch.Tensor:
    """Largest |value| of each row of ``ref``, and at least 1e-3 of its
    largest value (a row whose value cancels to 0, as dq of the first
    row, keeps the rounding of the terms it sums)."""
    scale = _rows(ref).abs().amax(-1)
    return scale.clamp_min(1e-3 * scale.max().item())


def _allowance(plain: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """What each row of a bf16 result may be off ``ref``:
    ``TOL_BF16_VS_PLAIN`` times the bf16 ``plain`` result's error in that
    row, plus ``TOL_BF16_ROW_ATOL`` of the row's scale."""
    return (TOL_BF16_VS_PLAIN * _row_err(plain, ref)
            + TOL_BF16_ROW_ATOL * _row_scale(ref))


def _bf16_reading(got, plain, ref) -> dict:
    """The kernel's (``got``) and the plain version's worst row error
    relative to the row's scale, the position along the sequence (the
    second-last axis) of the kernel's worst row, and the kernel's worst
    error over its allowance."""
    scale = _row_scale(ref)
    err_k, err_p = _row_err(got, ref), _row_err(plain, ref)
    rel_k = (err_k / scale).reshape(-1, *err_k.shape[-1:])
    return {"kernel": rel_k.max().item(),
            "at": int(rel_k.argmax().item()) % rel_k.shape[-1],
            "plain": (err_p / scale).max().item(),
            "over": (err_k / _allowance(plain, ref)).max().item()}


def _flash_f32_reference(q, k, v, dout, g_lse):
    """out, lse, dq, dk, dv of the plain versions in f32 on f32 copies
    of the (bf16) inputs, and the f32 operands the mutants need."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    out, lse = fa._flash_forward_plain(q32, k32, v32)
    dd = (do32 * out).sum(-1) - g_lse
    dq, dk, dv = fa._flash_backward_plain(q32, k32, v32, do32, lse, dd)
    ref = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    return ref, (q32, k32, v32, do32, lse, dd)


def _tile_omission(allow, operands, row0, col0, n):
    """{output: the largest error over its allowance (``allow``, per
    row) in the rows that the n x n tile (q rows row0.., KV columns
    col0..) touches, with that tile left out of every sum}: what a
    kernel that skipped the tile would give, to first order."""
    q32, k32, v32, do32, lse, dd = operands
    h, h_kv, t, d = q32.shape[1], k32.shape[1], q32.shape[2], q32.shape[3]
    rows, cols = slice(row0, row0 + n), slice(col0, col0 + n)
    rep = h // h_kv
    kr = k32[:, :, cols].repeat_interleave(rep, dim=1)
    vr = v32[:, :, cols].repeat_interleave(rep, dim=1)
    qt, dot = q32[:, :, rows], do32[:, :, rows]
    vis = fa._visible(t, t, True, None, 0, None, q32.device)[rows][:, cols]
    s = torch.einsum("bhid,bhjd->bhij", qt, kr) / math.sqrt(d)
    p = torch.where(vis, torch.exp(s - lse[:, :, rows, None]), 0.0)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dot, vr)
              - dd[:, :, rows, None])
    b = q32.shape[0]

    def group_sum(x):
        return x.reshape(b, h_kv, rep, n, d).sum(2)

    missing = {
        "out": (torch.einsum("bhij,bhjd->bhid", p, vr), rows),
        "dq": (torch.einsum("bhij,bhjd->bhid", ds, kr) / math.sqrt(d), rows),
        "dk": (group_sum(torch.einsum("bhij,bhid->bhjd", ds, qt))
               / math.sqrt(d), cols),
        "dv": (group_sum(torch.einsum("bhij,bhid->bhjd", p, dot)), cols),
    }
    return {o: (c.abs().amax(-1) / allow[o][:, :, at]).max().item()
            for o, (c, at) in missing.items()}


def flash_phase(gen) -> dict:
    # every mask form, f32
    for name, (shape, mask) in FLASH_CASES.items():
        q, k, v, dout, g_lse = _flash_inputs(shape, torch.float32, gen)
        pairs = _flash_pairs(q, k, v, dout, g_lse, mask)
        errs = _errors(pairs)
        print(f"f32 {name} {shape} {mask}: " + ", ".join(
            f"{o} {e:.2e}" for o, (e, _) in errs.items()))
        for o, (e, top) in errs.items():
            if not e <= TOL_FLASH_F32 * max(1.0, top):
                raise AssertionError(f"flash {o} disagrees in f32 case "
                                     f"{name}: {e} (largest {top})")
        vis = fa._visible(shape[3], shape[4], mask.get("causal", True),
                          mask.get("window"), mask.get("row_offset", 0),
                          mask.get("prefix"), DEV)
        empty = ~vis.any(-1)
        if empty.any():
            out, dq = pairs["out"][0], pairs["dq"][0]
            lse = pairs["lse"][0][:, :, empty]
            want = (fa.NEG_INF + math.log2(1e-30)) / fa.LOG2E
            print(f"  {int(empty.sum())} rows with an empty band: max |out| "
                  f"{out[:, :, empty].abs().max().item()}, max |dq| "
                  f"{dq[:, :, empty].abs().max().item()}, lse "
                  f"{lse.min().item():.6e}..{lse.max().item():.6e}")
            if (out[:, :, empty] != 0).any() or (dq[:, :, empty] != 0).any() \
                    or not torch.allclose(lse, torch.full_like(lse, want),
                                          rtol=1e-6):
                raise AssertionError("empty-band rows are not out 0, dq 0 "
                                     "and the finite empty lse")

    # the training shapes, bf16
    b, h, h_kv, t, d = FLASH_FULL
    shape = (b, h, h_kv, t, t, d)
    q, k, v, dout, g_lse = _flash_inputs(shape, torch.bfloat16, gen)
    g_lse.zero_()                     # flash_attention's backward: no lse
    pairs = _flash_pairs(q, k, v, dout, g_lse, {})
    errs = _errors(pairs)
    print(f"bf16 {shape} causal, kernel vs plain: " + ", ".join(
        f"{o} {e:.2e} (largest {top:.2e})" for o, (e, top) in errs.items()))
    if not errs["lse"][0] <= TOL_FLASH_LSE:
        raise AssertionError(f"flash lse disagrees in bf16 at full width: "
                             f"{errs['lse'][0]} > {TOL_FLASH_LSE}")
    ref, operands = _flash_f32_reference(q, k, v, dout, g_lse)
    outputs = ("out", "dq", "dk", "dv")
    allow = {o: _allowance(pairs[o][1], ref[o]) for o in outputs}
    omitted = [_tile_omission(allow, operands, r0, c0, FLASH_MUTANT_TILE)
               for r0, c0 in FLASH_MUTANT_TILES]
    del operands
    print("  worst row vs the f32 reference, relative to the row's largest "
          "value (kernel, bf16 plain); kernel's worst error over its "
          "allowance (<= 1 passes); a tile left out, over the allowance "
          "(> 1 is seen)")
    for o in outputs:
        got = _bf16_reading(pairs[o][0], pairs[o][1], ref[o])
        mutants = [m[o] for m in omitted]
        print(f"  {o}: {got['kernel']:.3e} (row {got['at']}), "
              f"{got['plain']:.3e}; {got['over']:.3f}; " + ", ".join(
                  f"tile {r0},{c0} {m:.1f}"
                  for m, (r0, c0) in zip(mutants, FLASH_MUTANT_TILES)))
        if not got["over"] <= 1.0:
            raise AssertionError(f"flash {o} disagrees in bf16 at full "
                                 f"width: {got['over']} of its allowance")
        if not min(mutants) > 1.0:
            raise AssertionError(f"the bf16 allowance on {o} would not see "
                                 f"a tile left out ({mutants})")
    del ref, pairs, allow
    torch.cuda.empty_cache()

    # timings with a cold L2, bounds and library yardsticks
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    out, lse = fa.flash_forward(q, k, v)
    dd = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, dout, lse, dd)
    ms = {
        "flash_forward": time_ms(lambda: fa.flash_forward(q, k, v),
                                 flush=flush),
        "flash_backward_dq": time_ms(lambda: fa.flash_backward_dq(*args),
                                     flush=flush),
        "flash_backward_dkv": time_ms(lambda: fa.flash_backward_dkv(*args),
                                      flush=flush),
    }
    plain_ms = {
        "flash_forward": time_ms(lambda: fa._flash_forward_plain(q, k, v),
                                 iters=5, flush=flush),
        "flash_backward_dq": time_ms(
            lambda: fa._flash_backward_dq_plain(*args), iters=5, flush=flush),
        "flash_backward_dkv": time_ms(
            lambda: fa._flash_backward_dkv_plain(*args), iters=5,
            flush=flush),
    }
    torch.cuda.empty_cache()
    # yardsticks only (the port never calls them): SDPA's forward, and
    # its backward, one time for dq, dk and dv together
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush=flush)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                             enable_gqa=True)
    lib_err = (lib_out.float() - out.float()).abs().max().item()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), dout, retain_graph=True), flush=flush)
    del lib_out
    library_ms = {"flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
                  "flash_backward_dkv": lib_bwd}

    # bounds from this run's inputs: each input read once, each output
    # written once; 4 d (B1), 6 d (B2), 8 d (B3) flops per visible pair
    vis = fa._visible(t, t, True, None, 0, None, DEV)
    pairs = b * h * int(vis.sum().item())
    qb, kvb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rowb = b * h * t * 4                              # lse or D, f32
    work = {
        "flash_forward": (2 * qb + 2 * kvb + rowb, 4 * d * pairs),
        "flash_backward_dq": (3 * qb + 2 * kvb + 2 * rowb, 6 * d * pairs),
        "flash_backward_dkv": (2 * qb + 4 * kvb + 2 * rowb, 8 * d * pairs),
    }
    result = {}
    for name, _ in FLASH_KERNELS:
        n_bytes, n_flops = work[name]
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        err = {"flash_forward": errs["out"][0],
               "flash_backward_dq": errs["dq"][0],
               "flash_backward_dkv": max(errs["dk"][0], errs["dv"][0])}[name]
        result[name] = {
            "max_abs_err": err, "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": library_ms[name], "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"{name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms, SDPA {library_ms[name]:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({n_bytes} bytes, {n_flops} flops); "
              f"kernel at {100 * bound_ms / ms[name]:.1f}% of bound")
    print(f"SDPA backward is one time for dq, dk and dv together; "
          f"max |SDPA out - B1 out| {lib_err:.2e}")
    return result


def small_training_phase() -> None:
    rng = np.random.RandomState(5)
    b, t = SMALL_TRAIN_BATCH
    batch = tuple(torch.from_numpy(rng.randint(0, SMALL_TRAIN.vocab, (b, t))
                                   .astype(np.int32)) for _ in range(2))
    wrappers = _flash_wrappers()
    results = {}
    for dev in (DEV, "cpu"):
        params = init_params(SMALL_TRAIN, 0, device=dev)
        step, init = tt.make_train_step(
            SMALL_TRAIN, optimizer=tt.default_optimizer(warmup_steps=1),
            attn_fn=fa.flash_attention)
        state = init(params)
        on_dev = tuple(x.to(dev) for x in batch)
        for w in wrappers.values():
            w.launches = 0
        losses = [step(params, state, on_dev)[2].item() for _ in range(3)]
        counts = {n: w.launches for n, w in wrappers.items()}
        results[dev] = (losses, [x.detach().cpu()
                                 for x in tt._param_leaves(params)], counts)
    (card, card_p, counts), (cpu, cpu_p, _) = results[DEV], results["cpu"]
    expect = SMALL_TRAIN.n_layers * 3          # no remat: once per layer
    print(f"losses card {card}, cpu {cpu}; card launches {counts}")
    if counts != {n: expect for n in wrappers}:
        raise AssertionError(f"card steps launched {counts}, expected "
                             f"{expect} of each flash kernel")
    if not all(math.isfinite(x) for x in card) or any(
            abs(a - c) > TOL_TRAIN_LOSS_REL * abs(c)
            for a, c in zip(card, cpu)):
        raise AssertionError("card and CPU training losses disagree")
    lr_max = tt.default_optimizer(warmup_steps=1).learning_rate(1)
    worst, beyond, total = 0.0, 0, 0
    for a, c in zip(card_p, cpu_p):
        diff = (a - c).abs()
        worst = max(worst, diff.max().item())
        beyond += int((diff > TOL_TRAIN_PARAM).sum())
        total += diff.numel()
    print(f"params after 3 steps: max |card - cpu| {worst:.2e}, "
          f"{beyond} of {total} beyond {TOL_TRAIN_PARAM:.0e}")
    if worst > 2 * 3 * lr_max or beyond > 1e-2 * total:
        raise AssertionError("card and CPU params disagree after 3 steps")
    # the entry point: the same seeded loss on the card and on the CPU
    fn, args = entry.entry(device=DEV)
    got = fn(*args).item()
    fn, args = entry.entry(device="cpu")
    want = fn(*args).item()
    print(f"entry() loss card {got:.6f}, cpu {want:.6f}")
    if not abs(got - want) <= 2 ** -7 * abs(want):
        raise AssertionError("entry() loss differs between card and CPU")


def _fresh(node, dev, dtype=None):
    """A copy of a params subtree on ``dev`` (every leaf cast to
    ``dtype`` when one is given) whose leaves require grad."""
    if isinstance(node, dict):
        return {k: _fresh(v, dev, dtype) for k, v in node.items()}
    x = node.detach().to(dev)
    return (x if dtype is None else x.to(dtype)).clone().requires_grad_()


def _block_check(layer) -> None:
    """One full-width block at b=1, loss mean(block(x)^2), in bf16 on the
    card and on the CPU and in f32 on the CPU. The loss and every
    gradient (x's and the layer's) are held row by row against the f32
    run, the bf16 CPU run setting each row's allowance
    (:func:`_allowance`)."""
    t, d = FULL_TRAIN_BATCH[1], FULL_TRAIN.d_model
    block = tt._make_block(FULL_TRAIN, fa.flash_attention)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, t, d), generator=gen).to(FULL_TRAIN.dtype)
    results = {}
    for run, dev, dtype in (("card", DEV, None), ("cpu", "cpu", None),
                            ("f32", "cpu", torch.float32)):
        t0 = time.perf_counter()
        lay = _fresh(layer, dev, dtype)
        xx = x.to(dev, dtype or x.dtype).requires_grad_()
        loss = block(xx, lay).float().square().mean()
        leaves = [xx] + tt._param_leaves(lay)
        grads = torch.autograd.grad(loss, leaves)
        results[run] = [loss.detach().float().cpu()] + [
            g.float().cpu() for g in grads]
        print(f"  block {run} on {dev}: {time.perf_counter() - t0:.1f} s")
    names = ["loss", "x", "ln1.g", "wqkv", "wo", "ln2.g", "w_up", "w_down"]
    finite = all(torch.isfinite(a).all() for a in results["card"])
    print(f"one block, b=1, bf16: worst row vs f32 on the CPU relative to "
          f"the row's largest value (card, cpu); card's worst error over "
          f"its allowance (<= 1 passes); finite {finite}")
    bad = []
    for n, a, c, ref in zip(names, results["card"], results["cpu"],
                            results["f32"]):
        got = _bf16_reading(a, c, ref)
        print(f"  {n}: {got['kernel']:.3e}, {got['plain']:.3e}; "
              f"{got['over']:.3f}")
        if not got["over"] <= 1.0:
            bad.append(n)
    if not finite or bad:
        raise AssertionError(f"full-width block: the card's bf16 run is "
                             f"off the f32 reference in {bad}")


# kernel-name fragments -> the part of the training step they belong to
KERNEL_GROUPS = (
    ("flash forward (B1)", ("flash_fwd_kernel",)),
    ("flash dq (B2)", ("flash_bwd_dq_kernel",)),
    ("flash dk/dv (B3)", ("flash_bwd_dkv_kernel",)),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)


def _profile_step(run_step, step_ms: float) -> None:
    """Device time by kernel over one more training step under
    ``torch.profiler``, grouped as in ``KERNEL_GROUPS`` (everything else
    is elementwise, reductions and copies), against the timed step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("profiled step: the profiler recorded no device time "
              "(breakdown not measured)")
        return
    busy = sum(ms for _, ms, _ in kernels)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, reductions, copies)"] = 0.0
    for key, ms, _ in kernels:
        low = key.lower()
        name = next((g for g, frags in KERNEL_GROUPS
                     if any(f in low for f in frags)),
                    "other (elementwise, reductions, copies)")
        groups[name] += ms
    print(f"profiled step: {len(kernels)} kernel names, device busy "
          f"{busy:.2f} ms against the timed {step_ms:.2f} ms/step")
    for name, ms in groups.items():
        print(f"  {name}: {ms:.2f} ms ({100 * ms / busy:.1f}% of busy)")
    for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}")


def full_width_training_phase(card: str, flash: dict) -> dict:
    t0 = time.perf_counter()
    params = init_params(FULL_TRAIN, 0, device=DEV)
    n_params = tt.param_count(params)
    b, t = FULL_TRAIN_BATCH
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, FULL_TRAIN.vocab, (b, t), generator=gen,
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)       # as the reference's training benchmark
    step, init = tt.make_train_step(FULL_TRAIN,
                                    optimizer=tt.default_optimizer(),
                                    attn_fn=fa.flash_attention)
    state = init(params)
    print(f"{n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)    # untimed
    first = loss.item()
    print(f"untimed first step {time.perf_counter() - t0:.2f} s, loss "
          f"{first:.4f}")

    wrappers = _flash_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = []
    for _ in range(TIMED_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    losses = [x.item() for x in losses]
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    flops_per_token = 6 * n_params + 6 * FULL_TRAIN.n_layers * t \
        * FULL_TRAIN.d_model
    print(f"{card}: {TIMED_STEPS} steps of {b}x{t}: {step_ms:.2f} ms/step "
          f"(device events; wall {1e3 * wall / TIMED_STEPS:.2f} ms/step), "
          f"{b * t / step_ms * 1e3:.1f} tokens/s, "
          f"{b * t * flops_per_token / step_ms / 1e9:.1f} model TFLOP/s "
          f"(6N + attention per token), peak memory {peak / 2**30:.2f} GiB; "
          f"losses {losses}")
    for name, _ in FLASH_KERNELS:
        per_step = launches[name] / TIMED_STEPS
        share = per_step * flash[name]["ms"] / step_ms
        print(f"  {name}: {launches[name]} launches ({per_step:g} per "
              f"step) x {flash[name]['ms']:.3f} ms = {100 * share:.1f}% of "
              f"the step")
    n_l = FULL_TRAIN.n_layers * TIMED_STEPS
    # the forward runs once per layer, and again when the backward
    # recomputes the checkpointed block (the kernel is opaque to the
    # selective policy, so its outputs are not saved)
    expect = {"flash_forward": 2 * n_l, "flash_backward_dq": n_l,
              "flash_backward_dkv": n_l}
    if launches != expect:
        raise AssertionError(f"flash kernels launched {launches}, expected "
                             f"{expect}")
    lo, hi = FIRST_LOSS_RANGE
    if not all(math.isfinite(x) for x in [first] + losses) \
            or not lo <= first <= hi:
        raise AssertionError(f"full-width losses {[first] + losses}: not "
                             f"finite, or the first outside [{lo}, {hi}]")
    _profile_step(lambda: step(params, state, batch), step_ms)
    layer = tt.unstack_layer_params(params)["layers"][0]
    del state
    torch.cuda.empty_cache()
    _block_check(layer)
    return launches


def _to_cpu(node):
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cpu(v) for v in node]
    return node.cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    # fp32 products in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    phase("build")
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(_build.build, KERNEL_SOURCES))
    for path, seconds, log in built:
        print(f"{path.name}: nvcc {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("  " + line.strip())

    phase("paged kernel vs plain version, full-width shapes")
    gen = torch.Generator().manual_seed(0)
    kern = kernel_phase(gen)

    phase("flash kernels vs plain versions")
    flash = flash_phase(gen)

    phase("engine on the card vs on the CPU (fp32, small)")
    small_engine_phase()

    phase("full-width serving")
    served = full_width_phase(smi)

    phase("training on the card vs on the CPU (fp32, small)")
    small_training_phase()

    phase("full-width training")
    launches = full_width_training_phase(smi, flash)

    rows = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "tpu_dra_driver_torch/workloads/csrc/paged_attention.cu",
        "replaces": "tpu_dra_driver/workloads/ops/paged_attention.py:112",
        "launches": served["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
    }]
    for name, replaces in FLASH_KERNELS:
        row = flash[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source":
                "tpu_dra_driver_torch/workloads/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": launches[name],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        })
    print(json.dumps({"kernels": rows}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
