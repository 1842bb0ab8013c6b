#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_dra_driver_torch``).

Drives the port's serving path on one CUDA card and checks it; imports
no JAX. Phases, each of which fails the run when it fails:

1. card: the card's name and power limit from nvidia-smi;
2. build: the CUDA kernels from the sources in the checkout (nvcc,
   sm_90a);
3. kernel: the paged-attention decode kernel against its plain PyTorch
   version at the full-width serving shapes, in bf16 (timed, with its
   bound and a library call as yardstick) and in f32;
4. engine parity: the ``ServingTraffic`` configuration in fp32 through
   the engine on the card and on the CPU, same weights and prompts;
5. serving: the full-width serving configuration (vocab 8192, d_model
   1024, 8 heads over 4 KV heads, 6 layers, RoPE, bf16; six prompts of
   256-512 tokens, 96 new tokens each) through ``ServingEngine.run``,
   with the kernel's launches counted over that run.

It then prints one ``{"kernels": [...]}`` line and, last, the device
line ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero and prints no result.

Run from the repo root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dra_driver_torch.workloads.models.serving import (
    ServingEngine, paged_decode_step,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, init_params,
)
from tpu_dra_driver_torch.workloads.ops import _build
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
    n_params = sum(t.numel() for t in _leaves(params))
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


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


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
    path, seconds, log = _build.build("paged_attention")
    print(f"{path.name}: nvcc {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase("kernel vs plain version, full-width shapes")
    gen = torch.Generator().manual_seed(0)
    kern = kernel_phase(gen)

    phase("engine on the card vs on the CPU (fp32, small)")
    small_engine_phase()

    phase("full-width serving")
    served = full_width_phase(smi)

    print(json.dumps({"kernels": [{
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
    }]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
