#!/usr/bin/env python3
"""B2 and B3, the bf16 flash backward (dq; dk and dv), built from several
versions of ``csrc/flash_attention.cu`` and read side by side in one
process on one card, so that each step of a redesign is read against the
same parent. It shares ``flash_fwd_steps.py``'s build, report and
checks. For each version (``LABEL=PATH`` to a flash_attention.cu):

- the build report (``flash_fwd_steps.build_versions``): ptxas's wgmma
  notes and spill bytes of every sm90 flash instantiation; with
  ``--sass`` the counts of BSSY, BSYNC, WARPGROUP.ARRIVE,
  WARPGROUP.DEPBAR and HGMMA in each kernel's SASS and a digest of its
  instructions, B2's listings written to ``--out`` (default
  ``build/flash_bwd_steps/``);
- chip_smoke's bf16 mask cases, its schedule cases (each with tiles
  left out) and B1-B3 at the training shape run twice and replayed from
  a CUDA graph (``flash_fwd_steps.checks``);
- B2 and B3 at each of ``flash_fwd_steps.SHAPES`` on the same inputs
  (one forward's out and lse): dq, dk and dv row by row against the f32
  reference within their allowance (``chip_smoke._bf16_reading``), and
  each kernel's time with a cold L2 (``chip_smoke.time_ms``), the
  versions in turns (first to last, then last to first), beside SDPA's
  one backward and each kernel's bound (6 d flops a visible pair for
  B2, 8 d for B3, or its bytes over 3.35 TB/s).

With ``--probe LABEL`` two readings of the timing itself, on that
version: B2 at the training shape timed right after 50 calls of each
version's B1 (the card's state after B1 is all that differs), and B3 at
t = 512 timed as chip_smoke times it (an event pair around each call
after a flush), without the flush, back to back (one event pair around
50 calls), and by the host's time to enqueue one call.

Needs one CUDA card. From the repo root, e.g.
``python3 tools/flash_bwd_steps.py --sass --probe parent
parent=OLD/flash_attention.cu
new=tpu_dra_driver_torch/workloads/csrc/flash_attention.cu``;
``--build-only`` stops after the build report.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
import flash_fwd_steps as fs  # noqa: E402

cs, fa = fs.cs, fs.fa
OUTPUTS = {"dq": "flash_backward_dq", "dkv": "flash_backward_dkv"}


def inputs(shape, mask):
    """(q, k, v, dO, lse, D) at ``shape`` from a fixed seed, through the
    loaded version's B1, with D = rowsum(dO * O) as flash_attention's
    backward forms it."""
    q, k, v, dout, _ = cs._flash_inputs(shape, torch.bfloat16,
                                        torch.Generator().manual_seed(1))
    out, lse = fa.flash_forward(q, k, v, **mask)
    dd = (dout.float() * out.float()).sum(-1)
    return q, k, v, dout, lse, dd


def calls(args, mask):
    return {"dq": lambda: fa.flash_backward_dq(*args, **mask),
            "dkv": lambda: fa.flash_backward_dkv(*args, **mask)}


def bounds(q, k, mask) -> dict:
    """{kernel: (bound ms, what bounds it)} from the shape's visible
    pairs, as chip_smoke's ``_flash_rows`` counts them."""
    b, h, t, d = q.shape
    vis = fa._visible(t, k.shape[2], mask.get("causal", True),
                      mask.get("window"), mask.get("row_offset", 0),
                      mask.get("prefix"), cs.DEV)
    pairs = b * h * int(vis.sum().item())
    qb, kvb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rowb = b * h * t * 4
    work = {"dq": (3 * qb + 2 * kvb + 2 * rowb, 6 * d * pairs),
            "dkv": (2 * qb + 4 * kvb + 2 * rowb, 8 * d * pairs)}
    found = {}
    for name, (n_bytes, n_flops) in work.items():
        t_bytes = n_bytes / cs.HBM_BYTES_PER_S
        t_ops = n_flops / cs.BF16_FLOP_PER_S
        found[name] = (max(t_bytes, t_ops) * 1e3,
                       "operations" if t_ops >= t_bytes else "bytes")
    return found


def sdpa_backward_ms(q, k, v, dout, mask, flush) -> float:
    """SDPA's one backward (dq, dk and dv together) under the same mask:
    a yardstick, never called by the port."""
    t, tkv = q.shape[2], k.shape[2]
    if "window" in mask:
        kw = {"attn_mask": fa._visible(t, tkv, True, mask["window"], 0,
                                       None, cs.DEV)}
    else:
        kw = {"is_causal": mask.get("causal", True) and "prefix" not in mask}
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, enable_gqa=True, **kw)
    return cs.time_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), dout, retain_graph=True), flush=flush)


def row_overs(got_dq, got_dkv, plain, ref) -> dict:
    """{output: the kernel's worst row over its allowance}"""
    got = {"dq": got_dq, "dk": got_dkv[0], "dv": got_dkv[1]}
    return {o: cs._bf16_reading(got[o], plain[o], ref[o])["over"]
            for o in got}


def shape_readings(libs, name, shape, mask, flush, failed) -> dict:
    fs.use(libs[next(iter(libs))])
    q, k, v, dout, lse, dd = inputs(shape, mask)
    args = (q, k, v, dout, lse, dd)
    ref, _ = cs._flash_f32_reference(q, k, v, dout,
                                     torch.zeros_like(lse), mask)
    ref = {o: ref[o] for o in ("dq", "dk", "dv")}
    plain = {"dq": fa._flash_backward_dq_plain(*args, **mask)}
    plain["dk"], plain["dv"] = fa._flash_backward_dkv_plain(*args, **mask)
    order = list(libs) + list(libs)[::-1]
    ms = {label: {"dq": [], "dkv": []} for label in libs}
    for label in order:
        fs.use(libs[label])
        run = calls(args, mask)
        if not ms[label]["dq"]:
            over = row_overs(run["dq"](), run["dkv"](), plain, ref)
            print(f"{name} {shape} {mask or 'causal'} {label}: worst row "
                  f"over its allowance " + ", ".join(
                      f"{o} {x:.3f}" for o, x in over.items()))
            if not max(over.values()) <= 1.0:
                failed.append(f"{label} at {name}")
        for kernel, fn in run.items():
            ms[label][kernel].append(cs.time_ms(fn, iters=30, flush=flush))
    del ref, plain
    torch.cuda.empty_cache()
    lib_ms = sdpa_backward_ms(q, k, v, dout, mask, flush)
    bound = bounds(q, k, mask)
    for label, times in ms.items():
        both = [x + y for x, y in zip(times["dq"], times["dkv"])]
        print(f"{name} {label}: " + "; ".join(
            f"{OUTPUTS[kn]} {t[0]:.4f} / {t[1]:.4f} ms "
            f"({100 * bound[kn][0] * 2 / (t[0] + t[1]):.1f}% of the "
            f"{bound[kn][0]:.4f} ms {bound[kn][1]} bound)"
            for kn, t in times.items())
            + f"; B2 + B3 {min(both):.4f}-{max(both):.4f}, "
            f"{min(both) / lib_ms:.2f}-{max(both) / lib_ms:.2f}x SDPA's "
            f"backward {lib_ms:.4f}")
    return {"shape": shape, "mask": mask, "sdpa_backward_ms": lib_ms,
            "bound_ms": {OUTPUTS[k]: b for k, b in bound.items()},
            "ms": ms}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def probe(libs, label, flush) -> dict:
    """The two timing readings of the module docstring, on ``label``."""
    found = {"b2_after_b1": {}}
    shape, mask = fs.SHAPES["train"]
    fs.use(libs[label])
    q, k, v, dout, lse, dd = inputs(shape, mask)
    args = (q, k, v, dout, lse, dd)
    for b1 in list(libs) + list(libs)[::-1]:
        fs.use(libs[b1])
        cs.time_ms(lambda: fa.flash_forward(q, k, v), flush=flush)
        fs.use(libs[label])
        after = cs.time_ms(calls(args, mask)["dq"], flush=flush)
        found["b2_after_b1"].setdefault(b1, []).append(after)
        print(f"probe: {label}'s B2 right after 50 calls of {b1}'s B1: "
              f"{after:.4f} ms (card: {smi()})")
    time.sleep(2.0)
    found["b2_after_idle"] = cs.time_ms(calls(args, mask)["dq"],
                                        flush=flush)
    print(f"probe: {label}'s B2 after 2 s idle: "
          f"{found['b2_after_idle']:.4f} ms (card: {smi()})")
    del q, k, v, dout, lse, dd, args

    shape, mask = fs.SHAPES["causal_t512"]
    q, k, v, dout, lse, dd = inputs(shape, mask)
    dkv = calls((q, k, v, dout, lse, dd), mask)["dkv"]
    found["b3_t512_per_call_flushed"] = cs.time_ms(dkv, flush=flush)
    found["b3_t512_per_call"] = cs.time_ms(dkv)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(50):
        dkv()
    end.record()
    host = (time.perf_counter() - t0) / 50 * 1e3
    end.synchronize()
    found["b3_t512_back_to_back"] = start.elapsed_time(end) / 50
    found["b3_t512_host_ms_per_call"] = host
    t0 = time.perf_counter()
    flush.zero_()
    end.record()
    end.synchronize()
    found["flush_ms_wall"] = (time.perf_counter() - t0) * 1e3
    print("probe: B3 at t = 512 " + ", ".join(
        f"{k[len('b3_t512_'):]} {v:.4f} ms" for k, v in found.items()
        if k.startswith("b3_t512")) + f"; one flush {found['flush_ms_wall']:.4f}"
        " ms on the wall")
    return found


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("versions", nargs="+", metavar="LABEL=PATH")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--build-only", action="store_true")
    parser.add_argument("--probe", metavar="LABEL")
    parser.add_argument("--shapes", default=",".join(fs.SHAPES),
                        help="comma-separated names of SHAPES")
    parser.add_argument("--out", type=Path,
                        default=fs.REPO / "build" / "flash_bwd_steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_steps: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card(quiet=True))
    libs = fs.build_versions(args.versions, args.sass, args.out,
                             listed="flash_bwd_dq_kernel_sm90")
    if args.build_only:
        return 0

    failed = []
    for label, lib in libs.items():
        print(f"== {label}: checks")
        fs.use(lib)
        try:
            fs.checks(torch.Generator().manual_seed(0))
        except AssertionError as e:
            print(f"{label} FAILED its checks: {e}")
            failed.append(label)

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=cs.DEV)
    readings = {name: shape_readings(libs, name, *fs.SHAPES[name], flush,
                                     failed)
                for name in args.shapes.split(",")}
    if args.probe:
        readings["probe"] = probe(libs, args.probe, flush)
    print("flash_bwd_steps readings: " + json.dumps(readings))
    if failed:
        print(f"flash_bwd_steps: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
