#!/usr/bin/env python3
"""B1, the bf16 flash forward, built from several versions of
``csrc/flash_attention.cu`` and read side by side in one process on one
card, so that each step of a redesign is read against the same parent.
For each version (``LABEL=PATH`` to a flash_attention.cu):

- nvcc with the port's flags (``ops/_build.py``), all versions at once;
  ptxas's report for each sm90 flash instantiation: injected
  ``warpgroup.arrive`` notes (C7519) and spill bytes; with ``--sass``,
  the counts of BSSY, BSYNC, WARPGROUP.ARRIVE, WARPGROUP.DEPBAR and
  HGMMA in each sm90 flash kernel's SASS (``cuobjdump``) and a digest of
  its instructions, whose B1 listings are written to ``--out`` (default
  ``build/flash_fwd_steps/``);
- chip_smoke's bf16 mask cases and its schedule cases, B1's and the
  backward's (each output row within its allowance of an f32 reference,
  a tile left out shown to break it), and B1-B3 at the training shape
  run twice and replayed from a CUDA graph
  (``chip_smoke._flash_rerun_and_graph``);
- B1 at each of SHAPES: its out row by row against the f32 reference,
  its lse against it, and its time with a cold L2
  (``chip_smoke.time_ms``), the versions in turns (first to last, then
  last to first), beside SDPA's forward and the bound from the shape's
  visible pairs (operations over 989 TFLOP/s or bytes over 3.35 TB/s).

Needs one CUDA card. From the repo root, e.g.
``python3 tools/flash_fwd_steps.py --sass parent=OLD/flash_attention.cu
new=tpu_dra_driver_torch/workloads/csrc/flash_attention.cu``;
``--build-only`` stops after the build report.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from tpu_dra_driver_torch.workloads.ops import _build  # noqa: E402
from tpu_dra_driver_torch.workloads.ops import attention as fa  # noqa: E402

# name -> ((b, h, h_kv, t, tkv, d), mask): the shapes at which the port
# runs B1 (chip_smoke's FLASH_FULL, its bidirectional, FLASH_CROSS and
# FLASH_DEC_CAUSAL reads, FLASH_MHA, the training ring's hop, the HD256
# training shape and FLASH_LONG's window)
SHAPES = {
    "train": ((8, 16, 4, 2048, 2048, 128), {}),
    "bidirectional": ((8, 16, 4, 2048, 2048, 128), {"prefix": 2048}),
    "cross": ((8, 16, 4, 512, 2048, 128), {"causal": False}),
    "causal_t512": ((8, 16, 4, 512, 512, 128), {}),
    "bench_mha": ((4, 8, 8, 2048, 2048, 128), {}),
    "ring_hop": ((8, 16, 4, 512, 512, 128), {"causal": False}),
    "hd256": ((8, 8, 1, 2048, 2048, 256), {}),
    "long_window": ((1, 8, 8, 16384, 16384, 128), {"window": 2048}),
}


def build(label: str, source: Path):
    """(library, nvcc's log) of ``source`` built with the port's flags."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(_build.NVCC_FLAGS).encode())
    lib = (_build.BUILD_DIR
           / f"flash_steps-{label}-{digest.hexdigest()[:12]}.so")
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label} ({source}):\n{log}")
    log_path.write_text(log)
    return lib, log


# SASS instructions counted per sm90 flash kernel: convergence barriers
# (a branch around each masked score leaves a BSSY/BSYNC pair), injected
# and written arrives, waits and products
SASS_OPS = ("BSSY", "BSYNC", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "HGMMA")


def sass_report(label: str, lib: Path, out_dir: Path,
                listed: str = "flash_fwd_kernel_sm90") -> None:
    """Per sm90 flash kernel, its counts of SASS_OPS and a digest of its
    instructions (without addresses, so that two builds of the same code
    read the same); the listings of the ``listed`` kernel written to
    ``out_dir`` with their order of products, waits, barriers and
    exponentials."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        kernel = cs.SM90_FLASH_KERNEL.search(name)
        if kernel is None:
            continue
        counts = {op: len(re.findall(op.replace(".", r"\.") + r"\b", part))
                  for op in SASS_OPS}
        code = re.sub(r"/\*[0-9a-f]{4,}\*/|0x[0-9a-f]+|\.L_x_\d+", "",
                      part.split("\n", 1)[1])
        digest = hashlib.sha256(code.encode()).hexdigest()[:12]
        print(f"  {label} {kernel.group(1)}<{kernel.group(2)}> SASS: "
              + ", ".join(f"{op} {n}" for op, n in counts.items())
              + f"; digest {digest}")
        if kernel.group(1) == listed:
            (out_dir / f"{label}-{listed}-{kernel.group(2)}.sass"
             ).write_text(part)
            print(f"    in order: {sass_order(part)}")


def sass_order(listing: str) -> str:
    """A listing as the order of its products (H: a run of HGMMA),
    waits (W0, W1: WARPGROUP.DEPBAR.LE to 0 or 1 pending), named
    barriers (S: BAR.SYNC, A: BAR.ARV) and exponentials (E: a run of at
    least 8 MUFU.EX2), to show which waits precede the softmax."""
    runs = []                         # [mark, count]
    for line in listing.splitlines():
        if "HGMMA" in line:
            mark = "H"
        elif "WARPGROUP.DEPBAR.LE" in line:
            mark = "W" + re.search(r"DEPBAR\.LE gsb0, 0x(\d)", line).group(1)
        elif "BAR.SYNC" in line:
            mark = "S"
        elif "BAR.ARV" in line:
            mark = "A"
        elif "MUFU.EX2" in line:
            mark = "E"
        else:
            continue
        if runs and runs[-1][0] == mark and mark in "HE":
            runs[-1][1] += 1
        else:
            runs.append([mark, 1])
    return " ".join(m for m, n in runs if m != "E" or n >= 8)


def build_versions(specs, sass: bool, out_dir: Path,
                   listed: str = "flash_fwd_kernel_sm90") -> dict:
    """{label: library} of ``LABEL=PATH`` specs, built in parallel, with
    ptxas's wgmma notes and spill bytes of every sm90 flash kernel
    printed (and, with ``sass``, sass_report's counts)."""
    versions = [v.split("=", 1) for v in specs]
    with ThreadPoolExecutor(len(versions)) as pool:
        built = list(pool.map(lambda lv: build(lv[0], Path(lv[1])),
                              versions))
    libs = {}
    for (label, _), (lib, log) in zip(versions, built):
        libs[label] = lib
        notes, spills = cs._wgmma_notes(log), cs._spills(log)
        for fn in sorted(notes):
            kernel = cs.SM90_FLASH_KERNEL.search(fn)
            if kernel:
                print(f"{label} {kernel.group(1)}<{kernel.group(2)}>: "
                      f"ptxas's wgmma notes {notes[fn]}, spill bytes "
                      f"{spills.get(fn)}")
        if sass:
            sass_report(label, lib, out_dir, listed)
    return libs


def use(lib: Path) -> None:
    """Routes ``fa``'s wrappers to ``lib`` (the argtypes are set on it by
    ``fa._kernel_library`` at its first call)."""
    loaded = ctypes.CDLL(str(lib))
    _build.load = lambda name: loaded


def checks(gen) -> None:
    for name, (shape, mask) in cs.FLASH_BF16_CASES.items():
        cs._flash_bf16_case(name, shape, mask, gen)
    for cases in (cs.FLASH_SCHEDULE_CASES, cs.FLASH_BWD_SCHEDULE_CASES):
        for name, (shape, mask, tiles) in cases.items():
            cs._flash_bf16_case(name, shape, mask, gen, tiles)
    cs._flash_rerun_and_graph(gen)


def sdpa_ms(q, k, v, mask, flush):
    t, tkv = q.shape[2], k.shape[2]
    if "window" in mask:
        vis = fa._visible(t, tkv, True, mask["window"], 0, None, cs.DEV)
        kw = {"attn_mask": vis}
    else:
        kw = {"is_causal": mask.get("causal", True) and "prefix" not in mask}
    return cs.time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw), flush=flush)


def bound_ms(q, k, mask) -> tuple:
    b, h, t, d = q.shape
    vis = fa._visible(t, k.shape[2], mask.get("causal", True),
                      mask.get("window"), mask.get("row_offset", 0),
                      mask.get("prefix"), cs.DEV)
    flops = 4 * d * b * h * int(vis.sum().item())
    n_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + b * h * t * 4
    t_ops, t_bytes = flops / cs.BF16_FLOP_PER_S, n_bytes / cs.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("versions", nargs="+", metavar="LABEL=PATH")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--build-only", action="store_true")
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "flash_fwd_steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_steps: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card(quiet=True))
    libs = build_versions(args.versions, args.sass, args.out)
    if args.build_only:
        return 0

    failed = []
    for label, lib in libs.items():
        print(f"== {label}: checks")
        use(lib)
        try:
            checks(torch.Generator().manual_seed(0))
        except AssertionError as e:
            print(f"{label} FAILED its checks: {e}")
            failed.append(label)

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=cs.DEV)
    order = list(libs) + list(libs)[::-1]
    readings = {}
    for name, (shape, mask) in SHAPES.items():
        q, k, v, _, _ = cs._flash_inputs(
            shape, torch.bfloat16, torch.Generator().manual_seed(1))
        plain, _ = fa._flash_forward_plain(q, k, v, **mask)
        ref, ref_lse = fa._flash_forward_plain(q.float(), k.float(),
                                               v.float(), **mask)
        empty = cs._empty_rows(shape, mask)
        ms = {label: [] for label in libs}
        for label in order:
            use(libs[label])
            out, lse = fa.flash_forward(q, k, v, **mask)
            over = cs._bf16_reading(out, plain, ref)["over"]
            lse_err = (lse - ref_lse)[:, :, ~empty].abs().max().item()
            if len(ms[label]) == 0:
                print(f"{name} {shape} {mask or 'causal'} {label}: out's "
                      f"worst row at {over:.3f} of its allowance, lse "
                      f"{lse_err:.2e}")
                if not (over <= 1.0 and lse_err <= cs.TOL_FLASH_LSE):
                    failed.append(f"{label} at {name}")
            ms[label].append(cs.time_ms(
                lambda: fa.flash_forward(q, k, v, **mask), iters=30,
                flush=flush))
        lib_ms = sdpa_ms(q, k, v, mask, flush)
        bound, by = bound_ms(q, k, mask)
        readings[name] = {"shape": shape, "mask": mask, "sdpa_ms": lib_ms,
                          "bound_ms": bound, "bound_by": by, "ms": ms}
        for label, times in ms.items():
            mean = sum(times) / len(times)
            print(f"{name} {label}: {times[0]:.4f} / {times[1]:.4f} ms "
                  f"({100 * bound / mean:.1f}% of the {bound:.4f} ms "
                  f"{by} bound, {mean / lib_ms:.2f}x SDPA's {lib_ms:.4f})")
        del q, k, v, plain, ref, ref_lse
        torch.cuda.empty_cache()
    print("flash_fwd_steps readings: " + json.dumps(readings))
    if failed:
        print(f"flash_fwd_steps: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
