#!/usr/bin/env python3
"""B1, the bf16 flash forward, built from several versions of
``csrc/flash_attention.cu`` and read side by side in one process on one
card, so that each step of a redesign is read against the same parent.
For each version (``LABEL=PATH`` to a flash_attention.cu):

- nvcc with the port's flags (``ops/_build.py``), every build at once:
  the version and, with ``--probes``, those of B1's pace probes that its
  source has (``-DB1_PACE=n``: ``copy``, the producer and every wait
  with no product and no softmax; ``products``, S and P V with the
  softmax cut to a cast; ``softmax``, the softmax with no product and
  no K or V; ``nopingpong``, no named barriers; ``fixed``, every walk cut
  to zero tiles); a version or probe that does not build is reported
  and left out. ptxas's report for each sm90 flash instantiation:
  wgmma notes (C7510-C7520) and spill bytes; with ``--sass``, the
  counts of BSSY, BSYNC, WARPGROUP.ARRIVE, WARPGROUP.DEPBAR and HGMMA
  in each sm90 flash kernel's SASS (``cuobjdump``) and a digest of its
  instructions, B1's loop order (``chip_smoke.sass_order``) and its
  listings written to ``--out`` (default ``build/flash_fwd_steps/``);
- chip_smoke's bf16 mask cases and its schedule cases, B1's and the
  backward's (each output row within its allowance of an f32 reference,
  a tile left out shown to break it), and B1-B3 at the training shape
  run twice and replayed from a CUDA graph
  (``chip_smoke._flash_rerun_and_graph``), for each version (not the
  probes, whose outputs are not the function's);
- B1 at each of SHAPES (``--shapes`` picks some): each version's out row
  by row against the f32 reference and its lse against it, then every
  (version, probe) timed with a cold L2 (``chip_smoke.time_ms``) in
  turns (first to last, then last to first, ``--turns`` of them, two by
  default), beside SDPA's forward and
  the bound from the shape's visible pairs (operations over 989 TFLOP/s
  or bytes over 3.35 TB/s), as ms a call and as us a KV tile of a CTA's
  walk (the mean walk and the longest: ``walk_tiles``).

The readings also go to ``--json`` (default
``chiprun_out/flash_fwd_steps.json``).

Needs one CUDA card. From the repo root, e.g.
``python3 tools/flash_fwd_steps.py --sass --probes parent=OLD/flash_attention.cu
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
# training shape, FLASH_LONG's window and the long ring's windowed hop)
SHAPES = {
    "train": ((8, 16, 4, 2048, 2048, 128), {}),
    "bidirectional": ((8, 16, 4, 2048, 2048, 128), {"prefix": 2048}),
    "cross": ((8, 16, 4, 512, 2048, 128), {"causal": False}),
    "causal_t512": ((8, 16, 4, 512, 512, 128), {}),
    "bench_mha": ((4, 8, 8, 2048, 2048, 128), {}),
    "ring_hop": ((8, 16, 4, 512, 512, 128), {"causal": False}),
    "hd256": ((8, 8, 1, 2048, 2048, 256), {}),
    "long_window": ((1, 8, 8, 16384, 16384, 128), {"window": 2048}),
    "window_hop": cs.RING_HOP_CASES["long"][:2],
}
# B1's pace probes (-DB1_PACE=n in flash_attention.cu)
PROBES = {"copy": 1, "products": 2, "softmax": 3, "nopingpong": 4,
          "fixed": 5}
ITERS = 30


def build(label: str, source: Path, pace: int = 0):
    """(library, nvcc's log) of ``source`` built with the port's flags
    (and ``-DB1_PACE=pace`` for a probe), or (None, log) if nvcc
    refused it."""
    flags = [*_build.NVCC_FLAGS] + ([f"-DB1_PACE={pace}"] if pace else [])
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = (_build.BUILD_DIR
           / f"flash_steps-{label}-{pace}-{digest.hexdigest()[:12]}.so")
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                           str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        return None, log
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
    sass = cs._sass(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, part in cs._sass_functions(sass):
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
            print(f"    in order: {cs.sass_order(part)}")


def build_versions(specs, sass: bool, out_dir: Path,
                   listed: str = "flash_fwd_kernel_sm90",
                   probes: bool = False) -> dict:
    """{label: library} of ``LABEL=PATH`` specs (and, with ``probes``,
    {"label:probe": library} of each B1 pace probe its source has),
    built in parallel, with ptxas's wgmma notes and spill bytes of every
    sm90 flash kernel printed (and, with ``sass``, sass_report's counts
    of each version). A build nvcc refuses is printed and left out."""
    jobs = []                         # (key, label, source, pace)
    for label, path in (v.split("=", 1) for v in specs):
        source = Path(path)
        jobs.append((label, label, source, 0))
        if probes:
            text = source.read_text()
            jobs += [(f"{label}:{name}", label, source, n)
                     for name, n in PROBES.items()
                     if f"kB1Pace != {n}" in text
                     or f"kB1Pace == {n}" in text]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[1], j[2], j[3]), jobs))
    libs = {}
    for (key, label, _, pace), (lib, log) in zip(jobs, built):
        if lib is None:
            print(f"{key}: nvcc refused it:\n{log[-4000:]}")
            continue
        libs[key] = lib
        notes, spills = cs._wgmma_notes(log), cs._spills(log)
        for fn in sorted(notes):
            kernel = cs.SM90_FLASH_KERNEL.search(fn)
            if kernel and (not pace or "fwd" in kernel.group(1)):
                print(f"{key} {kernel.group(1)}<{kernel.group(2)}>: "
                      f"ptxas's wgmma notes {notes[fn]}, spill bytes "
                      f"{spills.get(fn)}")
        if sass and not pace:
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


def _visible(q, k, mask):
    return fa._visible(q.shape[2], k.shape[2], mask.get("causal", True),
                       mask.get("window"), mask.get("row_offset", 0),
                       mask.get("prefix"), cs.DEV)


def sdpa_ms(q, k, v, mask, flush):
    if "window" in mask:
        kw = {"attn_mask": _visible(q, k, mask)}
    else:
        kw = {"is_causal": mask.get("causal", True) and "prefix" not in mask}
    return cs.time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw), flush=flush)


def bound_ms(q, k, mask) -> tuple:
    b, h, t, d = q.shape
    flops = 4 * d * b * h * int(_visible(q, k, mask).sum().item())
    n_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + b * h * t * 4
    t_ops, t_bytes = flops / cs.BF16_FLOP_PER_S, n_bytes / cs.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def walk_tiles(shape, mask, n_sm: int) -> tuple:
    """(mean, longest) KV tiles walked by a CTA of B1's persistent grid
    at ``shape``: the kernel's work items (128-row q tiles of each head,
    longest first, fwd_tile) and their KV tiles (kv_tiles; 64 rows past
    head dim 128, else 128), CTA c taking items c, c + grid, ..."""
    b, h, _, t, tkv, d = shape
    bn = 64 if d > 128 else 128
    causal = mask.get("causal", True)
    window, prefix = mask.get("window") or 0, mask.get("prefix") or 0
    row_offset = mask.get("row_offset", 0)
    n_qt = -(-t // 128)
    n_kv = -(-tkv // bn)

    def tiles(i0):
        r0 = row_offset + i0
        r1 = r0 + min(128, t - i0) - 1
        if not causal:
            return n_kv
        cmax = min(max(r1, prefix - 1), tkv - 1)
        cmin = max(0, r0 - window + 1) if window else 0
        return 0 if cmax < cmin else cmax // bn + 1 - cmin // bn

    per_qt = [tiles((n_qt - 1 - j) * 128) for j in range(n_qt)]
    items = n_qt * b * h
    grid = min(items, n_sm)
    walks = [0] * grid
    for i in range(items):
        walks[i % grid] += per_qt[i // (b * h)]
    return sum(walks) / grid, max(walks)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("versions", nargs="+", metavar="LABEL=PATH")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--probes", action="store_true",
                        help="also build and time B1's pace probes")
    parser.add_argument("--build-only", action="store_true")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated names of SHAPES")
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "flash_fwd_steps")
    parser.add_argument("--turns", type=int, default=2,
                        help="readings of each build at a shape, taken in "
                             "turns first to last and back")
    parser.add_argument("--json", type=Path,
                        default=REPO / "chiprun_out" / "flash_fwd_steps.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_steps: no CUDA device", file=sys.stderr)
        return 2
    card = cs._card(quiet=True)
    print(card)
    libs = build_versions(args.versions, args.sass, args.out,
                          probes=args.probes)
    failed = [label for label, _ in (v.split("=", 1) for v in args.versions)
              if label not in libs]
    if args.build_only:
        return 1 if failed else 0

    versions = [key for key in libs if ":" not in key]
    for label in versions:
        print(f"== {label}: checks")
        use(libs[label])
        try:
            checks(torch.Generator().manual_seed(0))
        except AssertionError as e:
            print(f"{label} FAILED its checks: {e}")
            failed.append(label)

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=cs.DEV)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    order = [key for i in range(args.turns)
             for key in (list(libs) if i % 2 == 0 else list(libs)[::-1])]
    readings = {"card": card}
    for name in args.shapes.split(","):
        shape, mask = SHAPES[name]
        q, k, v, _, _ = cs._flash_inputs(
            shape, torch.bfloat16, torch.Generator().manual_seed(1))
        plain, _ = fa._flash_forward_plain(q, k, v, **mask)
        ref, ref_lse = fa._flash_forward_plain(q.float(), k.float(),
                                               v.float(), **mask)
        empty = cs._empty_rows(shape, mask)
        ms = {key: [] for key in libs}
        for key in order:
            use(libs[key])
            if key in versions and not ms[key]:
                out, lse = fa.flash_forward(q, k, v, **mask)
                over = cs._bf16_reading(out, plain, ref)["over"]
                lse_err = (lse - ref_lse)[:, :, ~empty].abs().max().item()
                print(f"{name} {shape} {mask or 'causal'} {key}: out's "
                      f"worst row at {over:.3f} of its allowance, lse "
                      f"{lse_err:.2e}")
                if not (over <= 1.0 and lse_err <= cs.TOL_FLASH_LSE):
                    failed.append(f"{key} at {name}")
            ms[key].append(cs.time_ms(
                lambda: fa.flash_forward(q, k, v, **mask), iters=ITERS,
                flush=flush))
        lib_ms = sdpa_ms(q, k, v, mask, flush)
        bound, by = bound_ms(q, k, mask)
        mean_walk, long_walk = walk_tiles(shape, mask, n_sm)
        readings[name] = {"shape": shape, "mask": mask, "sdpa_ms": lib_ms,
                          "bound_ms": bound, "bound_by": by,
                          "tiles_per_cta": [mean_walk, long_walk],
                          "ms": ms}
        print(f"{name}: SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"a CTA walks {mean_walk:.1f} KV tiles (longest "
              f"{long_walk})")
        for key, times in ms.items():
            mean = sum(times) / len(times)
            print(f"{name} {key}: {' / '.join(f'{x:.4f}' for x in times)} ms "
                  f"({100 * bound / mean:.1f}% of bound, "
                  f"{mean / lib_ms:.2f}x SDPA); "
                  f"{1e3 * mean / max(mean_walk, 1e-9):.2f} us a tile of "
                  f"the mean walk, {1e3 * mean / max(long_walk, 1):.2f} of "
                  f"the longest")
        del q, k, v, plain, ref, ref_lse
        torch.cuda.empty_cache()
    print("flash_fwd_steps readings: " + json.dumps(readings))
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(readings, indent=1))
    if failed:
        print(f"flash_fwd_steps: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
