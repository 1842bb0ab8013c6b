#!/usr/bin/env python3
"""B5, the flash-decode read, built from several versions of
``csrc/decode_attention.cu`` and read side by side in one process on one
card, so that a redesign is read against the same parent, with the
pace probes that say what sets its time. For each version
(``LABEL=PATH`` to a decode_attention.cu; the ``mma_decode.cuh`` beside
it is the one included):

- nvcc with the port's flags (``ops/_build.py``), every build at once:
  the version itself and those of its pace probes that its source has
  (``B5_PACE``): ``copy`` (the producer and the ring, no math), ``math``
  (the walk over whatever the ring holds, no copy), ``stream`` (every
  thread of the same grid reading the run's bytes with plain 16-byte
  loads: the card's floor for a read of this size), ``nomerge`` (no
  merge of the splits) and ``fixed`` (no copy and no walk: a CTA's fixed
  cost); ptxas's registers and spill bytes of each instantiation;
- at each of READS (chip_smoke's generation reads at head dims 128 and
  256, bf16 and int8 caches, the beam's 32 rows, the b = 1 draft, and
  b = 1 over a long cache, where a cap on the split count shows): the
  version's output row by row within its allowance of an f32 reference
  (``chip_smoke._bf16_reading``), then each (version, probe) timed in
  ``torch.profiler`` sessions of the card's activity, one per reading in
  each of two turns (first to last, then last to first), 10 calls each,
  every call after a flush of the L2 by a write of 256 MiB (``write``:
  dirty lines, as chip_smoke's readings) or by a read of it (``read``:
  clean lines), and the version itself also with the L2 warm (``warm``).
  The readings are each kernel's mean device ms per call, their sum, the
  two turns' sums and the kernels per call. A version launched as two
  kernels (a split kernel writing partial states to scratch and a merge
  kernel: the ``part`` argument of its C interface) is also read at
  min(8, its split count) where that differs. SDPA over the live slots (bf16 only) and the read's bound
  (bytes over 3.35 TB/s) stand beside them.

The readings go to ``chiprun_out/decode_steps.json`` as well.

Needs one CUDA card. From the repo root, e.g.
``python3 tools/decode_steps.py parent=OLD/decode_attention.cu
new=tpu_dra_driver_torch/workloads/csrc/decode_attention.cu``
(default: ``new=`` the repo's source alone); ``--build-only`` stops
after the build report, ``--reads hd128,beam`` takes some of READS.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
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
from tpu_dra_driver_torch.workloads.ops import decode_attention as da  # noqa: E402,E501

# name -> ((b, h, h_kv, L, hd), pos, int8 cache)
READS = {
    "hd128": (cs.DECODE_FULL, cs.DECODE_BF16_POS[0], False),
    "hd128_int8": (cs.DECODE_FULL, cs.DECODE_BF16_POS[0], True),
    "hd256": (cs.DECODE_HD256, cs.DECODE_BF16_POS[0], False),
    "hd256_int8": (cs.DECODE_HD256, cs.DECODE_BF16_POS[0], True),
    "beam": (cs.DECODE_BEAM, cs.DECODE_BEAM_POS[0], False),
    "draft": ((1, 16, 4, 512, 128), max(cs.DECODE_SPEC[512]), False),
    "b1_long": ((1, 16, 4, 3200, 128), cs.DECODE_BF16_POS[0], False),
}
PROBES = {"copy": 1, "math": 2, "stream": 3, "nomerge": 4, "fixed": 5}
# the most splits a one-launch version takes
ONE_LAUNCH_MAX = 8
ITERS = 10
FLUSH_BYTES = 256 * 1024 * 1024


def build(label: str, source: Path, pace: int):
    """(library, nvcc's log) of ``source`` built with the port's flags
    and ``-DB5_PACE=pace``."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_build.NVCC_FLAGS).encode())
    lib = (_build.BUILD_DIR
           / f"decode_steps-{label}-{pace}-{digest.hexdigest()[:12]}.so")
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-DB5_PACE={pace}", "-o",
         str(lib), str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label} pace {pace} "
                           f"({source}):\n{log}")
    log_path.write_text(log)
    return lib, log


class Version:
    """One decode_attention.cu: its builds by probe ("" for the version
    itself) and whether its C interface takes the ``part`` scratch of a
    separate merge kernel (two kernels) or none (one launch)."""

    def __init__(self, label: str, source: Path):
        self.label, self.source = label, source
        text = source.read_text()
        self.two_kernel = "void* out, void* part" in text
        self.probes = {"": 0, **{
            name: n for name, n in PROBES.items()
            if f"kPace == {n}" in text or f"kPace != {n}" in text}}
        self.libs = {}

    def n_split(self, shape) -> int:
        """The version's split count at ``shape``: the parent's plan
        (two CTAs per SM, one past hd 128; at most one split per tile)
        for a two-kernel version, else the repo's ``decode_n_split``."""
        b, _, h_kv, L, hd = shape
        n_sm = da._sm_count(torch.device(cs.DEV))
        if self.two_kernel:
            ctas = 1 if hd > 128 else 2
            return max(1, min(L // 64, ctas * n_sm // (b * h_kv)))
        return da.decode_n_split(L, b * h_kv, n_sm,
                                 da.ctas_per_sm(torch.bfloat16, hd))

    def caller(self, probe, q, k, v, ks, vs, pos, n_split):
        """A call of the probe's library on these inputs (its scratch
        allocated once), returning the output."""
        lib = ctypes.CDLL(str(self.libs[probe]))
        fn = lib.flash_decode_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, i, p] \
            + [p] * self.two_kernel + [i] * 6 + [p]
        fn.restype = ctypes.c_int
        b, h, _, hd = q.shape
        h_kv, L = k.shape[1], k.shape[2]
        rep = h // h_kv
        out = torch.empty_like(q)
        part = (torch.empty((b * h_kv, n_split, rep, hd + 2),
                            dtype=torch.float32, device=q.device)
                if self.two_kernel and n_split > 1 else None)
        quantized = ks is not None
        head = [1, int(quantized), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                ks.data_ptr() if quantized else None,
                vs.data_ptr() if quantized else None, None, min(pos, L),
                out.data_ptr()]
        scratch = [None if part is None else part.data_ptr()] \
            * self.two_kernel

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(*head, *scratch, b, h_kv, rep, hd, L, n_split, stream)
            if rc != 0:
                raise RuntimeError(f"{self.label} {probe or 'kernel'}: "
                                   f"launch failed, cudaError {rc}")
            return out
        return call


def build_all(versions) -> None:
    jobs = [(v, probe, pace) for v in versions
            for probe, pace in v.probes.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[0].label, j[0].source, j[2]),
                              jobs))
    for (v, probe, _), (lib, log) in zip(jobs, built):
        v.libs[probe] = lib
        if probe:
            continue
        spills, name = cs._spills(log), ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            if "registers" in line and "flash_decode" in name:
                used = line.split(":", 1)[1].strip()
                kernel = name[name.index("flash_decode"):][:64]
                print(f"{v.label} {kernel}: {used}; spills "
                      f"{spills.get(name)}")


def profile_read(calls, flushes, iters=ITERS) -> dict:
    """{tag: ({kernel name: (mean device ms, launches) per call}, [the
    kernels' ms per call in each turn])} of ``calls`` ({tag: (fn, flush
    kind)}): one ``torch.profiler`` session (the card's activity only)
    per tag in each of two turns, every call ``iters`` times after its
    flush; the B5 kernels are those named ``flash_decode`` (SDPA's:
    every kernel but the flush's). A session that recorded none reads
    0 in its turn and is left out of the means."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    found = {tag: {} for tag in calls}
    turns = {tag: [] for tag in calls}
    for tag in list(calls) + list(calls)[::-1]:
        fn, kind = calls[tag]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flushes[kind]()
                fn()
            torch.cuda.synchronize()
        turn = 0.0
        for e in prof.key_averages():
            low = e.key.lower()
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            if "flash_decode" not in low and not (
                    tag.startswith("sdpa") and "elementwise" not in low
                    and "reduce" not in low and "memset" not in low):
                continue
            ms, n = found[tag].get(e.key, (0.0, 0))
            found[tag][e.key] = (ms + e.self_device_time_total / 1e3,
                                 n + e.count)
            turn += e.self_device_time_total / 1e3 / iters
        turns[tag].append(turn)
    out = {}
    for tag, per in found.items():
        calls = iters * max(1, sum(t > 0 for t in turns[tag]))
        out[tag] = ({name: (ms / calls, n / calls)
                     for name, (ms, n) in per.items()}, turns[tag])
    return out


def short(name: str) -> str:
    return name[name.find("flash_decode"):].split("<")[0] \
        if "flash_decode" in name else name[:24]


def read_one(name, versions, flushes, failed) -> dict:
    shape, pos, int8 = READS[name]
    q, k, v, ks, vs = cs._decode_inputs(shape, torch.bfloat16,
                                        torch.Generator().manual_seed(5),
                                        int8=int8)
    plain = da.flash_decode_attention_plain(q, k, v, pos, ks, vs)
    ref = da.flash_decode_attention_plain(
        q.float(), k if int8 else k.float(), v if int8 else v.float(), pos,
        ks, vs)
    n_bytes, n_flops = cs._decode_bytes_flops(q, k, pos, int8)
    bound = max(n_bytes / cs.HBM_BYTES_PER_S,
                n_flops / cs.BF16_FLOP_PER_S) * 1e3
    calls, splits = {}, {}
    for ver in versions:
        own = ver.n_split(shape)
        counts = [own] + ([min(own, ONE_LAUNCH_MAX)] if ver.two_kernel
                          and own > ONE_LAUNCH_MAX else [])
        for n in counts:
            at = "" if n == own else f"@{n}"
            fn = ver.caller("", q, k, v, ks, vs, pos, n)
            over = cs._bf16_reading(fn(), plain, ref)["over"]
            print(f"{name} {ver.label}{at}: {n} splits, worst row at "
                  f"{over:.3f} of its allowance")
            if not over <= 1.0:
                failed.append(f"{ver.label}{at} at {name}")
            for kind in ("write", "read", "warm"):
                calls[f"{ver.label}{at} {kind}"] = (fn, kind)
            splits[f"{ver.label}{at}"] = n
            if at:
                continue
            for probe in ver.probes:
                if probe:
                    pf = ver.caller(probe, q, k, v, ks, vs, pos, n)
                    for kind in ("write", "read"):
                        calls[f"{ver.label}:{probe} {kind}"] = (pf, kind)
    found = profile_read(calls, flushes)
    sdpa = None
    if not int8:
        kl, vl = k[:, :, :pos + 1], v[:, :, :pos + 1]
        lib = profile_read({"sdpa write": (
            lambda: F.scaled_dot_product_attention(q, kl, vl,
                                                   enable_gqa=True),
            "write")}, flushes)["sdpa write"][0]
        sdpa = sum(ms for ms, _ in lib.values()) if lib else None
    print(f"== {name}: q {list(q.shape)}, cache {list(k.shape)} "
          f"{'int8' if int8 else 'bf16'}, pos {pos}; bound {bound:.5f} ms "
          f"({n_bytes} bytes); SDPA "
          + (f"{sdpa:.4f} ms" if sdpa else "not measured"))
    for tag, (per, turns) in found.items():
        total = sum(ms for ms, _ in per.values())
        parts = " + ".join(f"{short(n)} {ms:.4f}"
                           for n, (ms, _) in per.items())
        n_kernels = sum(n for _, n in per.values())
        print(f"  {tag:28s} " + (
            f"{total:.4f} ms ({parts}; turns "
            + " / ".join(f"{t:.4f}" for t in turns)
            + f"); {100 * bound / total:.1f}% of bound"
            if total else "not measured")
            + f"; {n_kernels:g} kernel(s) a call")
    return {"shape": shape, "pos": pos, "int8": int8, "bound_ms": bound,
            "sdpa_ms": sdpa, "splits": splits,
            "ms": {tag: per for tag, per in found.items()}}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("versions", nargs="*", metavar="LABEL=PATH")
    parser.add_argument("--build-only", action="store_true")
    parser.add_argument("--reads", default=",".join(READS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_steps: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card(quiet=True))
    specs = args.versions or [f"new={_build._CSRC / 'decode_attention.cu'}"]
    versions = [Version(s.split("=", 1)[0], Path(s.split("=", 1)[1]))
                for s in specs]
    build_all(versions)
    if args.build_only:
        return 0
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=cs.DEV)
    total = torch.empty((), dtype=torch.float32, device=cs.DEV)
    flushes = {"write": flush.zero_,
               "read": lambda: torch.sum(flush, dim=0,
                                         out=total),
               "warm": lambda: None}
    failed, readings = [], {}
    for name in args.reads.split(","):
        readings[name] = read_one(name, versions, flushes, failed)
        torch.cuda.empty_cache()
    out = REPO / "chiprun_out" / "decode_steps.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": cs._card(quiet=True),
                               "readings": readings}, indent=1))
    if failed:
        print(f"decode_steps: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
