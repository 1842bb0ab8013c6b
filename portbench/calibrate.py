"""Readings that set the limits of the correctness checks; the
benchmark's own runs never run this.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --kind control|half_batch|altered_token|program --seconds 15

- ``program``: the cell as it runs; its numbers are the lower readings.
- ``control``: the next precision down. A training cell puts the
  reference in float8 e4m3 (per-tensor scales) in the program's place
  and compares it with the float32 reference; a serving or generation
  cell runs the program's own int8-weight path.
- ``half_batch``: a training step whose loss leaves out half the batch's
  rows and takes the mean over the rest.
- ``altered_token``: the decode step's logits turned over, so that every
  row picks its least likely token, where the token is produced.

A step that returns its state unchanged needs no run: every leaf's
change reads 0, a gap of 1. Each reading prints as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from portbench import harness


@contextlib.contextmanager
def _patched(module, name: str, wrap) -> Iterator[None]:
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def half_batch() -> contextlib.AbstractContextManager:
    """The training loss over the first half of the batch's rows, or of
    its one row's positions."""
    transformer = importlib.import_module(
        "tpu_dra_driver_torch.workloads.models.transformer")

    def wrap(loss_fn):
        def half(params, batch, *a, **kw):
            tokens, targets = batch
            if tokens.shape[0] > 1:
                n = tokens.shape[0] // 2
                half_batch = (tokens[:n], targets[:n])
            else:
                n = tokens.shape[1] // 2
                half_batch = (tokens[:, :n], targets[:, :n])
            return loss_fn(params, half_batch, *a, **kw)
        return half
    return _patched(transformer, "loss_fn", wrap)


def unchanged_state() -> contextlib.AbstractContextManager:
    """An optimizer step that leaves the parameters and moments as they
    were."""
    transformer = importlib.import_module(
        "tpu_dra_driver_torch.workloads.models.transformer")
    return _patched(transformer.OptState, "apply",
                    lambda apply: lambda self, grads: None)


def altered_token(entry: str) -> contextlib.AbstractContextManager:
    """Every row's logits turned over in every decode step, so each row
    picks its least likely token."""
    # by import_module: the models package re-exports functions under
    # its modules' names
    pkg = "tpu_dra_driver_torch.workloads.models."
    mod, name = (importlib.import_module(pkg + "serving"), "_decode_core") \
        if entry == "serve" else \
        (importlib.import_module(pkg + "generate"), "decode_step")

    def wrap(fn):
        def turned(*a, **kw):
            logits, *rest = fn(*a, **kw)
            return (-logits, *rest)
        return turned
    return _patched(mod, name, wrap)


def train_control(run: harness.Run) -> Tuple[Dict, Dict]:
    """The float8 reference against the float32 one, by the cell's
    numbers, and the per-leaf norms they came from."""
    from portbench.entries import train
    n = run.params["compared_steps"]
    refr = train.reference_run(run, n, "f32")
    harness.free_device(run.device)
    low = train.reference_run(run, n, "fp8")
    return train.numbers(run, low, refr), {"program": list(low),
                                           "reference": list(refr)}


def reading(name: str, seed: int, kind: str, seconds: float,
            device="cuda", dump=None, **kw) -> Dict:
    """One reading of ``kind`` on ``seed``: the cell's numbers. ``dump``:
    a file for the served tokens' gaps, one array a sequence."""
    cell = harness.load_cell(name)
    entry = cell["entry"]
    if kind == "control" and entry == "train":
        run = harness.make_run(name, seed, seconds, False, device, **kw)
        got, compared = train_control(run)
        if dump is not None:
            Path(dump + ".json").write_text(json.dumps(compared))
        return got
    if kind == "control":
        over = dict(kw.pop("cell_override", None) or {})
        params = dict(over.get("params", cell["params"]), weights="int8")
        kw["cell_override"] = dict(over, params=params)
        ctx = contextlib.nullcontext()
    elif kind == "half_batch":
        ctx = half_batch()
    elif kind == "altered_token":
        ctx = altered_token(entry)
    elif kind == "unchanged_state":
        ctx = unchanged_state()
    elif kind == "program":
        ctx = contextlib.nullcontext()
    else:
        raise ValueError(f"unknown kind {kind!r}")
    with ctx:
        run = harness.make_run(name, seed, seconds, False, device, **kw)
        out = importlib.import_module(f"portbench.entries.{entry}").run(run)
    got = {k: v for k, (v, _) in out.checks.items()}
    if dump is not None and "gaps" in out.counters:
        np.savez_compressed(dump + ".npz", *out.counters["gaps"])
    if dump is not None and "compared" in out.counters:
        Path(dump + ".json").write_text(json.dumps(out.counters["compared"]))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--dump", help="directory for what the readings "
                    "came from")
    args = ap.parse_args(argv)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        dump = None if args.dump is None else \
            f"{args.dump}/{args.workload}.{args.kind}.{seed}"
        got = reading(args.workload, seed, args.kind, args.seconds,
                      dump=dump)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        harness.free_device(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
