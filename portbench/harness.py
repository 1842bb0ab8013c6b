"""One run of one cell: find its files by name, hand it to its entry,
and turn what the entry measured into the result line.

Everything that belongs to one cell, configuration, traffic mix,
per-layer metric or kernel family is a file of its own, found by the
name ``BENCHMARK.json`` or the cell gives it:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the
  entry that drives the program (``entries/<entry>.py``), the entry's
  parameters and the limits of the correctness check;
- ``configs/<config>.json``: the model's sizes;
- ``traffic/<mix>.json``: the load, read by :mod:`portbench.traffic`;
- ``metrics/<metric>.py``: a reader with ``read(reading)``;
- ``kernels/<family>.json``: the kernel-name patterns of a family.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from portbench import traffic
from portbench.reference.starcoder2 import Shape
from portbench.trace import (
    OUTSIDE, DeviceTrace, Spans, check_families, kernel_patterns,
)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_dra_driver")


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> Dict:
    return _json(HERE / "workloads" / f"{name}.json")


def load_config(name: str) -> Dict:
    return _json(HERE / "configs" / f"{name}.json")


def shape_of(config: Dict, window: int = 0) -> Shape:
    return Shape(vocab=config["vocab_size"], d_model=config["hidden_size"],
                 n_heads=config["num_attention_heads"],
                 n_kv_heads=config["num_key_value_heads"],
                 n_layers=config["num_hidden_layers"],
                 d_ff=config["intermediate_size"], window=window)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell``:
    the cells its ``workloads`` key lists, or, without the key, every
    cell (an end-to-end metric) or every cell that reports the metric it
    moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


@dataclass
class Run:
    """What an entry gets: the cell, its sizes and load, the seed and
    window, the device and the span recorder."""

    name: str
    cell: Dict
    config: Dict
    mix: Dict
    shape: Shape
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Spans
    t_begin: float
    log: Callable[[str], None]

    @property
    def params(self) -> Dict:
        return self.cell["params"]


@dataclass
class Outcome:
    """What an entry returns."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, Tuple[Optional[float], float]]
    counters: Dict = field(default_factory=dict)
    trace: Optional[DeviceTrace] = None


class Tracer:
    """The profiler over a short stretch of the run: :meth:`start`, then
    :meth:`stop` after the card has finished what was launched. Off
    unless the run traces; ``outside`` as :class:`DeviceTrace`'s."""

    def __init__(self, on: bool, outside: str = OUTSIDE):
        self.on = on
        self.outside = outside
        self.prof = None
        self.t0 = 0.0
        self.result: Optional[DeviceTrace] = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        if not self.on or self.prof is not None or self.result is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        self.result = DeviceTrace(self.prof, window, self.outside)
        self.prof = None


@contextlib.contextmanager
def steady_host() -> Iterator[None]:
    """The window without the cyclic garbage collector's pauses: what
    set-up left is frozen out of its generations, and collection waits
    until the window has closed."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def worst_leaf_gap(prog: List[float], ref: List[float],
                   counted: List[bool], scale: float = 1.0) -> float:
    """The widest gap between two norms of one leaf, over the counted
    leaves, against the reference's norm of that leaf or of the median
    counted leaf, whichever is larger; the program's norms are divided
    by ``scale`` first."""
    ref_counted = sorted(r for r, c in zip(ref, counted) if c)
    median = ref_counted[len(ref_counted) // 2]
    return max(abs(p / scale - r) / max(r, median)
               for p, r, c in zip(prog, ref, counted) if c)


def common_scale(prog: List[float], ref: List[float],
                 counted: List[bool]) -> float:
    """The median, over the counted leaves, of the program's norm over
    the reference's: the factor that all leaves share, or 1 where that
    median is not positive (a program whose leaves did not move)."""
    ratios = sorted(p / r for p, r, c in zip(prog, ref, counted) if c)
    median = ratios[len(ratios) // 2]
    return median if median > 0 else 1.0


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position, how far the reference's logit of ``tokens`` lies below
    its best: ref_logits [n, vocab] f32, tokens [n]."""
    picked = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return ref_logits.max(dim=-1).values - picked


def make_run(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_begin: Optional[float] = None,
             config_override: Optional[Dict] = None,
             cell_override: Optional[Dict] = None,
             mix_override: Optional[Dict] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> Run:
    """The :class:`Run` of cell ``name``. The overrides replace keys of
    the cell's and configuration's files and of the traffic mix (the
    tests run cells at small sizes on the CPU)."""
    cell = load_cell(name)
    cell.update(cell_override or {})
    config = load_config(cell["config"])
    config.update(config_override or {})
    mix = traffic.load(cell["traffic"])
    mix.update(mix_override or {})
    return Run(name=name, cell=cell, config=config, mix=mix,
               shape=shape_of(config, cell["params"].get("window", 0)),
               seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=torch.device(device),
               spans=Spans(annotate=bool(trace)),
               t_begin=time.perf_counter() if t_begin is None else t_begin,
               log=log)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", **kw) -> Dict:
    """Run ``name`` once and return its result line as a dict: the
    ``metrics`` are the end-to-end ones, or with ``trace`` the per-layer
    ones. ``kw`` goes to :func:`make_run`."""
    run = make_run(name, seed, seconds, trace, device, **kw)
    bench = benchmark()
    log, cell, device = run.log, run.cell, run.device
    entry = importlib.import_module(f"portbench.entries.{cell['entry']}")
    out: Outcome = entry.run(run)

    e2e = [m for m in bench["end_to_end"]
           if applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    metrics: Dict[str, Dict] = {}
    result: Dict = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        _log_trace(out.trace, log)
        reading = Reading(run, out)
        layer = [m for m in bench["per_layer"]
                 if applies(m, name, e2e_names)]
        for m in layer:
            reader = _load_module(HERE / "metrics" / f"{m['name']}.py",
                                  "portbench_metric_" + m["name"].replace(
                                      ".", "_"))
            missing = check_families(out.trace, getattr(reader, "FAMILIES",
                                                        ()))
            if m["name"].endswith("_roofline") and missing:
                raise RuntimeError(
                    f"{m['name']}: the patterns of {missing} match no "
                    f"kernel of the trace")
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": out.trace.top_ops(10),
                               "idle_gaps": out.trace.idle_gaps(10)}

    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in out.checks.items()}
    correct = bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    line.update(result)
    line["checks"] = checks
    return line


def _log_trace(trace: DeviceTrace, log) -> None:
    """The traced window's kernels by time, each with its family."""
    fams = sorted(p.stem for p in (HERE / "kernels").glob("*.json"))
    log(f"trace: window {trace.window_s:.4f} s, busy {trace.busy_s:.4f} s, "
        f"{len(trace.intervals)} intervals, {trace.graph_replays} graph "
        f"replays")
    for name, sec in trace.top_ops(30):
        fam = next((f for f in fams if any(
            p.search(name) for p in kernel_patterns(f))), "-")
        log(f"  {sec:.6f} s  [{fam}]  {name[:150]}")


class Reading:
    """What a per-layer reader reads: the run, the entry's counters and
    spans, and the device trace."""

    def __init__(self, run: Run, outcome: Outcome):
        self.run = run
        self.shape = run.shape
        self.counters = outcome.counters
        self.spans = run.spans
        self.trace = outcome.trace


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
