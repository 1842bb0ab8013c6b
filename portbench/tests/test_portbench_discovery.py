"""A cell, a configuration, a traffic mix, a per-layer metric and a
kernel family, each dropped into a copy of the benchmark as a new file
(with its entries in BENCHMARK.json), are found by name: no file that
was there is edited, and a run of the new cell reports the new metric."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

HERE = Path(harness.__file__).resolve().parent


def _digests(root: Path):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)

    from portbench.conftest import TINY, TINY_CONFIG
    config = dict(json.loads((HERE / "configs/starcoder2-3b.json")
                             .read_text()), **TINY_CONFIG)
    (bench / "configs/tiny-probe.json").write_text(json.dumps(config))
    mix = dict(json.loads((HERE / "traffic/decode.json").read_text()),
               **TINY["serve.sc2-3b.decode"][0])
    (bench / "traffic/probe-burst.json").write_text(json.dumps(mix))
    cell = json.loads((HERE / "workloads/serve.sc2-3b.decode.json")
                      .read_text())
    cell.update(config="tiny-probe", traffic="probe-burst",
                why="a probe cell")
    cell["params"].update(TINY["serve.sc2-3b.decode"][1], trace_seconds=0.2)
    (bench / "workloads/serve.tiny-probe.burst.json").write_text(
        json.dumps(cell))
    (bench / "metrics/chunk_ms.probe.py").write_text(
        "def read(r):\n"
        "    xs = r.spans.seconds('chunk')\n"
        "    return 1e3 * sum(xs) / len(xs) if xs else None\n")
    (bench / "kernels/probe_family.json").write_text(
        json.dumps({"patterns": ["probe_kernel"]}))

    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-probe", "source": "probe",
                            "file": "portbench/configs/tiny-probe.json",
                            "reduced": [], "why": "probe"})
    spec["workloads"].append({"name": "serve.tiny-probe.burst",
                              "config": "tiny-probe",
                              "traffic": "probe-burst", "chips": 1,
                              "why": "a probe cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "serve.sc2-3b.decode" in m["workloads"]:
            m["workloads"].append("serve.tiny-probe.burst")
    spec["per_layer"] = [{"name": "chunk_ms.probe", "unit": "ms",
                          "better": "lower", "source": "host_clock",
                          "layer": "probe", "moves": "out_tokens_per_s",
                          "workloads": ["serve.tiny-probe.burst"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(HERE.parent)!r}]\n"
        "from portbench import harness, trace\n"
        "assert harness.HERE.parent == __import__('pathlib').Path("
        f"{str(tmp_path)!r})\n"
        "assert trace.kernel_patterns('probe_family')\n"
        "line = harness.run_cell('serve.tiny-probe.burst', 9, 0.5, True, "
        "'cpu', log=lambda s: None)\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["chunk_ms.probe"]["value"] > 0
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
