"""Nothing a run imports is JAX or the JAX package, and the reference
imports nothing of the port. Module names are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.__file__).resolve().parent
PORT = "tpu_dra_driver_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in (PORT + "_probe", "jaxlike_probe", PORT + ".probe"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules()
                if m.endswith("probe")]
    monkeypatch.setitem(sys.modules, "tpu_dra_driver.probe", object())
    assert "tpu_dra_driver.probe" in harness.forbidden_modules()


@pytest.mark.parametrize("path", sorted(
    p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
    if "tests" not in p.parts))
def test_sources_name_no_jax(path):
    for name in _imports(HERE / path):
        assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
        if path.startswith("reference/"):
            assert name.split(".")[0] != PORT, (path, name)


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.conftest import TINY, TINY_CONFIG
mix, params = TINY[{cell!r}]
cell = dict(harness.load_cell({cell!r})["params"], **params)
harness.run_cell({cell!r}, 5, 0.5, False, "cpu", config_override=TINY_CONFIG,
                 mix_override=mix, cell_override={{"params": cell}},
                 log=lambda s: None)
import portbench.__main__, portbench.calibrate
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in harness.FORBIDDEN)))
"""


@pytest.mark.parametrize("cell", sorted(
    w["name"] for w in harness.benchmark()["workloads"]))
def test_a_run_loads_no_jax(cell):
    code = RUN.format(root=str(HERE.parent), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.starcoder2, portbench.weights; "
            "print([m for m in sys.modules if m.split('.')[0] == %r])"
            % (str(HERE.parent), PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_refuses_without_a_card_or_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result."""
    import shutil
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "serve.sc2-3b.decode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
