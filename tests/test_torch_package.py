"""Package rules of the PyTorch port: no JAX anywhere in it or in
``chip_smoke.py``, no Triton imported at module level, and entry points
that create tensors default to CUDA and raise where there is none."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_dra_driver_torch import entry
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads import data
from tpu_dra_driver_torch.workloads.models import seq2seq
from tpu_dra_driver_torch.workloads.models import serving
from tpu_dra_driver_torch.workloads.models import speculative
from tpu_dra_driver_torch.workloads.models import transformer
from tpu_dra_driver_torch.workloads.ops import attention
from tpu_dra_driver_torch.workloads.ops import collectives
from tpu_dra_driver_torch.workloads.ops import paged_attention

# the module, not the ``generate`` function the package exports
generate = importlib.import_module(
    "tpu_dra_driver_torch.workloads.models.generate")

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "ml_dtypes",
             "tpu_dra_driver")


# the modules of the input pipeline, checkpoints, profiling, the
# benchmarks and the multi-device tier, which the walk must hold like
# the rest
NEW_MODULES = ("workloads/data.py", "workloads/utils/checkpoint.py",
               "workloads/utils/profiling.py", "workloads/ops/collectives.py",
               "workloads/parallel/__init__.py", "workloads/parallel/mesh.py",
               "workloads/parallel/ringattention.py",
               "workloads/parallel/spmd.py", "workloads/parallel/launch.py",
               "workloads/parallel/pipeline.py",
               "computedomain/__init__.py", "computedomain/multislice.py",
               "entry.py")


# the port's scripts outside its package: the card's smoke run, and the
# tools that import its phases (phase 28's check against faults, B5's,
# B1's and B2/B3's versions read side by side)
PORT_SCRIPTS = ("chip_smoke.py", "tools/pp_fault_reading.py",
                "tools/decode_steps.py", "tools/flash_fwd_steps.py",
                "tools/flash_bwd_steps.py")


def _port_files():
    files = sorted((REPO / "tpu_dra_driver_torch").rglob("*.py"))
    assert len(files) >= 10
    return files + [REPO / rel for rel in PORT_SCRIPTS]


def test_the_walk_holds_the_new_modules():
    walked = set(_port_files())
    for rel in NEW_MODULES:
        assert REPO / "tpu_dra_driver_torch" / rel in walked
    for rel in PORT_SCRIPTS:
        assert (REPO / rel).is_file() and REPO / rel in walked


def _imports(tree):
    """(module name, is at module level) for every import in ``tree``."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_module_level_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        assert not (root == "triton" and top_level), \
            f"{path}: imports triton at module level"


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default is usable")
    cfg = transformer.ModelConfig(vocab=16, d_model=8, n_heads=2,
                                  n_layers=1, d_ff=16, max_seq=8,
                                  dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_attention.init_pool(4, 8, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.init_kv_cache(cfg, 1, 8)
    params = transformer.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ServingEngine(params, cfg, n_blocks=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"embed": params["embed"].numpy()})
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(1)
    s2s_cfg = seq2seq.Seq2SeqConfig(vocab=16, d_model=8, n_heads=2,
                                    n_enc_layers=1, n_dec_layers=1, d_ff=16,
                                    max_src=8, max_tgt=8,
                                    dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        seq2seq.init_seq2seq_params(s2s_cfg, 0)
    for bench in (speculative.speculative_decode_tokens_per_sec,
                  speculative.early_exit_decode_tokens_per_sec):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench(cfg=cfg)
    byte_cfg = transformer.ModelConfig(vocab=256, d_model=8, n_heads=2,
                                       n_layers=1, d_ff=16, max_seq=8,
                                       dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        speculative.early_exit_real_data_tokens_per_sec(cfg=byte_cfg)
    for bench in (attention.flash_attention_tflops,
                  attention.flash_attention_train_tflops,
                  attention.flash_attention_long_context_tflops,
                  attention.flash_attention_long_context_train_tflops):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench(b=1, h=1, t=128, d=16)
    for bench in (collectives.matmul_tflops,
                  collectives.matmul_tflops_steady):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench(m=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(data.prefetch_to_device(iter([1])))


def test_chip_smoke_fails_without_cuda_or_without_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(REPO, REPO / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
