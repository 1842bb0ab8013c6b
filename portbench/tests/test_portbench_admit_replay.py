"""The reader of ``admit_replay_share.serve``: the engine's admission
counters as it reads them, a CPU engine's admissions (none replayed:
the CPU captures no graph), and a port without the counters."""

import pytest
import torch

from portbench import harness

NAME = "admit_replay_share.serve"


def _reader():
    return harness._load_module(harness.HERE / "metrics" / f"{NAME}.py",
                                "portbench_metric_" + NAME.replace(".", "_"))


def test_listed_for_the_serving_cell():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    assert per_layer[NAME]["workloads"] == ["serve.sc2-3b.decode"]
    assert per_layer[NAME]["moves"] == "out_tokens_per_s"


@pytest.mark.parametrize("admits,replays,want", [
    (0, 0, None), (200, 190, 95.0), (7, 0, 0.0), (3, 3, 100.0)])
def test_replays_over_admissions(admits, replays, want, monkeypatch):
    from tpu_dra_driver_torch.workloads.models.serving import ServingEngine
    monkeypatch.setattr(ServingEngine, "admits", admits)
    monkeypatch.setattr(ServingEngine, "admit_replays", replays)
    assert _reader().read(None) == want


def test_a_cpu_engine_counts_its_admissions_and_replays_none(monkeypatch):
    from tpu_dra_driver_torch.workloads.models import serving as ts
    from tpu_dra_driver_torch.workloads.models import transformer as tt
    monkeypatch.setattr(ts.ServingEngine, "admits", 0)
    monkeypatch.setattr(ts.ServingEngine, "admit_replays", 0)
    cfg = tt.ModelConfig(vocab=64, d_model=32, n_heads=2, n_kv_heads=1,
                         n_layers=1, d_ff=64, max_seq=128, use_rope=True,
                         dtype=torch.float32)
    eng = ts.ServingEngine(tt.init_params(cfg, 0, device="cpu"), cfg,
                           n_blocks=9, block_t=8, max_batch=2,
                           max_blocks_per_seq=4, device="cpu")
    eng.run([[1, 2, 3], [4] * 9, [5, 6], [7] * 20], max_new_tokens=3)
    assert ts.ServingEngine.admits == 4
    assert ts.ServingEngine.admit_replays == 0
    assert _reader().read(None) == 0.0


def test_a_port_without_the_counters_reads_none(monkeypatch):
    from tpu_dra_driver_torch.workloads.models.serving import ServingEngine
    for name in ("admits", "admit_replays"):
        monkeypatch.delattr(ServingEngine, name)
    assert _reader().read(None) is None
