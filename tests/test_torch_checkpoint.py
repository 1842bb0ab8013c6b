"""The port's train-state checkpoint (``utils/checkpoint.py``) and
profiling helpers (``utils/profiling.py``), on the CPU.

The scenarios of the reference's ``tests/test_train_checkpoint.py``
(apart from the reshard onto another mesh, which waits for the
multi-GPU tier), with the resume held bit for bit under AdamW and under
Adafactor; a restore into a freshly initialised optimizer, whose
``torch.optim`` state is empty, must still carry the saved moments; an
interrupted save is never listed as a step.
"""

import json
import os

import pytest
import torch

from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.utils import (
    abstract_like, annotate, latest_step, latest_trace, list_steps,
    restore_train_state, save_train_state, trace_to,
)
from tpu_dra_driver_torch.workloads.utils import checkpoint as ck

# d_model 128 and d_ff 256 make Adafactor factor the projections
CFG = tt.ModelConfig(vocab=64, d_model=128, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=256, max_seq=32, use_rope=True,
                     dtype=torch.float32)
OPTIMIZERS = {
    "adamw": lambda: tt.default_optimizer(warmup_steps=2),
    "adafactor": lambda: tt.default_optimizer(kind="adafactor",
                                              warmup_steps=2),
}


def _state(kind="adamw", seed=0, cfg=CFG):
    params = tt.init_params(cfg, seed, device="cpu")
    step, opt_init = tt.make_train_step(cfg, optimizer=OPTIMIZERS[kind]())
    return params, opt_init(params), step


def _batch(seed=9):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, CFG.vocab, (2, 32), generator=gen,
                         dtype=torch.int32)
    return toks, toks


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(a.view(-1).view(torch.uint8) if a.numel() else a,
                        b.view(-1).view(torch.uint8) if b.numel() else b)


def _assert_same_tree(got, want):
    assert type(got) is type(want) or (isinstance(got, dict)
                                       and isinstance(want, dict))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif isinstance(want, torch.Tensor):
        assert got is not want
        assert got.device == want.device
        assert _bits_equal(got.detach(), want.detach())
    elif isinstance(want, (tt.OptState, tt.AdafactorState)):
        gs, ws = got.state_dict(), want.state_dict()
        assert list(gs) == list(ws)
        for k in ws:
            _assert_same_tree(gs[k], ws[k])
    elif isinstance(want, torch.Generator):
        assert torch.equal(got.get_state(), want.get_state())
    else:
        assert got == want


def test_roundtrip_plain(tmp_path):
    params, opt, _ = _state()
    state = {"params": params, "opt": opt}
    save_train_state(str(tmp_path), 3, state)
    assert list_steps(str(tmp_path)) == [3]
    got = restore_train_state(str(tmp_path), abstract_like(state))
    _assert_same_tree(got["params"], params)


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_resume_continues_training_identically(tmp_path, kind):
    """Save at step 2 and keep training; restoring step 2 and replaying
    the same batches gives bit-identical losses and params for 3 steps."""
    params, opt, step = _state(kind)
    batch = _batch()
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    state = {"params": params, "opt": opt, "rng": gen, "step": 2}
    save_train_state(str(tmp_path), 2, state)
    abstract = abstract_like(state)
    cont = []
    for _ in range(3):
        params, opt, loss = step(params, opt, batch)
        cont.append(loss.item())
    draws = torch.rand(4, generator=gen)

    restored = restore_train_state(str(tmp_path), abstract)
    assert restored["step"] == 2
    assert isinstance(restored["opt"], type(opt))
    p2, o2 = restored["params"], restored["opt"]
    resumed = []
    for _ in range(3):
        p2, o2, loss = step(p2, o2, batch)
        resumed.append(loss.item())
    assert cont == resumed
    _assert_same_tree(p2, params)
    _assert_same_tree(o2, opt)
    assert torch.equal(torch.rand(4, generator=restored["rng"]), draws)


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_restore_into_a_fresh_optimizer_carries_the_moments(tmp_path, kind):
    """The skeleton of a never-stepped optimizer (whose torch.optim state
    is empty) still names and shapes every moment, so the restore carries
    the saved ones instead of silently starting from zeros."""
    params, opt, step = _state(kind)
    for _ in range(2):
        params, opt, _ = step(params, opt, _batch())
    save_train_state(str(tmp_path), 2, {"params": params, "opt": opt})
    fresh_params, fresh_opt, _ = _state(kind, seed=1)
    got = restore_train_state(str(tmp_path), abstract_like(
        {"params": fresh_params, "opt": fresh_opt}))
    saved, back = opt.state_dict(), got["opt"].state_dict()
    assert list(back) == list(saved) and back["count"] == 2
    moments = [k for k in saved if k != "count" and not k.endswith("step")]
    assert moments and all(saved[k].abs().sum() > 0 for k in moments)
    for k in saved:
        _assert_same_tree(back[k], saved[k])
    # and the restored pair takes the continuation's next step
    want = step(params, opt, _batch(4))[2].item()
    assert step(got["params"], got["opt"], _batch(4))[2].item() == want


def test_fresh_optimizer_state_dict_shapes_before_the_first_step():
    params, opt, _ = _state("adamw")
    sd = opt.state_dict()
    leaves = dict(zip(tt._leaf_paths(params), tt._param_leaves(params)))
    assert sd["count"] == 0
    for path, leaf in leaves.items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert sd[f"{path}.{name}"].shape == leaf.shape
            assert not sd[f"{path}.{name}"].any()
        assert sd[f"{path}.step"].item() == 0.0
    with pytest.raises(KeyError, match="does not match"):
        opt.load_state_dict({"count": 0})


def test_scan_layers_params_and_other_leaves_roundtrip(tmp_path):
    """Stacked [L, ...] params, ints, floats, strings, tuples and lists."""
    cfg = tt.ModelConfig(**{**CFG.__dict__, "scan_layers": True})
    params, opt, step = _state("adafactor", cfg=cfg)
    params, opt, _ = step(params, opt, _batch())
    state = {"params": params, "opt": opt, "meta": ("run", 1.5, [7, "x"]),
             "gens": [torch.Generator().manual_seed(s) for s in (1, 2)]}
    save_train_state(str(tmp_path), 1, state)
    _assert_same_tree(restore_train_state(str(tmp_path),
                                          abstract_like(state)), state)


def test_optimizer_without_its_params_in_the_tree_is_refused():
    params, opt, _ = _state()
    with pytest.raises(ValueError, match="same tree"):
        abstract_like({"opt": opt})


def test_retention_prunes_oldest(tmp_path):
    small = {"x": torch.arange(8.0)}
    for s in (1, 2, 3, 4):
        save_train_state(str(tmp_path), s, small, keep=2)
    assert list_steps(str(tmp_path)) == [3, 4]
    assert latest_step(str(tmp_path)) == 4


def test_saving_a_step_again_replaces_it(tmp_path):
    save_train_state(str(tmp_path), 1, {"x": torch.zeros(3)})
    save_train_state(str(tmp_path), 1, {"x": torch.ones(3)})
    got = restore_train_state(str(tmp_path), abstract_like(
        {"x": torch.empty(3)}))
    assert torch.equal(got["x"], torch.ones(3))
    assert os.listdir(tmp_path) == ["step_00000001"]


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), {"x": ck.TensorSpec(
            (1,), torch.float32, torch.device("cpu"))})


def test_save_rejects_nonpositive_keep(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        save_train_state(str(tmp_path), 0, {"x": torch.zeros(2)}, keep=0)


def test_leftover_tmp_directory_is_not_listed(tmp_path):
    """A save that died before its rename leaves step_N.tmp-*: never a
    step."""
    save_train_state(str(tmp_path), 1, {"x": torch.zeros(2)})
    leftover = tmp_path / "step_00000002.tmp-4242-deadbeef"
    leftover.mkdir()
    (leftover / "__0_0.distcp").write_bytes(b"partial")
    assert list_steps(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1
    got = restore_train_state(str(tmp_path), abstract_like(
        {"x": torch.empty(2)}))
    assert torch.equal(got["x"], torch.zeros(2))


def test_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    def dies(state_dict, storage_writer):
        os.makedirs(storage_writer.path, exist_ok=True)
        (storage_writer.path / "__0_0.distcp").write_bytes(b"partial")
        raise OSError("disk went away")

    monkeypatch.setattr(dcp, "save", dies)
    with pytest.raises(OSError, match="went away"):
        save_train_state(str(tmp_path), 5, {"x": torch.zeros(2)})
    assert list_steps(str(tmp_path)) == []
    assert os.listdir(tmp_path) == []


def test_abstract_like_on_another_device_moves_every_tensor_spec():
    """The skeleton's device replaces each tensor's, optimizer moments
    included; a generator keeps its own (its state is device-specific)."""
    params, opt, step = _state()
    params, opt, _ = step(params, opt, _batch())
    gen = torch.Generator()
    abstract = abstract_like({"params": params, "opt": opt, "rng": gen},
                             device="cuda")
    specs = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, ck.OptimizerSpec):
            assert node.params_at == ("params",)
            walk(node.state)
        elif isinstance(node, ck.TensorSpec):
            specs.append(node)

    walk(abstract)
    n_leaves = len(tt._param_leaves(params))
    assert len(specs) == n_leaves * 4       # params, two moments, step
    assert all(s.device == torch.device("cuda") for s in specs)
    assert abstract["rng"].device == torch.device("cpu")


def test_restore_onto_another_device_type(tmp_path):
    """Saved from the CPU, restored onto the card, bit-equal, and the
    resumed step equals the CPU's continuation's loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU is the only device here")
    params, opt, step = _state()
    params, opt, _ = step(params, opt, _batch())
    state = {"params": params, "opt": opt}
    save_train_state(str(tmp_path), 1, state)
    got = restore_train_state(str(tmp_path),
                              abstract_like(state, device="cuda"))
    for a, b in zip(tt._param_leaves(params), tt._param_leaves(
            got["params"])):
        assert b.device.type == "cuda"
        assert _bits_equal(a.detach(), b.detach().cpu())


# ------------------------------------------------------------ profiling

def test_latest_trace_is_none_without_a_run(tmp_path):
    assert latest_trace(str(tmp_path)) is None
    assert latest_trace(str(tmp_path / "nowhere")) is None
    (tmp_path / "plugins" / "profile").mkdir(parents=True)
    assert latest_trace(str(tmp_path)) is None


def test_trace_holds_the_annotated_span_and_the_newest_run_is_found(
        tmp_path):
    d = str(tmp_path / "prof")
    runs = []
    for span in ("first_span", "matmul_span"):
        with trace_to(d) as got:
            assert got == d
            with annotate(span):
                torch.ones(64, 64) @ torch.ones(64, 64)
        runs.append(latest_trace(d))
    assert runs[0] != runs[1] and sorted(runs) == runs
    with open(os.path.join(runs[1], "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul_span" in names and "first_span" not in names
    assert any("mm" in str(n) for n in names)


def test_nested_trace_raises_and_the_outer_trace_survives(tmp_path):
    d = str(tmp_path)
    with trace_to(d):
        with pytest.raises(RuntimeError, match="already"):
            with trace_to(d):
                pass
        with annotate("after_nested"):
            torch.zeros(3).sum()
    with open(os.path.join(latest_trace(d), "trace.json")) as f:
        assert any(e.get("name") == "after_nested"
                   for e in json.load(f)["traceEvents"])
    with trace_to(d):                       # usable again afterwards
        pass


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace_to(str(tmp_path)):
            with annotate("doomed"):
                1 / 0
    assert latest_trace(str(tmp_path)) is not None
