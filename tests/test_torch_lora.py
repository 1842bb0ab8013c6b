"""The port's LoRA adapters against the reference's, on the CPU.

The reference's params and adapters (``init_lora`` from a PRNG key) are
carried across with ``convert.params_from_jax``, whose walk takes the
adapters' dict/list trees as it takes the params'. fp32 model; adapters
in fp32 where values are compared (the default dtype, bf16, is checked
apart).

Tolerances: merged weights 1e-6 (one f32 product of rank r); losses 1e-5
relative; adapter gradients 1e-5 of each leaf's largest; adapters after
three AdamW steps as in ``test_torch_training`` (3e-5 for all but one
element in a thousand, all within 2 * n * lr). The base params must be
bit-identical after the steps.
"""

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import lora as jl
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import lora as tl
from tpu_dra_driver_torch.workloads.models import transformer as tt

# the modules, not the functions of the same names both packages export
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

_FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_seq=32, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return tt._param_leaves(tree)


def _setup(scan_layers=False, nonzero_b=False, seed=0):
    """(reference params, adapters; the port's copies of both)."""
    jcfg = replace(JCFG, scan_layers=scan_layers)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    ja = jl.init_lora(jp, rank=4, key=jax.random.PRNGKey(seed + 2),
                      dtype=jnp.float32)
    if nonzero_b:
        # a point where both factors get gradients (b = 0 zeroes a's)
        keys = iter(jax.random.split(jax.random.PRNGKey(seed + 3), 16))
        ja = jax.tree.map(
            lambda x: x if x.any() else 0.02 * jax.random.normal(
                next(keys), x.shape), ja)
    return (jp, ja, convert.params_from_jax(_np(jp), device="cpu"),
            convert.params_from_jax(_np(ja), device="cpu"))


def _batch(seed=1, b=4):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab, (b, JCFG.max_seq)).astype(np.int32)
    return toks, toks


@pytest.mark.parametrize("scan_layers", [False, True])
def test_params_from_jax_carries_adapters(scan_layers):
    """The reference's adapter trees (bf16 by default) come across with
    their structure, shapes, dtype and values."""
    jp = jt.init_params(replace(JCFG, scan_layers=scan_layers),
                        jax.random.PRNGKey(0))
    ja = jl.init_lora(jp, rank=4, key=jax.random.PRNGKey(2))
    ta = convert.params_from_jax(_np(ja), device="cpu")
    layers = ta["layers"]
    if scan_layers:
        assert sorted(layers) == ["wo", "wqkv"]
        assert layers["wqkv"]["a"].shape == (2, 64, 4)
    else:
        assert len(layers) == 2 and sorted(layers[0]) == ["wo", "wqkv"]
        assert layers[0]["wqkv"]["b"].shape == (4, 128)
    jleaves = jax.tree.leaves(ja)
    assert len(jleaves) == len(_leaves(ta))
    for j, t in zip(jleaves, _leaves(ta)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_init_lora_layout(scan_layers):
    tp = tt.init_params(replace(TCFG, scan_layers=scan_layers), 0,
                        device="cpu")
    ad = tl.init_lora(tp, rank=3, key=torch.Generator().manual_seed(5))
    if scan_layers:
        a, b = ad["layers"]["wqkv"]["a"], ad["layers"]["wqkv"]["b"]
        assert a.shape == (2, 64, 3) and b.shape == (2, 3, 128)
    else:
        assert len(ad["layers"]) == 2
        a, b = ad["layers"][1]["wo"]["a"], ad["layers"][1]["wo"]["b"]
        assert a.shape == (64, 3) and b.shape == (3, 64)
    assert sorted(ad) == ["layers"]
    assert a.dtype == b.dtype == torch.bfloat16
    assert not b.any() and 0.01 < a.float().std().item() < 0.03
    again = tl.init_lora(tp, rank=3, key=5)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(ad), _leaves(again)))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_zero_init_adapters_are_the_identity(scan_layers):
    tp = tt.init_params(replace(TCFG, scan_layers=scan_layers), 0,
                        device="cpu")
    ad = tl.init_lora(tp, rank=4, key=2)
    merged = tl.merge_lora(tp, ad)
    assert all(torch.equal(x, y)
               for x, y in zip(_leaves(merged), _leaves(tp)))
    tokens = torch.from_numpy(_batch()[0])
    cfg = replace(TCFG, scan_layers=scan_layers)
    assert torch.equal(tt.forward(merged, tokens, cfg),
                       tt.forward(tp, tokens, cfg))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_merge_lora_matches_reference(scan_layers):
    jp, ja, tp, ta = _setup(scan_layers, nonzero_b=True)
    want = jl.merge_lora(jp, ja, scale=0.5)
    got = tl.merge_lora(tp, ta, scale=0.5)
    for w, g in zip(jax.tree.leaves(want), _leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # leaves without adapters pass through by reference
    assert got["embed"] is tp["embed"]
    # bf16 weights: the sum in f32, cast back to the weight's dtype
    w = torch.randn(8, 6).to(torch.bfloat16)
    ad = {"w": {"a": torch.randn(8, 2), "b": torch.randn(2, 6)}}
    merged = tl.merge_lora({"w": w}, ad)["w"]
    assert merged.dtype == torch.bfloat16
    assert torch.equal(merged, (w.float() + ad["w"]["a"] @ ad["w"]["b"])
                       .to(torch.bfloat16))


def test_adapter_gradients_match_reference():
    jp, ja, tp, ta = _setup(nonzero_b=True)
    batch = _batch()
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda a: jt.loss_fn(jl.merge_lora(jp, a), batch, JCFG)))(ja)
    leaves = [x.requires_grad_() for x in _leaves(ta)]
    loss = tt.loss_fn(tl.merge_lora(tp, ta), tuple(map(torch.from_numpy,
                                                       batch)), TCFG)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for w, g in zip(jax.tree.leaves(want), grads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("scan_layers", [False, True])
def test_three_steps_match_reference_and_leave_the_base(scan_layers):
    jp, ja, tp, ta = _setup(scan_layers)
    base = [x.clone() for x in _leaves(tp)]
    cfg = replace(TCFG, scan_layers=scan_layers)
    jstep, jinit = jl.make_lora_train_step(replace(JCFG,
                                                   scan_layers=scan_layers))
    tstep, tinit = tl.make_lora_train_step(cfg)
    jstep = jax.jit(jstep)
    jstate, tstate = jinit(ja), tinit(ta)
    assert len(tstate.leaves) == len(jax.tree.leaves(ja))
    batch = _batch(2)
    tbatch = tuple(map(torch.from_numpy, batch))
    losses = []
    for _ in range(3):
        ja, jstate, jloss = jstep(jp, ja, jstate, batch)
        ta, tstate, tloss = tstep(tp, ta, tstate, tbatch)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
        losses.append(tloss.item())
    assert losses[-1] < losses[0]
    for w, g in zip(jax.tree.leaves(ja), _leaves(ta)):
        err = np.abs(g.detach().numpy() - np.asarray(w))
        assert err.max() <= 2 * 3 * 1e-3
        assert (err > 3e-5).mean() <= 1e-3, err.max()
    # the frozen base: bit-identical, and never made to require grad
    assert all(torch.equal(x, y) for x, y in zip(base, _leaves(tp)))
    assert not any(x.requires_grad for x in _leaves(tp))
    assert any(x.abs().max() > 0 for x in _leaves(ta))


def test_param_counts_match_reference():
    jp, ja, tp, ta = _setup()
    assert tl.lora_param_counts(tp, ta) == jl.lora_param_counts(jp, ja)
    counts = tl.lora_param_counts(tp, ta)
    assert counts["adapters"] < 0.2 * counts["base"]


def test_custom_targets_and_validation():
    tp = tt.init_params(TCFG, 0, device="cpu")
    ad = tl.init_lora(tp, rank=2, key=2,
                      targets=("wqkv", "wo", "w_up", "w_down"))
    assert sorted(ad["layers"][0]) == ["w_down", "w_up", "wo", "wqkv"]
    assert ad["layers"][0]["w_up"]["b"].shape == (2, 128)
    with pytest.raises(ValueError, match="rank"):
        tl.init_lora(tp, rank=0, key=2)
    with pytest.raises(ValueError, match="targets"):
        tl.init_lora(tp, rank=2, key=2, targets=("nonexistent",))
    # 1-D leaves never take adapters
    with pytest.raises(ValueError, match="targets"):
        tl.init_lora(tp, rank=2, key=2, targets=("g",))


def test_merged_model_generates():
    jp, ja, tp, ta = _setup(nonzero_b=True)
    prompt = _batch()[0][:, :8]
    want = jg.generate(jl.merge_lora(jp, ja), JCFG, jnp.asarray(prompt),
                       steps=8)
    got = tg.generate(tl.merge_lora(tp, ta), TCFG, torch.from_numpy(prompt),
                      steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

