"""Port parity, layer by layer: the same numpy-seeded inputs go through
the JAX reference and its PyTorch port (both on the CPU) and must agree.

Tolerances: fp32 everywhere the point is the algorithm. Elementwise
ops (norm, RoPE, gather) agree to 1e-6; contractions to 1e-5, the
difference being the summation order of two BLAS libraries over at
most a few hundred terms of O(1) values. Int8 quantization is compared
exactly: the same fp32 operations and round-half-even on both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import quantize as tq
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops import attention as ta

# the reference's models package re-exports functions named ``quantize``
# and ``generate``, which hide the submodules of those names
jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
# the port's package re-exports ``generate`` likewise
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

ELEMENTWISE = dict(rtol=1e-6, atol=1e-6)
CONTRACTION = dict(rtol=1e-5, atol=1e-5)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------- quantize

def test_quantize_matches_reference_exactly():
    w = _randn(np.random.default_rng(0), 3, 24, 16)
    for axis in (-2, -1):
        jqt = jq.quantize(jnp.asarray(w), axis=axis)
        tqt = tq.quantize(_t(w), axis=axis)
        assert tqt.axis == jqt.axis
        np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
        np.testing.assert_array_equal(tqt.s.numpy(), np.asarray(jqt.s))
        _close(tqt.dequant(torch.float32), jqt.dequant(jnp.float32),
               ELEMENTWISE)


@pytest.mark.parametrize("quantized", [False, True])
def test_mm_embed_lookup_lm_head(quantized):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 5, 32)
    w = _randn(rng, 32, 24, scale=0.1)
    embed = _randn(rng, 40, 32, scale=0.1)
    tokens = rng.integers(0, 40, (2, 5)).astype(np.int32)
    jw, jemb = jnp.asarray(w), jnp.asarray(embed)
    tw, temb = _t(w), _t(embed)
    if quantized:
        jw, jemb = jq.quantize(jw, -2), jq.quantize(jemb, -1)
        tw, temb = tq.quantize(tw, -2), tq.quantize(temb, -1)
    _close(tq.mm(_t(x), tw), jq.mm(jnp.asarray(x), jw), CONTRACTION)
    got = tq.embed_lookup(temb, _t(tokens), torch.float32)
    want = jq.embed_lookup(jemb, jnp.asarray(tokens), jnp.float32)
    assert got.dtype == torch.float32
    _close(got, want, ELEMENTWISE)
    got = tq.lm_head(_t(x), temb)
    assert got.dtype == torch.float32
    _close(got, jq.lm_head(jnp.asarray(x), jemb), CONTRACTION)


def test_fp_embed_lookup_keeps_table_dtype_and_quantized_defaults_bf16():
    table = torch.zeros(8, 4, dtype=torch.float32)
    tokens = torch.tensor([1, 2])
    assert tq.embed_lookup(table, tokens, torch.bfloat16).dtype \
        == torch.float32
    assert tq.embed_lookup(tq.quantize(table, -1), tokens).dtype \
        == torch.bfloat16
    with pytest.raises(ValueError):
        tq.mm(torch.zeros(2, 8), tq.quantize(torch.zeros(8, 4), -1))


def test_quantize_params_structure():
    cfg = tt.ModelConfig(vocab=32, d_model=16, n_heads=2, n_layers=2,
                         d_ff=32, max_seq=16, dtype=torch.float32)
    qp = tq.quantize_params(tt.init_params(cfg, 0, device="cpu"))
    assert isinstance(qp["embed"], tq.QTensor) and qp["embed"].axis == -1
    for layer in qp["layers"]:
        for k in ("wqkv", "wo", "w_up", "w_down"):
            assert isinstance(layer[k], tq.QTensor) and layer[k].axis == -2
        assert isinstance(layer["ln1"]["g"], torch.Tensor)
    assert isinstance(qp["pos_embed"], torch.Tensor)


# ------------------------------------------------------------- transformer

def test_rmsnorm():
    rng = np.random.default_rng(2)
    x, g = _randn(rng, 2, 3, 16), _randn(rng, 16)
    _close(tt._rmsnorm(_t(x), _t(g)),
           jt._rmsnorm(jnp.asarray(x), jnp.asarray(g)), ELEMENTWISE)


@pytest.mark.parametrize("pos0", [0, 7, "per_row"])
def test_apply_rope(pos0):
    rng = np.random.default_rng(3)
    x = _randn(rng, 3, 2, 4, 16)
    if pos0 == "per_row":
        pos = np.array([0, 5, 130], np.int32)
        jpos, tpos = jnp.asarray(pos), _t(pos)
    else:
        jpos = tpos = pos0
    # cos/sin of angles up to ~130 rad: the two libraries' fp32 range
    # reductions differ by a few ulp of the angle
    _close(tt.apply_rope(_t(x), tpos), jt.apply_rope(jnp.asarray(x), jpos),
           dict(rtol=1e-5, atol=2e-5))


def test_mlp_uses_tanh_gelu():
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 3, 16)
    layer = {"w_up": _randn(rng, 16, 32, scale=0.5),
             "w_down": _randn(rng, 32, 16, scale=0.5)}
    got = tt._mlp(_t(x), {k: _t(v) for k, v in layer.items()})
    want = jt._mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in layer.items()})
    _close(got, want, CONTRACTION)
    # _ffn takes the MLP for a dense layer and the mixture for expert
    # banks, as the reference's does
    jcfg = jt.ModelConfig(n_experts=2, dtype=jnp.float32)
    tcfg = tt.ModelConfig(n_experts=2, dtype=torch.float32)
    _close(tt._ffn(_t(x), {k: _t(v) for k, v in layer.items()}, tcfg),
           jt._ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in layer.items()}, jcfg),
           CONTRACTION)
    moe = {"router": _randn(rng, 16, 2),
           "moe_up": _randn(rng, 2, 16, 32, scale=0.5),
           "moe_down": _randn(rng, 2, 32, 16, scale=0.5)}
    for top_k in (0, 1):
        jc = jt.ModelConfig(n_experts=2, moe_top_k=top_k, dtype=jnp.float32)
        tc = tt.ModelConfig(n_experts=2, moe_top_k=top_k,
                            dtype=torch.float32)
        _close(tt._ffn(_t(x), {k: _t(v) for k, v in moe.items()}, tc),
               jt._ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in moe.items()}, jc),
               CONTRACTION)


def test_stack_unstack_roundtrip():
    cfg = tt.ModelConfig(vocab=16, d_model=8, n_heads=2, n_layers=3,
                         d_ff=16, max_seq=8, dtype=torch.float32)
    p = tq.quantize_params(tt.init_params(cfg, 1, device="cpu"))
    st = tt.stack_layer_params(p)
    assert st["layers"]["wqkv"].q.shape == (3, 8, 24)
    back = tt.unstack_layer_params(st)["layers"]
    for a, b in zip(back, p["layers"]):
        assert torch.equal(a["wqkv"].q, b["wqkv"].q)
        assert torch.equal(a["ln2"]["g"], b["ln2"]["g"])


def test_init_params_keys_shapes_and_seeding():
    jcfg = jt.ModelConfig(vocab=32, d_model=16, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=32, max_seq=16)
    tcfg = tt.ModelConfig(vocab=32, d_model=16, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=32, max_seq=16)
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tt.init_params(tcfg, 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, path
    again = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("kw", [{}, {"window": 3}, {"prefix": 2},
                                {"row_offset": 4}, {"causal": False}])
def test_attention_reference_gqa(kw):
    rng = np.random.default_rng(5)
    tkv = 10 if "row_offset" in kw else 6
    q = _randn(rng, 2, 4, 6, 8)
    k, v = _randn(rng, 2, 2, tkv, 8), _randn(rng, 2, 2, tkv, 8)
    got = ta.attention_reference(_t(q), _t(k), _t(v), **kw)
    want = ja.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    _close(got, want, CONTRACTION)


def test_attention_reference_empty_band_row_is_zero():
    rng = np.random.default_rng(6)
    q, k, v = (_randn(rng, 1, 2, 4, 8) for _ in range(3))
    # rows at global positions 8.. against cols 0..3 with window 2: no row
    # sees any col
    got = ta.attention_reference(_t(q), _t(k), _t(v), window=2,
                                 row_offset=8)
    assert torch.count_nonzero(got) == 0


# ------------------------------------------------------- generate (prefill)

def _cfgs(**kw):
    base = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
                d_ff=64, max_seq=64)
    base.update(kw)
    return (jt.ModelConfig(dtype=jnp.float32, **base),
            tt.ModelConfig(dtype=torch.float32, **base))


@pytest.mark.parametrize("use_rope", [True, False])
def test_block_prefill_logits_and_cache(use_rope):
    jcfg, tcfg = _cfgs(use_rope=use_rope)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(7).integers(0, 64, (2, 12)).astype(
        np.int32)
    jl, jc, jpos = jg.block_prefill(jp, jcfg, jg.init_kv_cache(jcfg, 2, 12),
                                    jnp.asarray(tokens), last_index=9)
    tc = tg.init_kv_cache(tcfg, 2, 12, device="cpu")
    tl, tc2, tpos = tg.block_prefill(tp, tcfg, tc, _t(tokens), last_index=9)
    assert tpos == int(jpos) == 12
    _close(tl, jl, CONTRACTION)
    for li in range(2):
        assert tc2["k"][li].shape == jc["k"][li].shape == (2, 2, 128, 8)
        _close(tc2["k"][li], jc["k"][li], CONTRACTION)
        _close(tc2["v"][li], jc["v"][li], CONTRACTION)


def test_kv_int8_cache_write_matches_reference():
    jcfg, tcfg = _cfgs(kv_int8=True)
    vals = _randn(np.random.default_rng(8), 1, 2, 3, 8)
    jc = jg.init_kv_cache(jcfg, 1, 8)
    tc = tg.init_kv_cache(tcfg, 1, 8, device="cpu")
    jk, js = jg._cache_write(jc, "k", 0, jnp.asarray(vals), 2)
    tk, ts = tg._cache_write(tc, "k", 0, _t(vals), 2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ----------------------------------------------------------------- convert

def test_params_from_jax_bf16_stacked_and_quantized():
    jcfg = jt.ModelConfig(vocab=32, d_model=16, n_heads=2, n_layers=2,
                          d_ff=32, max_seq=16, scan_layers=True)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1))      # bf16, stacked
    np_tree = jax.tree.map(np.asarray, jp)
    assert np_tree["embed"].dtype == ml_dtypes.bfloat16
    tp = convert.params_from_jax(np_tree, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["wqkv"].shape == (2, 16, 48)
    np.testing.assert_array_equal(
        tp["layers"]["wqkv"].float().numpy(),
        np.asarray(jp["layers"]["wqkv"]).astype(np.float32))
    assert tp["layers"]["ln1"]["g"].dtype == torch.float32

    jqp = jax.tree.map(np.asarray, jq.quantize_params(jp),
                       is_leaf=lambda x: isinstance(x, np.ndarray))
    tqp = convert.params_from_jax(jqp, device="cpu")
    w = tqp["layers"]["w_up"]
    assert isinstance(w, tq.QTensor) and w.axis == -2
    assert w.q.dtype == torch.int8 and w.s.dtype == torch.float32
    np.testing.assert_array_equal(
        w.q.numpy(), np.asarray(jq.quantize_params(jp)["layers"]["w_up"].q))
    layer0 = tt.unstack_layer_params(tqp)["layers"][0]
    assert layer0["w_up"].q.shape == (16, 32)
