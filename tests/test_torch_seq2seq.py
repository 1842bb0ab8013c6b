"""The port's encoder-decoder family against the reference, on the CPU.

The reference's params (``init_seq2seq_params`` from a PRNG key) are
converted with ``convert.params_from_jax``; everything is fp32. Where a
test needs the cross-attention path to carry the source, ``wo_x`` (zero
at init) is drawn from N(0, 0.02) on the reference's side first. The
port runs with ``attn_fn=None`` (the reference's math) and with
``attn_fn=flash_attention`` (B1-B3's plain versions here: the encoder's
all-prefix attention, the decoder's causal self-attention and the
unmasked cross-attention); the reference has no such argument and
always runs its own math.

Tolerances: losses 1e-5 relative; logits and encoder states 1e-5
relative and absolute; gradients 1e-5 of each leaf's largest; params
after three AdamW(1e-3) steps as in ``test_torch_training.py`` (3e-5
absolute for all but one element in a thousand, all within 2 n lr).
Greedy tokens must be identical.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.ops import attention as ta

js = importlib.import_module("tpu_dra_driver.workloads.models.seq2seq")
ts = importlib.import_module("tpu_dra_driver_torch.workloads.models.seq2seq")

FIELDS = dict(vocab=16, d_model=64, n_heads=4, n_enc_layers=2,
              n_dec_layers=2, d_ff=128, max_src=12, max_tgt=12, bos=0)
JCFG = js.Seq2SeqConfig(dtype=jnp.float32, **FIELDS)
TCFG = ts.Seq2SeqConfig(dtype=torch.float32, **FIELDS)
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
PARAM_ATOL = 3e-5
ATTN = {"reference_math": None, "flash_attention": ta.flash_attention}

# the reference's functions, compiled once per configuration and shape
_jencode = jax.jit(js.encode, static_argnums=2)
_jdecode_forward = jax.jit(js.decode_forward, static_argnums=3)
_jloss = jax.jit(js.seq2seq_loss_fn, static_argnums=2)
_jgreedy = jax.jit(js.greedy_decode, static_argnums=(2, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    fields = {**FIELDS, **kw}
    return (js.Seq2SeqConfig(dtype=jnp.float32, **fields),
            ts.Seq2SeqConfig(dtype=torch.float32, **fields))


def _params(jcfg=JCFG, cross=True, seed=0):
    """(reference params, a fresh copy of them for the port); ``cross``
    draws ``wo_x`` so that the cross-attention path is live."""
    jp = _jparams(jcfg, cross, seed)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@functools.lru_cache(maxsize=None)
def _jparams(jcfg, cross, seed):
    jp = js.init_seq2seq_params(jcfg, jax.random.PRNGKey(seed))
    if cross:
        keys = jax.random.split(jax.random.PRNGKey(100 + seed),
                                len(jp["decoder"]["layers"]))
        for key, layer in zip(keys, jp["decoder"]["layers"]):
            layer["wo_x"] = 0.02 * jax.random.normal(
                key, layer["wo_x"].shape, layer["wo_x"].dtype)
    return jp


def _batch(seed=1, b=4, t=6, vocab=FIELDS["vocab"]):
    """(src, tgt) int32: tokens 1..vocab-1 (0 is BOS), target = the
    reversed source; t < max_src, so the source is shorter than the
    encoder's prefix."""
    src = np.random.RandomState(seed).randint(1, vocab, (b, t))
    return src.astype(np.int32), src[:, ::-1].astype(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _paths(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _paths(x, path + (i,))
    else:
        yield path, node


def test_init_keys_shapes_and_zero_cross_output():
    jp = _jparams(JCFG, False, 0)
    tp = ts.init_seq2seq_params(TCFG, 0, device="cpu")
    want = {p: np.shape(a) for p, a in _paths(jp)}
    got = {p: tuple(a.shape) for p, a in _paths(tp)}
    assert got == want
    assert "embed" not in tp["decoder"]
    for layer in tp["decoder"]["layers"]:
        assert not layer["wo_x"].any()
        assert torch.equal(layer["lnx"]["g"], torch.ones(FIELDS["d_model"]))
        assert layer["wq_x"].std().item() == pytest.approx(0.02, rel=0.1)
    assert ts.init_seq2seq_params(TCFG, torch.Generator().manual_seed(0),
                                  device="cpu")["decoder"]["layers"][0][
        "wq_x"].equal(tp["decoder"]["layers"][0]["wq_x"])


@pytest.mark.parametrize("attn", list(ATTN))
def test_loss_logits_and_shapes_match(attn):
    jp, tp = _params()
    src, tgt = _batch()
    want_loss = _jloss(jp, (src, tgt), JCFG)
    loss = ts.seq2seq_loss_fn(tp, _t(src, tgt), TCFG, ATTN[attn])
    assert torch.isfinite(loss) and loss.item() > 0
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = _jdecode_forward(jp, src, tgt, JCFG)
    got = ts.decode_forward(tp, *_t(src, tgt), TCFG, attn_fn=ATTN[attn])
    assert got.shape == (src.shape[0], tgt.shape[1], FIELDS["vocab"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn", list(ATTN))
def test_encoder_is_bidirectional_and_matches(attn):
    """Flipping the last source token changes the first encoder state
    (impossible under a causal mask), with a source shorter than
    max_src; both encodings match the reference's."""
    jp, tp = _params()
    src, _ = _batch(b=1)
    src2 = src.copy()
    src2[0, -1] = src[0, -1] % (FIELDS["vocab"] - 1) + 1
    outs = []
    for s in (src, src2):
        got = ts.encode(tp, *_t(s), TCFG, ATTN[attn])
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(_jencode(jp, s, JCFG)), **TOL)
        outs.append(got)
    assert not torch.allclose(outs[0][0, 0], outs[1][0, 0])


@pytest.mark.parametrize("attn", list(ATTN))
def test_cross_attention_carries_source_information(attn):
    """Other source content in the encoder output changes the logits; a
    permutation of the encoder positions does not (cross-attention
    carries no positions)."""
    jp, tp = _params()
    src, tgt = _batch(b=2)
    src, tgt = _t(src, tgt)
    fn = ATTN[attn]
    with torch.no_grad():
        enc_out = ts.encode(tp, src, TCFG, fn)
        other = ts.encode(tp, src.roll(1, 0), TCFG, fn)
        l1 = ts.decode_forward(tp, src, tgt, TCFG, enc_out=enc_out,
                               attn_fn=fn)
        l2 = ts.decode_forward(tp, src, tgt, TCFG, enc_out=other,
                               attn_fn=fn)
        l3 = ts.decode_forward(tp, src, tgt, TCFG, enc_out=enc_out.flip(1),
                               attn_fn=fn)
    assert not torch.allclose(l1, l2)
    torch.testing.assert_close(l1, l3, rtol=0, atol=1e-5)


def test_zero_init_cross_path_starts_as_plain_lm():
    """At init wo_x = 0: the decoder ignores the encoder output."""
    tp = ts.init_seq2seq_params(TCFG, 0, device="cpu")
    src, tgt = _t(*_batch(b=2))
    with torch.no_grad():
        enc_out = ts.encode(tp, src, TCFG)
        l1 = ts.decode_forward(tp, src, tgt, TCFG, enc_out=enc_out)
        l2 = ts.decode_forward(tp, src, tgt, TCFG,
                               enc_out=torch.zeros_like(enc_out))
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("attn", list(ATTN))
def test_gqa_decoder_matches(attn):
    jcfg, tcfg = _cfgs(n_kv_heads=2, n_enc_layers=1, n_dec_layers=1,
                       d_ff=64, max_src=8, max_tgt=8)
    jp, tp = _params(jcfg)
    src, _ = _batch(b=2)
    want = _jdecode_forward(jp, src, src, jcfg)
    got = ts.decode_forward(tp, *_t(src, src), tcfg, attn_fn=ATTN[attn])
    assert got.shape == (2, 6, 16) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn", list(ATTN))
def test_loss_and_grads_match(attn):
    jp, tp = _params()
    src, tgt = _batch(2)
    want_loss, want = jax.jit(jax.value_and_grad(functools.partial(
        js.seq2seq_loss_fn, cfg=JCFG)))(jp, (src, tgt))
    paths = list(_paths(tp))
    leaves = [leaf.requires_grad_() for _, leaf in paths]
    loss = ts.seq2seq_loss_fn(tp, _t(src, tgt), TCFG, ATTN[attn])
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = dict(_paths(want))
    assert want.keys() == {p for p, _ in paths}
    for (path, _), g in zip(paths, grads):
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


@pytest.mark.parametrize("attn", list(ATTN))
def test_three_train_steps_match(attn):
    """make_seq2seq_train_step's default optimizer on both sides
    (optax.adamw(1e-3), AdamW(1e-3)), from the init params (wo_x zero)."""
    jp, tp = _params(cross=False)
    jstep, jinit = js.make_seq2seq_train_step(JCFG)
    tstep, tinit = ts.make_seq2seq_train_step(TCFG, attn_fn=ATTN[attn])
    jstep = jax.jit(jstep)
    jstate, tstate = jinit(jp), tinit(tp)
    batch = _batch(3, b=8)
    jlosses, tlosses = [], []
    for _ in range(3):
        jp, jstate, jl = jstep(jp, jstate, batch)
        tp, tstate, tl = tstep(tp, tstate, _t(*batch))
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    assert tlosses == pytest.approx(jlosses, rel=LOSS_RTOL)
    assert tlosses[2] < tlosses[0]
    got, want = dict(_paths(tp)), dict(_paths(jp))
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = np.abs(got[path].detach().numpy() - np.asarray(w))
        assert err.max() <= 2 * 3 * 1e-3, (path, err.max())
        assert (err > PARAM_ATOL).mean() <= 1e-3, (path, err.max())
    # the cross path left its zero init
    assert got[("decoder", "layers", 0, "wo_x")].abs().max() > 0


@pytest.mark.parametrize("attn", list(ATTN))
def test_greedy_decode_matches(attn):
    jp, tp = _params()
    src, _ = _batch(4, b=4, t=8)
    want = _jgreedy(jp, src, JCFG, 8)
    got = ts.greedy_decode(tp, *_t(src), TCFG, steps=8, attn_fn=ATTN[attn])
    assert got.dtype == torch.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_length_and_steps_guards():
    """Past capacity raises, as in the reference: a source past max_src
    (the prefix mask would turn its tail causal), a target past max_tgt
    and steps past max_tgt - 1."""
    tp = ts.init_seq2seq_params(TCFG, 0, device="cpu")
    src, _ = _t(*_batch(b=1))
    long_src = torch.ones((1, FIELDS["max_src"] + 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_src"):
        ts.encode(tp, long_src, TCFG)
    long_tgt = torch.ones((1, FIELDS["max_tgt"] + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_tgt"):
        ts.decode_forward(tp, src, long_tgt, TCFG)
    with pytest.raises(ValueError, match="max_tgt"):
        ts.greedy_decode(tp, src, TCFG, steps=FIELDS["max_tgt"])


def test_cross_attention_flash_equals_reference_math():
    """``_cross_attention`` through ``flash_attention(causal=False)``
    against its einsum pair, GQA folded the same way, t_q != t_kv."""
    rng = np.random.RandomState(5)
    d, h, h_kv = 64, 4, 2
    layer = {"wq_x": torch.from_numpy(rng.randn(d, d).astype(np.float32)
                                      * 0.1),
             "wkv_x": torch.from_numpy(rng.randn(d, 2 * d * h_kv // h)
                                       .astype(np.float32) * 0.1),
             "wo_x": torch.from_numpy(rng.randn(d, d).astype(np.float32)
                                      * 0.1)}
    x = torch.from_numpy(rng.randn(2, 5, d).astype(np.float32))
    enc = torch.from_numpy(rng.randn(2, 11, d).astype(np.float32))
    want = ts._cross_attention(x, enc, layer, h, h_kv)
    got = ts._cross_attention(x, enc, layer, h, h_kv, ta.flash_attention)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
