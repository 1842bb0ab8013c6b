"""The port's mixture-of-experts FFN against the reference, on the CPU.

``_moe`` (dense, softmax-gated), ``_moe_topk`` (top-k with capacity) and
``_ffn``'s choice between them and the MLP are fed the same numpy-seeded
inputs on both sides; the model paths that share ``_ffn`` (the loss and
its gradients, with ``scan_layers`` and ``remat``; int8 expert banks;
``generate``'s replayed step body and the engine's chunk of steps, both
under a dispatch mode that raises on any host read) start from the
reference's params carried across with ``convert.params_from_jax``.

Tolerances (everything fp32): 1e-5 relative and absolute for the FFNs
and the logits (two BLAS libraries summing a few hundred O(1) terms in
other orders); losses 1e-5 relative; gradients 1e-5 of each leaf's
largest; greedy tokens equal. A token routed to the wrong expert or
slot moves its output by O(1) of the expert outputs, far above these.
"""

import functools
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_dra_driver.workloads.models import serving as js
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import quantize as tq
from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt

# the modules, not the functions of the same names both packages export
jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

TOL = dict(rtol=1e-5, atol=1e-5)
_FIELDS = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=64, max_seq=128, use_rope=True, n_experts=4,
               moe_top_k=2)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class NoHostReads(TorchDispatchMode):
    """Raises on ``aten._local_scalar_dense``, which ``.item()``,
    ``int()``, ``float()`` and ``bool()`` of a tensor reach: such a read
    of a device value cannot be captured in a CUDA graph."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor's value was read on the host")
        return func(*args, **(kwargs or {}))


def _cfgs(**kw):
    return replace(JCFG, **kw), replace(TCFG, **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(seed, d=16, ff=32, n_e=4, router_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"router": (router_scale * rng.standard_normal((d, n_e))
                       ).astype(np.float32),
            "moe_up": (0.1 * rng.standard_normal((n_e, d, ff))
                       ).astype(np.float32),
            "moe_down": (0.1 * rng.standard_normal((n_e, ff, d))
                         ).astype(np.float32)}


def _x(seed, b=2, t=8, d=16):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


def _both(fn_j, fn_t, x, layer, *args):
    want = fn_j(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
                *args)
    got = fn_t(_t(x), {k: _t(v) for k, v in layer.items()}, *args)
    return got, np.asarray(want)


def test_dense_moe_matches_reference():
    got, want = _both(jt._moe, tt._moe, _x(0), _layer(1))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (top_k, capacity factor): one and two experts a token with the usual
# slack; a capacity of 2 slots for 8 tokens over 4 experts, which drops
# most of them; every expert with ample capacity
TOPK_CASES = [(1, 1.25), (2, 1.25), (2, 0.5), (4, 4.0)]


@pytest.mark.parametrize("top_k,capacity_factor", TOPK_CASES)
def test_topk_moe_matches_reference(top_k, capacity_factor):
    got, want = _both(jt._moe_topk, tt._moe_topk, _x(2), _layer(3),
                      top_k, capacity_factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if capacity_factor < 1:
        # tokens over capacity are dropped: their rows are zero
        assert (np.abs(want).sum(-1) == 0).any()


def test_topk_with_every_expert_equals_dense():
    """top_k = n_experts with ample capacity drops nothing, and the
    renormalized top-k softmax is the full softmax."""
    x, layer = _t(_x(4)), {k: _t(v) for k, v in _layer(5).items()}
    np.testing.assert_allclose(tt._moe_topk(x, layer, 4, 4.0).numpy(),
                               tt._moe(x, layer).numpy(), **TOL)


def test_capacity_one_keeps_only_the_first_token():
    """Every token routed to expert 0 with one slot: the first token in
    (t) order takes it, the rest contribute zero."""
    b, t, d, ff, n_e = 1, 4, 8, 8, 2
    router = np.zeros((d, n_e), np.float32)
    router[:, 0] = 1.0
    layer = {"router": router,
             "moe_up": np.full((n_e, d, ff), 0.1, np.float32),
             "moe_down": np.full((n_e, ff, d), 0.1, np.float32)}
    x = np.ones((b, t, d), np.float32)
    got, want = _both(jt._moe_topk, tt._moe_topk, x, layer, 1, 0.25)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    contributing = got.abs().sum(-1)[0] > 1e-6
    assert contributing.tolist() == [True, False, False, False]


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_ties_take_the_lower_expert_index(top_k):
    """A zero router makes every logit equal: the reference's
    ``lax.top_k`` picks experts 0..k-1, and so must the port."""
    layer = _layer(6)
    layer["router"] = np.zeros_like(layer["router"])
    got, want = _both(jt._moe_topk, tt._moe_topk, _x(7), layer, top_k, 2.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    vals, idx = tt._top_k(torch.zeros(2, 3, 4), top_k)
    assert idx.tolist() == [[list(range(top_k))] * 3] * 2
    assert torch.equal(vals, torch.zeros(2, 3, top_k))


@pytest.mark.parametrize("moe_top_k", [0, 2])
def test_ffn_chooses_the_moe_and_dequantizes_int8_banks(moe_top_k):
    jcfg, tcfg = _cfgs(moe_top_k=moe_top_k)
    x, layer = _x(8), _layer(9)
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
    tlayer = {k: _t(v) for k, v in layer.items()}
    np.testing.assert_allclose(
        tt._ffn(_t(x), tlayer, tcfg).numpy(),
        np.asarray(jt._ffn(jnp.asarray(x), jlayer, jcfg)), **TOL)
    # int8 banks (the router stays fp): dequantized for the einsums
    jql = {k: (jq.quantize(v) if k != "router" else v)
           for k, v in jlayer.items()}
    tql = {k: (tq.quantize(v) if k != "router" else v)
           for k, v in tlayer.items()}
    assert tq.ffn_weights(tlayer, torch.float32) is tlayer
    deq = tq.ffn_weights(tql, torch.float32)
    assert deq["router"] is tql["router"]
    assert torch.equal(deq["moe_up"], tql["moe_up"].dequant(torch.float32))
    np.testing.assert_allclose(
        tt._ffn(_t(x), tql, tcfg).numpy(),
        np.asarray(jt._ffn(jnp.asarray(x), jql, jcfg)), **TOL)


# ---------------------------------------------------------------- model

def _paths(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _paths(x, path + (i,))
    else:
        yield path, node


@functools.lru_cache(maxsize=None)
def _jax_params(scan_layers=False):
    return jt.init_params(replace(JCFG, scan_layers=scan_layers),
                          jax.random.PRNGKey(0))


def _params(scan_layers=False):
    jp = _jax_params(scan_layers)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab, shape).astype(np.int32)


# name -> config changes: top-2 routing as listed, as stacked layers
# under the full-width recipe's remat, and the dense mixture
LOSS_CASES = {
    "top2": {},
    "top2_scan_remat_dots": dict(scan_layers=True, remat=True,
                                 remat_policy="dots"),
    "dense_mixture": dict(moe_top_k=0),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_grads_match(name):
    jcfg, tcfg = _cfgs(**LOSS_CASES[name])
    jp, tp = _params(jcfg.scan_layers)
    tokens, targets = _tokens(1, (2, 32)), _tokens(2, (2, 32))
    want, jgrads = jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, cfg=jcfg)))(jp, (tokens, targets))
    paths = list(_paths(tp))
    leaves = [leaf.requires_grad_() for _, leaf in paths]
    loss = tt.loss_fn(tp, (_t(tokens), _t(targets)), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    jgrads = dict(_paths(jgrads))
    assert sorted(jgrads) == sorted(p for p, _ in paths)
    for (path, _), g in zip(paths, grads):
        w = np.asarray(jgrads[path])
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (path, err)


def test_quantized_moe_forward_matches_reference():
    """The reference's ``test_quantized_moe_forward`` scenario: int8
    weights and expert banks, the router fp; the port's logits equal the
    reference's quantized logits and stay near the fp model's."""
    jp, tp = _params()
    tokens = _tokens(3, (2, 16))
    jl = jax.jit(functools.partial(jt.forward, cfg=JCFG))(
        jq.quantize_params(jp), jnp.asarray(tokens))
    qp = tq.quantize_params(tp)
    assert isinstance(qp["layers"][0]["moe_up"], tq.QTensor)
    assert not isinstance(qp["layers"][0]["router"], tq.QTensor)
    got = tt.forward(qp, _t(tokens), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    fp = tt.forward(tp, _t(tokens), TCFG).detach().numpy().ravel()
    q = got.numpy().ravel().astype(np.float64)
    cos = (fp @ q) / (np.linalg.norm(fp) * np.linalg.norm(q))
    assert cos > 0.99, cos


# name -> (config changes, int8 weights)
GENERATE_CASES = {
    "top2": ({}, False),
    "top2_int8": ({}, True),
    "dense_mixture": (dict(moe_top_k=0), False),
    "dense_mixture_int8": (dict(moe_top_k=0), True),
}


@pytest.mark.parametrize("name", list(GENERATE_CASES))
def test_generate_greedy_tokens_match_without_host_reads(name):
    """``generate``'s block prefill, then its step body run once per
    step (the body the card captures and replays) under
    :class:`NoHostReads`: the reference's greedy tokens."""
    changes, int8 = GENERATE_CASES[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params()
    if int8:
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    prompt = _tokens(4, (2, 12))
    want = jg.generate(jp, jcfg, jnp.asarray(prompt), steps=10)
    with NoHostReads():
        got = tg.generate(tp, tcfg, _t(prompt), steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("moe_top_k,int8", [(2, False), (2, True),
                                              (0, False)])
def test_engine_chunk_matches_reference_steps_without_host_reads(moe_top_k,
                                                                 int8):
    """The engine's step body (top-2 with float and int8 banks, the
    dense mixture), run 4 times by ``step_chunk`` under
    :class:`NoHostReads`, against the reference's scanned
    ``paged_decode_steps`` from the same state: rows of 5 and 11 tokens
    over 8-token blocks (the second crosses a block edge) and one idle
    row; tokens equal, pools within the tolerance."""
    jcfg, tcfg = _cfgs(moe_top_k=moe_top_k)
    jp, tp = _params()
    if int8:
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    kw = dict(n_blocks=24, block_t=8, max_batch=3, max_blocks_per_seq=8)
    jeng = js.ServingEngine(jp, jcfg, interpret=True, **kw)
    teng = ts.ServingEngine(tp, tcfg, device="cpu", **kw)
    for n in (5, 11):
        p = [int(t) for t in _tokens(n, (n,))]
        jeng.add(p, 10)
        teng.add(p, 10)
    assert [r.pending for r in teng.rows if r is not None] == \
        [r.pending for r in jeng.rows if r is not None]
    tokens = np.zeros((3,), np.int32)
    for r in teng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    k = 4
    n_live = teng._live_blocks_bucket(k)
    jtoks, jks, jvs = js.paged_decode_steps(
        jeng.params, jcfg, list(jeng.pool_ks), list(jeng.pool_vs),
        jnp.asarray(jeng.tables), jnp.asarray(jeng.lens),
        jnp.asarray(tokens), n_steps=k, interpret=True,
        n_live_blocks=n_live)
    with NoHostReads():
        got = teng.step_chunk(max_steps=k)
    jtoks = np.asarray(jtoks)
    assert got == {0: jtoks[0].tolist(), 1: jtoks[1].tolist()}
    for li in range(JCFG.n_layers):
        for tpool, jpool in ((teng.pool_ks, jks), (teng.pool_vs, jvs)):
            np.testing.assert_allclose(tpool[li].numpy()[1:],
                                       np.asarray(jpool[li])[1:],
                                       rtol=1e-4, atol=1e-5)
