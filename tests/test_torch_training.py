"""The port's training path against the reference, on the CPU.

The reference's params (``init_params`` from a PRNG key) are converted
with ``convert.params_from_jax``, so both sides start from the same
weights. Both run ``flash_attention`` as their attention: the reference
its Pallas kernels in interpret mode, the port the plain versions of its
CUDA kernels. Everything is fp32.

Tolerances:

- losses: 1e-5 relative (f32 sums over a few thousand logits, in other
  orders);
- gradients: 1e-5 of each leaf's largest gradient (observed < 1e-6);
- params after n optimizer steps: 3e-5 absolute, 1% of the largest
  move three steps of lr 1e-3 can make, for all but one element in a
  thousand; those few within 2 * n * lr. Adam divides each gradient by
  its own running RMS, so where a gradient element is near zero, below
  the two frameworks' summation differences, its update takes either
  sign at up to lr per step. Observed: at most 1 element in 4096 of a
  leaf beyond 3e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver_torch import entry as tentry
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops import attention as ta

BASE = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq=128, use_rope=True)
B, T = 2, 128
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
PARAM_ATOL = 3e-5


def _cfgs(**kw):
    cfg = {**BASE, **kw}
    return (jt.ModelConfig(dtype=jnp.float32, **cfg),
            tt.ModelConfig(dtype=torch.float32, **cfg))


def _paths(node, path=()):
    """(path, leaf) of a dict/list tree, dict keys in sorted order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _paths(x, path + (i,))
    else:
        yield path, node


def _params(jcfg, seed=0):
    """(reference params, the same params converted for the port)."""
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _batch(seed=0, b=B, t=T, vocab=BASE["vocab"]):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, vocab, (b, t)).astype(np.int32)
                 for _ in range(2))


def _tbatch(batch):
    return tuple(map(torch.from_numpy, batch))


def _jax_loss_and_grads(jp, batch, jcfg, **kw):
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, cfg=jcfg, attn_fn=ja.flash_attention, **kw)))
    loss, grads = fn(jp, batch)
    return float(loss), dict(_paths(grads))


def _torch_loss_and_grads(tp, batch, tcfg, attn_fn=ta.flash_attention,
                          **kw):
    paths = list(_paths(tp))
    leaves = [leaf.requires_grad_() for _, leaf in paths]
    loss = tt.loss_fn(tp, _tbatch(batch), tcfg, attn_fn=attn_fn, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {p: g for (p, _), g in zip(paths, grads)}


def _assert_grads_close(got, want):
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def _assert_params_close(tp, jp, n_steps, lr=1e-3):
    got, want = dict(_paths(tp)), dict(_paths(jp))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = w.detach().numpy() if isinstance(w, torch.Tensor) \
            else np.asarray(w)
        err = np.abs(got[path].detach().numpy() - w)
        assert err.max() <= 2 * n_steps * lr, (path, err.max())
        assert (err > PARAM_ATOL).mean() <= 1e-3, (path, err.max())


def test_forward_logits_match():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    tokens, _ = _batch()
    want = jax.jit(functools.partial(jt.forward, cfg=jcfg,
                                     attn_fn=ja.flash_attention))(jp, tokens)
    got = tt.forward(tp, torch.from_numpy(tokens), tcfg,
                     attn_fn=ta.flash_attention)
    assert got.dtype == torch.float32 and got.shape == (B, T, BASE["vocab"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# name -> (config overrides, loss_fn keywords)
LOSS_CASES = {
    "plain": ({}, {}),
    "exit_layer": ({}, dict(exit_layer=1, exit_weight=0.3)),
    "prefix": (dict(prefix=32), {}),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_grads_match(name):
    overrides, kw = LOSS_CASES[name]
    jcfg, tcfg = _cfgs(**overrides)
    jp, tp = _params(jcfg)
    batch = _batch(1)
    want_loss, want_grads = _jax_loss_and_grads(jp, batch, jcfg, **kw)
    loss, grads = _torch_loss_and_grads(tp, batch, tcfg, **kw)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, want_grads)


def _run_steps(jcfg, tcfg, make_opts, n_steps=3, **kw):
    """n train steps on both sides from the same params, on one batch;
    returns (reference losses, port losses, reference params, port
    params)."""
    jp, tp = _params(jcfg)
    jopt, topt = make_opts()
    jstep, jinit = jt.make_train_step(jcfg, optimizer=jopt,
                                      attn_fn=ja.flash_attention, **kw)
    jstep = jax.jit(jstep)
    tstep, tinit = tt.make_train_step(tcfg, optimizer=topt,
                                      attn_fn=ta.flash_attention, **kw)
    jstate, tstate = jinit(jp), tinit(tp)
    jlosses, tlosses = [], []
    batch = _batch(10)
    for _ in range(n_steps):
        jp, jstate, jl = jstep(jp, jstate, batch)
        tp, tstate, tl = tstep(tp, tstate, _tbatch(batch))
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    return jlosses, tlosses, jp, tp


OPTIMIZERS = {
    "default_optimizer_warmup2": lambda: (jt.default_optimizer(
        warmup_steps=2), tt.default_optimizer(warmup_steps=2)),
    "adamw_1e-3": lambda: (None, None),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_train_steps_match(name):
    jcfg, tcfg = _cfgs()
    jlosses, tlosses, jp, tp = _run_steps(jcfg, tcfg, OPTIMIZERS[name])
    assert tlosses == pytest.approx(jlosses, rel=LOSS_RTOL)
    # the steps did move the params (warmup: step 0's rate is 0)
    assert tlosses[2] < tlosses[0]
    _assert_params_close(tp, jp, n_steps=3)


def test_scan_layers_remat_dots_steps_match():
    """The full-width recipe at a tiny size: stacked [L, ...] layers,
    ``remat`` with the ``"dots"`` policy, a scan unroll, and the
    training optimizer. Converted stacked leaves take ``requires_grad``
    and the optimizer's in-place updates."""
    kw = dict(scan_layers=True, scan_unroll=2, remat=True,
              remat_policy="dots")
    jcfg, tcfg = _cfgs(**kw)
    jlosses, tlosses, jp, tp = _run_steps(
        jcfg, tcfg, lambda: (jt.default_optimizer(warmup_steps=1),
                             tt.default_optimizer(warmup_steps=1)),
        n_steps=2)
    assert isinstance(tp["layers"], dict)
    assert tp["layers"]["wqkv"].shape[0] == BASE["n_layers"]
    assert tlosses == pytest.approx(jlosses, rel=LOSS_RTOL)
    _assert_params_close(tp, jp, n_steps=2)


def test_accum_steps_2_gives_the_accum_1_result():
    _, tcfg = _cfgs()
    jp, _ = _params(_cfgs()[0])
    batch = _tbatch(_batch(4, b=4))
    results = []
    for accum in (1, 2):
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        step, init = tt.make_train_step(tcfg, attn_fn=ta.flash_attention,
                                        accum_steps=accum)
        state = init(tp)
        losses = [step(tp, state, batch)[2].item() for _ in range(2)]
        results.append((losses, tp))
    (l1, p1), (l2, p2) = results
    assert l2 == pytest.approx(l1, rel=LOSS_RTOL)
    _assert_params_close(p2, p1, n_steps=2)
    with pytest.raises(ValueError, match="not divisible"):
        tt.make_train_step(tcfg, accum_steps=3)[0](
            p1, tt.AdamW().init(p1), batch)


def _counting_flash_forward(monkeypatch):
    calls = []
    real = ta.flash_forward

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(ta, "flash_forward", counted)
    return calls


@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_gives_the_same_loss_and_grads(policy, monkeypatch):
    """Checkpointing changes no value. The flash forward is opaque to
    the selective policy, so the backward runs it once more per layer."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    batch = _batch(2)
    want_loss, want_grads = _torch_loss_and_grads(tp, batch, tcfg)
    calls = _counting_flash_forward(monkeypatch)
    rcfg = tt.ModelConfig(**{**tcfg.__dict__, "remat": True,
                             "remat_policy": policy})
    loss, grads = _torch_loss_and_grads(tp, batch, rcfg)
    assert len(calls) == 2 * BASE["n_layers"]
    assert loss == want_loss
    for path, g in want_grads.items():
        np.testing.assert_allclose(grads[path].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=str(path))


def test_no_remat_runs_the_flash_forward_once_per_layer(monkeypatch):
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    calls = _counting_flash_forward(monkeypatch)
    _torch_loss_and_grads(tp, _batch(2), tcfg)
    assert len(calls) == BASE["n_layers"]


def test_unknown_remat_policy_and_moe_raise():
    _, tp = _params(_cfgs()[0])
    _, bad = _cfgs(remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tt.loss_fn(tp, _tbatch(_batch()), bad)
    _, moe = _cfgs(n_experts=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.loss_fn(tt.init_params(moe, 0, device="cpu"), _tbatch(_batch()),
                   moe)


def test_scan_layers_matches_the_list_layout():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    batch = _batch(3)
    want_loss, want_grads = _torch_loss_and_grads(tp, batch, tcfg)
    stacked = tt.stack_layer_params(
        {k: (v if k != "layers" else [{kk: _detach(vv)
                                       for kk, vv in layer.items()}
                                      for layer in v])
         for k, v in tp.items()})
    scfg = tt.ModelConfig(**{**tcfg.__dict__, "scan_layers": True})
    loss, grads = _torch_loss_and_grads(stacked, batch, scfg)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for path, g in grads.items():
        if path[0] != "layers":
            want = want_grads[path]
        else:
            want = torch.stack([want_grads[("layers", i) + path[1:]]
                                for i in range(BASE["n_layers"])])
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


def _detach(node):
    if isinstance(node, dict):
        return {k: _detach(v) for k, v in node.items()}
    return node.detach().clone()


def test_schedule_and_clipping_match_optax():
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=100,
        decay_steps=10_000, end_value=3e-5)
    ours = tt.warmup_cosine_decay(3e-4, 100, 10_000, 3e-5)
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 12_000):
        # optax evaluates the schedule in f32
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5,
                                           abs=1e-12)
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 8), (8,), (3, 2, 5))]
    clip = optax.clip_by_global_norm(1.0)
    for scale in (1e-3, 10.0):           # below and above the threshold
        want, _ = clip.update([scale * g for g in grads], clip.init(grads))
        got = [torch.from_numpy(scale * g) for g in grads]
        tt._clip_by_global_norm(got, 1.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


def test_default_optimizer_kinds():
    opt = tt.default_optimizer()
    assert opt.weight_decay == 0.1 and opt.clip_norm == 1.0
    assert opt.learning_rate(0) == 0.0
    assert tt.AdamW().weight_decay == 1e-4 and tt.AdamW().eps == 1e-8
    with pytest.raises(NotImplementedError, match="adafactor"):
        tt.default_optimizer(kind="adafactor")
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        tt.default_optimizer(kind="sgd")


def test_param_count_matches_the_reference():
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    assert tt.param_count(tp) == jt.param_count(jp)


def test_entry_loss_matches_the_reference_entry():
    """``entry(device="cpu")``'s function on the reference entry's own
    example args, converted, gives the reference's loss. The config is
    bf16, so the tolerance is bf16's: 2^-8 of the loss."""
    jfn, (jparams, (jtok, jtgt)) = __graft_entry__.entry()
    want = float(jax.jit(jfn)(jparams, (jtok, jtgt)))
    fn, (params, (tokens, targets)) = tentry.entry(device="cpu")
    assert tokens.shape == tuple(jtok.shape) and tokens.dtype == torch.int32
    assert params["embed"].dtype == torch.bfloat16
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    got = fn(tp, (torch.from_numpy(np.array(jtok)),
                  torch.from_numpy(np.array(jtgt)))).item()
    assert got == pytest.approx(want, rel=2 ** -8)
    own = fn(params, (tokens, targets)).item()
    assert np.isfinite(own) and abs(own - np.log(tentry.CONFIG.vocab)) < 0.5
