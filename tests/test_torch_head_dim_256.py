"""Head dim 256 end to end: the port against the reference on the CPU.

A small configuration of the ``HD256`` shape (Gemma-2B's attention
geometry: query heads over one KV head, head dim 256): 2 layers,
d_model 512, 2 query heads over 1 KV head, vocab 256, RoPE, fp32. The
reference's params (``init_params`` from a PRNG key) are converted with
``convert.params_from_jax``, so both sides start from the same weights.
The reference runs its Pallas kernels in interpret mode (flash
attention, the paged read); the port runs the plain versions of its CUDA
kernels, as its wrappers do for CPU tensors. So every one of the five
kernels' functions is held here at head dim 256: B1-B3 through the loss,
its gradients and three train steps, B5 through ``generate`` and
teacher-forced ``decode_step``, B4 through the serving engine.

Tolerances (each stated where it is defined):

- ``LOSS_RTOL``, ``GRAD_REL``: f32 sums in other orders, as in
  ``test_torch_training.py``; a head dim of 256 doubles the terms of
  each score against the training tests' 16, about 1e-7 relative.
- ``PARAM_ATOL`` with its share of elements: Adam's update of a gradient
  element within summation noise of 0 takes either sign (see
  ``test_torch_training.py``).
- ``TOL``: decode and engine logits, two fp32 forwards through two
  layers that differ by summation order only.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import serving as js
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops import attention as ta
from tpu_dra_driver_torch.workloads.ops import decode_attention as td
from tpu_dra_driver_torch.workloads.ops import paged_attention as tpa

# the modules, not the functions of the same names both packages export
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

FIELDS = dict(vocab=256, d_model=512, n_heads=2, n_kv_heads=1, n_layers=2,
              d_ff=512, max_seq=128, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **FIELDS)
B, T = 2, 128
# losses: f32 sums over 256 logits a position and 256 terms a score, in
# other orders (observed below 1e-6 relative)
LOSS_RTOL = 1e-5
# gradients: of each leaf's largest gradient (observed below 1e-6)
GRAD_REL = 1e-5
# params after n AdamW steps: 3e-5 for all but one element in a thousand,
# every element within 2 n lr (Adam moves a near-zero gradient element
# by up to lr either way)
PARAM_ATOL = 3e-5
# decode-step and engine logits: O(0.1) values through two fp32 layers
# differing by summation order (about 1e-7 relative), where a wrong mask,
# position or scale moves them by more than 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jt.init_params(JCFG, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _fresh_params():
    """The reference's params converted anew: the port's to update in
    place or to differentiate."""
    return convert.params_from_jax(jax.tree.map(np.asarray, _params()[0]),
                                   device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], shape).astype(np.int32)


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


def test_the_configuration_has_head_dim_256():
    assert TCFG.d_model // TCFG.n_heads == 256
    assert TCFG.n_heads // TCFG.n_kv_heads == 2
    tp = _params()[1]
    layer = tt.unstack_layer_params(tp)["layers"][0]
    assert layer["wqkv"].shape == (512, 512 + 2 * 256)


def test_loss_and_grads_match_with_flash_attention():
    jp, tp = _params()[0], _fresh_params()
    batch = tuple(_tokens(s, (B, T)) for s in (1, 2))
    loss_fn = jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, cfg=JCFG, attn_fn=ja.flash_attention)))
    want_loss, want = loss_fn(jp, batch)
    paths = list(_paths(tp))
    leaves = [leaf.requires_grad_() for _, leaf in paths]
    loss = tt.loss_fn(tp, tuple(map(torch.from_numpy, batch)), TCFG,
                      attn_fn=ta.flash_attention)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = dict(_paths(want))
    assert sorted(want) == sorted(p for p, _ in paths)
    for (path, _), g in zip(paths, grads):
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_three_train_steps_match():
    jp, tp = _params()[0], _fresh_params()
    jstep, jinit = jt.make_train_step(
        JCFG, optimizer=jt.default_optimizer(warmup_steps=2),
        attn_fn=ja.flash_attention)
    jstep = jax.jit(jstep)
    tstep, tinit = tt.make_train_step(
        TCFG, optimizer=tt.default_optimizer(warmup_steps=2),
        attn_fn=ta.flash_attention)
    jstate, tstate = jinit(jp), tinit(tp)
    batch = tuple(_tokens(s, (B, T)) for s in (3, 4))
    tbatch = tuple(map(torch.from_numpy, batch))
    jlosses, tlosses = [], []
    for _ in range(3):
        jp, jstate, jl = jstep(jp, jstate, batch)
        tp, tstate, tl = tstep(tp, tstate, tbatch)
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    assert tlosses == pytest.approx(jlosses, rel=LOSS_RTOL)
    assert tlosses[2] < tlosses[0]       # warmup: step 0's rate is 0
    got, want = dict(_paths(tp)), dict(_paths(jp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = np.abs(got[path].detach().numpy() - np.asarray(w))
        assert err.max() <= 2 * 3 * 1e-3, (path, err.max())
        assert (err > PARAM_ATOL).mean() <= 1e-3, (path, err.max())


def test_generate_tokens_and_decode_logits_match(monkeypatch):
    """Greedy ``generate`` and teacher-forced ``decode_step`` logits at
    every position; every decode read is B5's function (the cache is 128
    slots long), counted."""
    reads = []
    real = tg.flash_decode_attention

    def counted(q, *args, **kw):
        reads.append(q.shape)
        return real(q, *args, **kw)

    monkeypatch.setattr(tg, "flash_decode_attention", counted)
    jp, tp = _params()
    prompt = _tokens(5, (B, 8))
    want = jg.generate(jp, JCFG, jnp.asarray(prompt), steps=12, max_t=128)
    got = tg.generate(tp, TCFG, torch.from_numpy(prompt), steps=12,
                      max_t=128)
    assert got.dtype == torch.int32 and got.shape == (B, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert reads and set(reads) == {(B, 2, 1, 256)}
    reads.clear()

    step = jax.jit(jg.decode_step, static_argnums=1)
    toks = _tokens(6, (B, 24))
    jcache = jg.init_kv_cache(JCFG, B, 128)
    tcache = tg.init_kv_cache(TCFG, B, 128, device="cpu")
    assert td.decode_block_t(tcache["k"][0].shape[2]) > 0   # B5's read
    for i in range(toks.shape[1]):
        want, jcache = step(jp, JCFG, jcache, jnp.int32(i),
                            jnp.asarray(toks[:, i]))
        got, tcache = tg.decode_step(tp, TCFG, tcache, i,
                                     torch.from_numpy(toks[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
    assert len(reads) == toks.shape[1] * FIELDS["n_layers"]


@functools.partial(jax.jit, static_argnames=("n_live_blocks",))
def _jax_probe(params, pool_ks, pool_vs, tables, lens, tokens,
               n_live_blocks):
    logits, _, _ = js._decode_core(params, JCFG, pool_ks, pool_vs, tables,
                                   lens, tokens, interpret=True,
                                   n_live_blocks=n_live_blocks)
    return logits


def test_engine_next_step_logits_and_tokens_match():
    """Both engines admit the same prompts; their next-step logits (B4's
    function over pools of head dim 256) and the tokens of a decode chunk
    and of the rest of the run agree."""
    jp, tp = _params()
    kw = dict(n_blocks=24, block_t=8, max_batch=3, max_blocks_per_seq=8)
    jeng = js.ServingEngine(jp, JCFG, interpret=True, **kw)
    teng = ts.ServingEngine(tp, TCFG, device="cpu", **kw)
    assert teng.pool_ks[0].shape[-1] == 256
    rng = np.random.RandomState(7)
    for n in (5, 11, 19):
        p = [int(t) for t in rng.randint(0, FIELDS["vocab"], n)]
        assert jeng.add(p, 9) == teng.add(p, 9)
    tokens = np.zeros((3,), np.int32)
    for r in teng.rows:
        tokens[r.row] = r.pending
    n_live = teng._live_blocks_bucket(1)
    want = _jax_probe(jeng.params, jeng.pool_ks, jeng.pool_vs,
                      jnp.asarray(jeng.tables), jnp.asarray(jeng.lens),
                      jnp.asarray(tokens), n_live_blocks=n_live)
    got, _, _ = ts.paged_decode_step(
        teng.params, TCFG, [p.clone() for p in teng.pool_ks],
        [p.clone() for p in teng.pool_vs], torch.from_numpy(teng.tables),
        torch.from_numpy(teng.lens), torch.from_numpy(tokens),
        n_live_blocks=n_live)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert teng.step_chunk() == jeng.step_chunk()
    while any(r is not None for r in teng.rows):
        assert teng.step_chunk() == jeng.step_chunk()
    assert teng.finished == jeng.finished and len(teng.finished) == 3


# Each kernel wrapper's own head-dim rule, checked without a card: d =
# 272 is past every kernel's widest; the second head dim is one its rule
# refuses (B1-B3 and B5 want a multiple of 16 up to 256; B4 rows of a
# multiple of 16 bytes, so bf16 hd 200 is taken and hd 100 is not)
REFUSALS = {
    "B1": (lambda d: ta.check_head_dim("flash_forward", d), 200,
           "multiple of 16 and at most 256"),
    "B2": (lambda d: ta.check_head_dim("flash_backward_dq", d), 248,
           "multiple of 16 and at most 256"),
    "B3": (lambda d: ta.check_head_dim("flash_backward_dkv", d), 40,
           "multiple of 16 and at most 256"),
    "B4": (lambda d: tpa.check_head_dim(d, torch.bfloat16), 100,
           "multiple of 16 bytes up to 256"),
    "B5": (lambda d: td.check_head_dim(d), 200,
           "multiples of 16 up to 256"),
}


@pytest.mark.parametrize("kernel", list(REFUSALS))
@pytest.mark.parametrize("which", ["272", "own_rule"])
def test_each_wrapper_refuses_head_dims_past_its_rule(kernel, which):
    check, refused, words = REFUSALS[kernel]
    d = 272 if which == "272" else refused
    with pytest.raises(ValueError, match=words) as err:
        check(d)
    assert f"got {d}" in str(err.value)
    check(256)                              # the widest head dim is taken
    check(160)


def test_paged_rule_counts_bytes():
    """B4 takes bf16 hd 200 (400-byte rows) and f32 hd 4 (16 bytes),
    which B1-B3 and B5 refuse."""
    tpa.check_head_dim(200, torch.bfloat16)
    tpa.check_head_dim(4, torch.float32)
    with pytest.raises(ValueError, match="got 200"):
        td.check_head_dim(200)
    with pytest.raises(ValueError, match="got 200"):
        ta.check_head_dim("flash_forward", 200)
