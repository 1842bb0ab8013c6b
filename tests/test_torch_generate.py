"""The port's KV-cache generation path against the reference, on the CPU.

The reference's params (``init_params`` from a PRNG key) are converted
with ``convert.params_from_jax``; everything is fp32. The port's g = 1
decode read is ``flash_decode_attention`` (its kernel's plain version on
the CPU) wherever the cache length has a 128-multiple divisor, and the
masked read otherwise; the reference takes the masked read everywhere.

Tolerances: logits and cache contents to 1e-4 relative and 1e-5
absolute, as for the serving path (two fp32 forwards through two layers
differ by summation order only, about 1e-7 relative per contraction;
the logits are O(0.1), and a wrong mask, position or scale moves them by
more than 1e-3). Generated tokens must be identical. Sampling draws
from other random streams than the reference's, so it is checked by its
law: ``top_k=1`` is greedy, one generator seed repeats its tokens, and
no token outside the top k is drawn.
"""

import functools
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import quantize as tq
from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt

# the modules, not the functions of the same names both packages export
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-5)
_FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_seq=256, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)


def _cfgs(**kw):
    return replace(JCFG, **kw), replace(TCFG, **kw)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jt.init_params(JCFG, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab, shape).astype(np.int32)


def _assert_caches_match(jcache, tcache):
    assert sorted(jcache) == sorted(tcache)
    for key in jcache:
        for ja, ta in zip(jcache[key], tcache[key]):
            np.testing.assert_allclose(ta.numpy().astype(np.float32),
                                       np.asarray(ja, np.float32), **TOL)


@functools.partial(jax.jit, static_argnums=1)
def _jax_decode_step(params, cfg, cache, pos, token):
    return jg.decode_step(params, cfg, cache, pos, token)


_jax_wide_step = jax.jit(jg.wide_step, static_argnums=1)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the port's calls of ``flash_decode_attention`` from
    ``wide_step``."""
    calls = []
    real = tg.flash_decode_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tg, "flash_decode_attention", counting)
    return calls


# name -> (config changes, stream length, the read wide_step takes)
TEACHER_FORCED = {
    "full_length": ({}, 24, "flash"),
    "ring_window_16": ({"window": 16}, 24, "masked"),
    "ring_window_128_wrapped": ({"window": 128}, 150, "flash"),
    "kv_int8": ({"kv_int8": True}, 24, "flash"),
}


@pytest.mark.parametrize("name", list(TEACHER_FORCED))
def test_teacher_forced_decode_step_logits(name, flash_calls):
    changes, t, read = TEACHER_FORCED[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params()
    b = 2
    toks = _tokens(1, (b, t))
    jcache = jg.init_kv_cache(jcfg, b, t)
    tcache = tg.init_kv_cache(tcfg, b, t, device="cpu")
    for i in range(t):
        want, jcache = _jax_decode_step(jp, jcfg, jcache, jnp.int32(i),
                                        jnp.asarray(toks[:, i]))
        got, tcache = tg.decode_step(tp, tcfg, tcache, i,
                                     torch.from_numpy(toks[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
    _assert_caches_match(jcache, tcache)
    expect = t * TCFG.n_layers if read == "flash" else 0
    assert len(flash_calls) == expect


def test_wide_step_with_several_tokens():
    jp, tp = _params()
    b, t0, g = 2, 8, 4
    prompt, more = _tokens(2, (b, t0)), _tokens(3, (b, g))
    jcache = jg.init_kv_cache(JCFG, b, 32)
    tcache = tg.init_kv_cache(TCFG, b, 32, device="cpu")
    _, jcache, _ = jax.jit(jg.block_prefill, static_argnums=1)(
        jp, JCFG, jcache, jnp.asarray(prompt))
    _, tcache, _ = tg.block_prefill(tp, TCFG, tcache,
                                    torch.from_numpy(prompt))
    want, jcache = _jax_wide_step(jp, JCFG, jcache, jnp.int32(t0),
                                  jnp.asarray(more))
    got, tcache = tg.wide_step(tp, TCFG, tcache, t0, torch.from_numpy(more))
    assert got.shape == (b, g, JCFG.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches_match(jcache, tcache)
    with pytest.raises(ValueError, match="window == 0"):
        tg.wide_step(tp, replace(TCFG, window=16),
                     tg.init_kv_cache(replace(TCFG, window=16), b, 32,
                                      device="cpu"), 0,
                     torch.from_numpy(more))


def test_chunked_prefill_matches_reference_and_block_prefill():
    jp, tp = _params()
    b, t0 = 2, 32
    toks = _tokens(4, (b, t0))
    jcache = jg.init_kv_cache(JCFG, b, 64)
    jl, jcache, jpos = jg.chunked_prefill(jp, JCFG, jcache,
                                          jnp.asarray(toks), chunk=8)
    tcache = tg.init_kv_cache(TCFG, b, 64, device="cpu")
    tl, tcache, tpos = tg.chunked_prefill(tp, TCFG, tcache,
                                          torch.from_numpy(toks), chunk=8)
    assert int(jpos) == tpos == t0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_match(jcache, tcache)
    bcache = tg.init_kv_cache(TCFG, b, 64, device="cpu")
    bl, bcache, _ = tg.block_prefill(tp, TCFG, bcache, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), bl.numpy(), rtol=1e-4, atol=1e-4)
    for key in bcache:
        for x, y in zip(bcache[key], tcache[key]):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-4,
                                       atol=1e-4)


# name -> (config changes, prompt length, steps, generate keywords)
GENERATE = {
    "block_prefill": ({}, 8, 12, {}),
    "prefill_chunk": ({}, 16, 12, {"prefill_chunk": 4}),
    "ring_window_128_wrapped": ({"window": 128}, 8, 130, {}),
    "kv_int8": ({"kv_int8": True}, 8, 12, {}),
}


@pytest.mark.parametrize("name", list(GENERATE))
def test_greedy_generate_tokens(name):
    changes, t0, steps, kw = GENERATE[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params()
    prompt = _tokens(5, (2, t0))
    want = jg.generate(jp, jcfg, jnp.asarray(prompt), steps=steps, **kw)
    got = tg.generate(tp, tcfg, torch.from_numpy(prompt), steps=steps, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, t0 + steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if "prefill_chunk" in kw:
        block = tg.generate(tp, tcfg, torch.from_numpy(prompt), steps=steps)
        np.testing.assert_array_equal(got.numpy(), block.numpy())


def test_truncate_top_k_keeps_ties():
    logits = np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                         [5.0, 4.0, 4.0, 4.0, -1.0, 2.0]], np.float32)
    for k in (0, 1, 2, 4, 6):
        want = np.asarray(jg.truncate_top_k(jnp.asarray(logits), k))
        got = tg.truncate_top_k(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got, want)
    # the tied boundary keeps all three 3.0s (and all three 4.0s) at k=2
    kept = tg.truncate_top_k(torch.from_numpy(logits), 2) > -1e29
    assert kept.sum(-1).tolist() == [3, 4]


def _sample(tp, prompt, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tg.generate(tp, TCFG, torch.from_numpy(prompt), steps=16,
                       generator=gen, **kw)


def test_sampling_laws():
    _, tp = _params()
    prompt = _tokens(6, (4, 6))
    greedy = tg.generate(tp, TCFG, torch.from_numpy(prompt), steps=16)
    top1 = _sample(tp, prompt, 0, temperature=0.7, top_k=1)
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    s1 = _sample(tp, prompt, 1, temperature=1.0)
    np.testing.assert_array_equal(_sample(tp, prompt, 1, temperature=1.0),
                                  s1)
    assert not torch.equal(s1, _sample(tp, prompt, 2, temperature=1.0))
    assert torch.equal(s1[:, :6], torch.from_numpy(prompt))
    # every draw of top_k=3 is among the 3 highest logits of its step
    # (ties included), read back by teacher forcing the drawn stream
    k = 3
    drawn = _sample(tp, prompt, 3, temperature=1.0, top_k=k)
    cache = tg.init_kv_cache(TCFG, 4, drawn.shape[1], device="cpu")
    for pos in range(drawn.shape[1] - 1):
        logits, cache = tg.decode_step(tp, TCFG, cache, pos, drawn[:, pos])
        if pos >= prompt.shape[1] - 1:
            kth = torch.topk(logits, k, dim=-1).values[:, -1]
            chosen = logits.gather(1, drawn[:, pos + 1, None].long())[:, 0]
            assert (chosen >= kth - 1e-4).all(), pos


@pytest.mark.parametrize("kw,changes,match", [
    ({"prefill_chunk": 4}, {}, "chunks"),
    ({"prefill_chunk": 5}, {"window": 8}, "full-length"),
    ({"prefill_chunk": 5}, {"prefix": 4}, "causal-only"),
    ({"temperature": 0.5}, {}, "requires a PRNG key"),
    ({"top_k": 3}, {}, "no effect at temperature=0"),
    ({"temperature": -1.0}, {}, "temperature must be >= 0"),
])
def test_generate_validation(kw, changes, match):
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params()
    prompt = _tokens(7, (2, 10))
    for gen, params, cfg, p in (
            (jg.generate, jp, jcfg, jnp.asarray(prompt)),
            (tg.generate, tp, tcfg, torch.from_numpy(prompt))):
        with pytest.raises(ValueError, match=match):
            gen(params, cfg, p, steps=4, **kw)


def test_evaluate_nll_matches_reference():
    jp, tp = _params()
    batches = [_tokens(10 + i, (4, 16)) for i in range(3)]
    want = jg.evaluate_nll(jp, JCFG, iter([(jnp.asarray(t), jnp.asarray(t))
                                           for t in batches]))
    got = tg.evaluate_nll(tp, TCFG, iter([(torch.from_numpy(t),
                                           torch.from_numpy(t))
                                          for t in batches]))
    assert got["tokens"] == want["tokens"] == 3 * 4 * 16
    assert abs(got["nll"] - want["nll"]) <= 1e-5 * want["nll"]
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]
    with pytest.raises(ValueError, match="empty"):
        tg.evaluate_nll(tp, TCFG, iter([]))


def test_param_bytes_and_is_quantized_match_reference():
    jp, tp = _params()
    jqp = jq.quantize_params(jp)
    tqp = convert.params_from_jax(jax.tree.map(np.asarray, jqp),
                                  device="cpu")
    assert tq.param_bytes(tp) == jq.param_bytes(jp)
    assert tq.param_bytes(tqp) == jq.param_bytes(jqp)
    assert tq.param_bytes(tq.quantize_params(tp)) == jq.param_bytes(jqp)
    assert not tq.is_quantized(tp) and not jq.is_quantized(jp)
    assert tq.is_quantized(tqp) and jq.is_quantized(jqp)


TINY = tt.ModelConfig(vocab=64, d_model=64, n_heads=4, n_layers=1, d_ff=64,
                      max_seq=24, use_rope=True, dtype=torch.float32)


def test_decode_tokens_per_sec_runs_on_the_cpu():
    out = tg.decode_tokens_per_sec(b=2, prompt_len=4, gen_short=2,
                                   gen_long=6, iters=1, cfg=TINY,
                                   device="cpu")
    assert out["decode_tokens_per_sec"] > 0
    q = tg.decode_tokens_per_sec(b=2, prompt_len=4, gen_short=2, gen_long=6,
                                 iters=1, cfg=TINY, quantized=True,
                                 device="cpu")
    assert q["param_mib"] < out["param_mib"] and q["shape"].endswith("int8")


def test_serving_throughput_outputs_equal_sequential_generate():
    _, tp = _params()
    prompts = [[int(t) for t in _tokens(20 + i, (n,))]
               for i, n in enumerate((5, 9, 7))]
    out = ts.serving_throughput(tp, TCFG, prompts, max_new_tokens=6,
                                n_blocks=16, block_t=8, max_batch=2,
                                max_blocks_per_seq=4, device="cpu")
    assert out["outputs"] == out["sequential_outputs"]
    assert sorted(out["outputs"]) == [0, 1, 2]
    assert all(len(o) == 6 for o in out["outputs"].values())
    assert out["engine_tokens_per_sec"] > 0
    assert out["sequential_tokens_per_sec"] > 0
    assert out["engine_device_tokens_per_sec"] is None       # no card


def test_train_tokens_per_sec_runs_on_the_cpu():
    cfg = tt.ModelConfig(vocab=128, d_model=64, n_heads=2, n_layers=2,
                         d_ff=128, max_seq=16, use_rope=True, remat=True,
                         scan_layers=True)
    out = tt.train_tokens_per_sec(b=2, t=16, iters=1, steps_short=1,
                                  steps_long=3, cfg=cfg, device="cpu")
    assert out["train_tokens_per_sec"] > 0 and out["params_m"] > 0
    assert out["shape"].endswith("flash")


@pytest.mark.parametrize("use_flash", [True, False, None])
def test_train_tokens_per_sec_use_flash_picks_the_attention(use_flash,
                                                           monkeypatch):
    """``use_flash`` as the reference names it: True (the default, None
    here) runs ``flash_attention``, False ``attention_reference``; the
    shape string says which, as the reference's does."""
    calls = []

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tt, "flash_attention",
                        counted("flash", tt.flash_attention))
    monkeypatch.setattr(tt, "attention_reference",
                        counted("reference", tt.attention_reference))
    cfg = tt.ModelConfig(vocab=128, d_model=64, n_heads=2, n_layers=2,
                         d_ff=128, max_seq=16, use_rope=True)
    kw = {} if use_flash is None else {"use_flash": use_flash}
    out = tt.train_tokens_per_sec(b=2, t=16, iters=1, steps_short=1,
                                  steps_long=2, cfg=cfg, device="cpu", **kw)
    flash = use_flash is not False
    assert set(calls) == {"flash" if flash else "reference"}
    assert out["shape"] == "b2 t16 L2 d64" + (" flash" if flash else "")
    assert out["train_tokens_per_sec"] > 0
