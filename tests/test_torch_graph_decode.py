"""The port's decode steps with their position on the device: the step
bodies that the card captures in a CUDA graph and replays, run here on
the CPU, against the reference and against the int-position path.

- ``apply_rope``, ``decode_step`` and ``wide_step`` with a 0-d int32
  tensor position, and ``_cache_write`` with the slots' indices on the
  device, are bit-identical to the same calls with an int (the
  positions are integers below 2^24, exact in f32, and every other
  operation computes the same values), and are held against the
  reference at a ``jnp.int32`` (traced) position to 1e-4 relative and
  1e-5 absolute: two fp32 forwards through two layers differ by
  summation order only, about 1e-7 relative per contraction, while a
  wrong position or slot moves the O(0.1) logits by more than 1e-3.
- ``generate``'s step body (its decode loop, and the ring prefill) and
  the engine's step body, run eagerly n times, give the reference's
  greedy tokens (identical) and pools (to the tolerance above); so does
  the engine's admission body, run once from its device buffers.
- Both run under :class:`NoHostReads`, which raises where a tensor's
  value is read on the host (``.item()``, ``int()``, ``bool()``): such a
  read of a device value cannot be captured.
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
from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph

# the modules, not the functions of the same names both packages export
jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

TOL = dict(rtol=1e-4, atol=1e-5)
_FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_seq=256, use_rope=True)
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
    ``int()``, ``float()`` and ``bool()`` of a tensor reach."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor's value was read on the host")
        return func(*args, **(kwargs or {}))


def _cfgs(**kw):
    return replace(JCFG, **kw), replace(TCFG, **kw)


@functools.lru_cache(maxsize=None)
def _params(use_rope=True):
    jp = jt.init_params(replace(JCFG, use_rope=use_rope),
                        jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab, shape).astype(np.int32)


def _pos(p):
    return torch.tensor(p, dtype=torch.int32)


@functools.partial(jax.jit, static_argnums=1)
def _jax_decode_step(params, cfg, cache, pos, token):
    return jg.decode_step(params, cfg, cache, pos, token)


_jax_wide_step = jax.jit(jg.wide_step, static_argnums=1)


def _assert_caches_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key


def _assert_caches_match(jcache, tcache):
    for key in jcache:
        for ja, ta in zip(jcache[key], tcache[key]):
            np.testing.assert_allclose(ta.numpy().astype(np.float32),
                                       np.asarray(ja, np.float32), **TOL)


def test_no_host_reads_catches_a_host_read():
    """The check itself: reading a tensor's value raises, and so does
    the host-position ``arange`` that ``apply_rope`` used for a tensor."""
    pos = _pos(3)
    with NoHostReads():
        with pytest.raises(AssertionError, match="read on the host"):
            int(pos)
        with pytest.raises(AssertionError, match="read on the host"):
            torch.arange(pos, pos + 4)
        torch.arange(4) + pos                  # made on the device: fine


@pytest.mark.parametrize("pos,t", [(0, 1), (7, 1), (300, 4), (2047, 3)])
def test_apply_rope_device_position(pos, t):
    x = np.random.RandomState(pos).randn(2, 4, t, 16).astype(np.float32)
    want = tt.apply_rope(torch.from_numpy(x), pos0=pos)
    with NoHostReads():
        got = tt.apply_rope(torch.from_numpy(x), pos0=_pos(pos))
    assert torch.equal(got, want)
    ref = jt.apply_rope(jnp.asarray(x), pos0=jnp.int32(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("slot,g", [(0, 1), (5, 1), (127, 1), (9, 3)])
def test_cache_write_device_slot(kv_int8, slot, g):
    cfg = replace(TCFG, kv_int8=kv_int8)
    vals = torch.from_numpy(np.random.RandomState(slot).randn(
        2, 2, g, 16).astype(np.float32))
    caches = [tg.init_kv_cache(cfg, 2, 128, device="cpu") for _ in range(2)]
    tg._cache_write(caches[0], "k", 1, vals, slot)
    with NoHostReads():
        tg._cache_write(caches[1], "k", 1, vals,
                        _pos(slot) + torch.arange(g))
    _assert_caches_equal(*caches)
    written = caches[0]["k"][1][:, :, slot:slot + g]
    assert written.abs().sum() > 0
    if not kv_int8:
        assert torch.equal(written, vals)


# name -> (config changes, stream length): every read of decode_step,
# B5's plain version (full length, int8, the 128-slot ring past its
# wrap) and the masked read (the 16-slot ring), and the learned pos_embed
DEVICE_POS = {
    "full_length": ({}, 20),
    "kv_int8": ({"kv_int8": True}, 20),
    "ring_window_16": ({"window": 16}, 24),
    "ring_window_128_wrapped": ({"window": 128}, 140),
    "learned_pos_embed": ({"use_rope": False}, 20),
}


@pytest.mark.parametrize("name", list(DEVICE_POS))
def test_decode_step_device_position(name):
    changes, t = DEVICE_POS[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params(tcfg.use_rope)
    b = 2
    toks = _tokens(1, (b, t))
    jcache = jg.init_kv_cache(jcfg, b, t)
    caches = [tg.init_kv_cache(tcfg, b, t, device="cpu") for _ in range(2)]
    for pos in range(t):
        tok = torch.from_numpy(toks[:, pos])
        want, caches[0] = tg.decode_step(tp, tcfg, caches[0], pos, tok)
        with NoHostReads():
            got, caches[1] = tg.decode_step(tp, tcfg, caches[1], _pos(pos),
                                            tok)
        assert torch.equal(got, want), pos
        ref, jcache = _jax_decode_step(jp, jcfg, jcache, jnp.int32(pos),
                                       jnp.asarray(toks[:, pos]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    _assert_caches_equal(*caches)
    _assert_caches_match(jcache, caches[1])


@pytest.mark.parametrize("use_rope", [True, False])
def test_wide_step_device_position(use_rope):
    jcfg, tcfg = _cfgs(use_rope=use_rope)
    jp, tp = _params(use_rope)
    b, t0, g = 2, 9, 4
    toks = _tokens(2, (b, t0 + g))
    jcache = jg.init_kv_cache(jcfg, b, t0 + g)
    _, jcache = _jax_wide_step(jp, jcfg, jcache, jnp.int32(0),
                               jnp.asarray(toks[:, :t0]))
    ref, jcache = _jax_wide_step(jp, jcfg, jcache, jnp.int32(t0),
                                 jnp.asarray(toks[:, t0:]))
    outs, caches = [], []
    for pos in ((0, t0), (_pos(0), _pos(t0))):
        cache = tg.init_kv_cache(tcfg, b, t0 + g, device="cpu")
        with NoHostReads():
            _, cache = tg.wide_step(tp, tcfg, cache, pos[0],
                                    torch.from_numpy(toks[:, :t0]))
            logits, cache = tg.wide_step(tp, tcfg, cache, pos[1],
                                         torch.from_numpy(toks[:, t0:]))
        outs.append(logits)
        caches.append(cache)
    assert torch.equal(outs[1], outs[0])
    _assert_caches_equal(*caches)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(ref), **TOL)
    _assert_caches_match(jcache, caches[1])


# name -> (config changes, prompt length, steps): the decode loop after a
# block prefill, with an int8 cache, and the ring prefill and decode of a
# 16-slot ring (masked read) and of a 128-slot ring that wraps (B5)
GENERATE = {
    "block_prefill": ({}, 8, 12),
    "kv_int8": ({"kv_int8": True}, 8, 12),
    "ring_window_16": ({"window": 16}, 10, 14),
    "ring_window_128_wrapped": ({"window": 128}, 8, 130),
}


@pytest.mark.parametrize("name", list(GENERATE))
def test_generate_step_body_matches_reference(name):
    changes, t0, steps = GENERATE[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params()
    prompt = _tokens(5, (2, t0))
    want = jg.generate(jp, jcfg, jnp.asarray(prompt), steps=steps)
    # the body generate captures on the card, run step by step here
    cache = tg.init_kv_cache(tcfg, 2, t0 + steps, device="cpu")
    out = torch.zeros((2, t0 + steps), dtype=torch.int32)
    out[:, :t0] = torch.from_numpy(prompt)
    pos = torch.zeros((), dtype=torch.int32)
    pick = lambda logits: logits.argmax(-1).to(torch.int32)  # noqa: E731
    with NoHostReads():
        if tcfg.window:
            prefill = StepGraph(tg._step_body(tp, tcfg, cache, out, pos),
                                "cpu")
            for _ in range(t0):
                logits = prefill()
        else:
            logits, cache, _ = tg.block_prefill(
                tp, tcfg, cache, torch.from_numpy(prompt))
            pos.fill_(t0)
        out[:, t0] = pick(logits)
        step = StepGraph(tg._step_body(tp, tcfg, cache, out, pos, pick),
                         "cpu")
        for _ in range(steps - 1):
            step()
    assert pos.tolist() == t0 + steps - 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with NoHostReads():
        got = tg.generate(tp, tcfg, torch.from_numpy(prompt), steps=steps)
    assert torch.equal(got, out)


def test_sampled_generate_takes_no_host_reads():
    """The sampled step body, whose top_k = 1 draw is the greedy pick."""
    jp, tp = _params()
    prompt = _tokens(6, (2, 6))
    want = jg.generate(jp, JCFG, jnp.asarray(prompt), steps=10)
    with NoHostReads():
        got = tg.generate(tp, TCFG, torch.from_numpy(prompt), steps=10,
                          temperature=0.8, top_k=1,
                          generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _engines(**kw):
    jp, tp = _params()
    return (js.ServingEngine(jp, JCFG, interpret=True, **kw),
            ts.ServingEngine(tp, TCFG, device="cpu", **kw))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_engine_step_body_matches_reference_steps(k):
    """The engine's step body, run k times by ``step_chunk``, against
    the reference's scanned ``paged_decode_steps`` from the same state:
    rows of 5 and 11 tokens over 8-token blocks (the 11-token row
    crosses a block edge within the chunk) and one idle row."""
    jeng, teng = _engines(n_blocks=24, block_t=8, max_batch=3,
                          max_blocks_per_seq=8)
    for p in [[int(t) for t in _tokens(2, (n,))] for n in (5, 11)]:
        jeng.add(p, 10)
        teng.add(p, 10)
    tokens = np.zeros((3,), np.int32)
    for r in teng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    n_live = teng._live_blocks_bucket(k)
    jtoks, jks, jvs = js.paged_decode_steps(
        jeng.params, JCFG, list(jeng.pool_ks), list(jeng.pool_vs),
        jnp.asarray(jeng.tables), jnp.asarray(jeng.lens),
        jnp.asarray(tokens), n_steps=k, interpret=True,
        n_live_blocks=n_live)
    lens = teng.lens.copy()
    with NoHostReads():
        got = teng.step_chunk(max_steps=k)
    jtoks = np.asarray(jtoks)
    assert got == {0: jtoks[0].tolist(), 1: jtoks[1].tolist()}
    np.testing.assert_array_equal(teng.lens, lens + [k, k, 0])
    assert teng._dev["lens"].tolist() == (lens + k).tolist()
    for li in range(JCFG.n_layers):
        np.testing.assert_allclose(teng.pool_ks[li].numpy()[1:],
                                   np.asarray(jks[li])[1:], **TOL)
        np.testing.assert_allclose(teng.pool_vs[li].numpy()[1:],
                                   np.asarray(jvs[li])[1:], **TOL)


def test_step_graph_runs_the_body_once_per_call_on_the_cpu():
    calls = []
    step = StepGraph(lambda: calls.append(len(calls)) or len(calls), "cpu")
    assert [step() for _ in range(3)] == [1, 2, 3]
    assert step.graph is None and not step.warm


@pytest.mark.parametrize("t0", [17, 30])
def test_engine_admit_body_matches_reference_admission(t0):
    """The engine's admission body for the bucket (32, 2) of 16-token
    blocks, run under :class:`NoHostReads` from its device buffers,
    against the reference's ``_admit_prefill`` at a traced length: the
    pool blocks to the tolerance above, the first token identical."""
    jeng, teng = _engines(n_blocks=8, block_t=16, max_batch=1,
                          max_blocks_per_seq=4)
    prompt = [int(t) for t in _tokens(9, (t0,))]
    blocks = [3, 5]
    toks = np.asarray(prompt + [0] * (32 - t0), np.int32)[None]
    adm = teng._admission(32, 2)
    adm.dev["tokens"].copy_(torch.from_numpy(toks))
    adm.dev["blocks"].copy_(torch.tensor(blocks))
    adm.dev["true_len"].fill_(t0)
    with NoHostReads():
        adm.run()
    jl, jks, jvs = js._admit_prefill(
        jeng.params, jnp.asarray(toks), list(jeng.pool_ks),
        list(jeng.pool_vs), jnp.asarray(blocks, jnp.int32), JCFG, 16,
        true_len=jnp.int32(t0))
    assert int(adm.first) == int(np.argmax(np.asarray(jl)))
    for li in range(JCFG.n_layers):
        np.testing.assert_allclose(teng.pool_ks[li].numpy()[1:],
                                   np.asarray(jks[li])[1:], **TOL)
        np.testing.assert_allclose(teng.pool_vs[li].numpy()[1:],
                                   np.asarray(jvs[li])[1:], **TOL)
