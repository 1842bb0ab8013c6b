"""Port parity for the continuous-batching engine: admission prefill,
decode steps and whole interleaved engine runs, JAX reference (paged
kernel in interpret mode) against the PyTorch port on the CPU, at the
``ServingTraffic`` model configuration in fp32.

Tolerances: logits and pool contents to 1e-4 relative and 1e-5
absolute. Two fp32 forwards through two layers differ by summation
order only (about 1e-7 relative per contraction); the logits are
O(0.1), so 1e-5 absolute leaves two orders of margin while a wrong mask,
position or scale moves them by more than 1e-3. Generated tokens must be
identical. Block 0 (the null block, where inactive rows collide) is
never compared.

The engine admits through one body per prompt bucket, which the card
replays as a CUDA graph and the CPU runs eagerly: it is held bit for
bit to the eager ``_admit_prefill`` and, over whole runs, to
per-request greedy ``generate``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import serving as js
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt

TOL = dict(rtol=1e-4, atol=1e-5)
_FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_seq=256, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jt.init_params(JCFG, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, JCFG.vocab, n)] for n in lens]


def _engines(**kw):
    jp, tp = _params()
    return (js.ServingEngine(jp, JCFG, interpret=True, **kw),
            ts.ServingEngine(tp, TCFG, device="cpu", **kw))


def _assert_pools_match(jeng, teng):
    for li in range(JCFG.n_layers):
        for jpool, tpool in ((jeng.pool_ks[li], teng.pool_ks[li]),
                             (jeng.pool_vs[li], teng.pool_vs[li])):
            np.testing.assert_allclose(tpool.numpy()[1:],
                                       np.asarray(jpool)[1:], **TOL)


@functools.partial(jax.jit, static_argnames=("n_live_blocks",))
def _jax_probe(params, pool_ks, pool_vs, tables, lens, tokens,
               n_live_blocks):
    """One decode step's logits from the reference, without donating
    (or touching) the engine's pools."""
    logits, _, _ = js._decode_core(params, JCFG, pool_ks, pool_vs, tables,
                                   lens, tokens, interpret=True,
                                   n_live_blocks=n_live_blocks)
    return logits


def _probe_logits(jeng, teng):
    """Next-step logits of both engines from their current state. The
    port's step appends into clones of its pools."""
    tokens = np.zeros((len(teng.rows),), np.int32)
    for r in teng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    n_live = teng._live_blocks_bucket(1)
    assert n_live == jeng._live_blocks_bucket(1)
    want = _jax_probe(jeng.params, jeng.pool_ks, jeng.pool_vs,
                      jnp.asarray(jeng.tables), jnp.asarray(jeng.lens),
                      jnp.asarray(tokens), n_live_blocks=n_live)
    got, _, _ = ts.paged_decode_step(
        teng.params, TCFG, [p.clone() for p in teng.pool_ks],
        [p.clone() for p in teng.pool_vs], torch.from_numpy(teng.tables),
        torch.from_numpy(teng.lens), torch.from_numpy(tokens),
        n_live_blocks=n_live)
    active = [r.row for r in teng.rows if r is not None]
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(want)[active], **TOL)


@pytest.mark.parametrize("t0,block_t", [(13, 8), (100, 48)])
def test_admit_prefill_logits_and_pool_blocks(t0, block_t):
    # (13, 8): the 128-slot cache is longer than the 2 bucketed blocks
    # (nothing padded); (100, 48): 4 bucketed blocks outrun it (padded)
    jp, tp = _params()
    prompt = _prompts(1, [t0])[0]
    t_bucket = max(32, 1 << (t0 - 1).bit_length())
    n_prompt = -(-t0 // block_t)
    nb_bucket = 1 << (n_prompt - 1).bit_length()
    blocks = ([5, 3, 8, 2][:n_prompt] + [0] * nb_bucket)[:nb_bucket]
    toks = np.asarray(prompt + [0] * (t_bucket - t0), np.int32)[None]
    shape = (10, 2, block_t, 16)
    jl, jks, jvs = js._admit_prefill(
        jp, jnp.asarray(toks), [jnp.zeros(shape) for _ in range(2)],
        [jnp.zeros(shape) for _ in range(2)],
        jnp.asarray(blocks, jnp.int32), JCFG, block_t,
        true_len=jnp.int32(t0))
    tks = [torch.zeros(shape) for _ in range(2)]
    tvs = [torch.zeros(shape) for _ in range(2)]
    tl, tks, tvs = ts._admit_prefill(
        tp, torch.from_numpy(toks), tks, tvs,
        torch.tensor(blocks, dtype=torch.int32), TCFG, block_t, true_len=t0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for li in range(2):
        np.testing.assert_allclose(tks[li].numpy()[1:],
                                   np.asarray(jks[li])[1:], **TOL)
        np.testing.assert_allclose(tvs[li].numpy()[1:],
                                   np.asarray(jvs[li])[1:], **TOL)
        assert tks[li][blocks[0]].abs().sum() > 0


def test_paged_decode_steps_tokens_and_pools():
    jeng, teng = _engines(n_blocks=24, block_t=8, max_batch=3,
                          max_blocks_per_seq=8)
    for p in _prompts(2, [5, 11]):
        jeng.add(p, 10)
        teng.add(p, 10)
    _probe_logits(jeng, teng)
    tokens = np.zeros((3,), np.int32)
    for r in teng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    jtoks, jks, jvs = js.paged_decode_steps(
        jeng.params, JCFG, list(jeng.pool_ks), list(jeng.pool_vs),
        jnp.asarray(jeng.tables), jnp.asarray(jeng.lens),
        jnp.asarray(tokens), n_steps=4, interpret=True, n_live_blocks=4)
    ttoks, tks, tvs = ts.paged_decode_steps(
        teng.params, TCFG, teng.pool_ks, teng.pool_vs,
        torch.from_numpy(teng.tables), torch.from_numpy(teng.lens),
        torch.from_numpy(tokens), n_steps=4, n_live_blocks=4)
    assert ttoks.dtype == torch.int32 and ttoks.shape == (3, 4)
    np.testing.assert_array_equal(ttoks.numpy()[:2], np.asarray(jtoks)[:2])
    jeng.pool_ks, jeng.pool_vs = jks, jvs
    _assert_pools_match(jeng, teng)


def test_interleaved_engine_lockstep_logits_and_tokens():
    """Six requests through two rows: admissions interleave with decode
    chunks. Before every dispatch both engines' next-step logits are
    compared; the chunk's tokens must be identical."""
    jeng, teng = _engines(n_blocks=12, block_t=8, max_batch=2,
                          max_blocks_per_seq=4)
    pending = _prompts(3, [5, 17, 9, 3, 12, 7])
    n_dispatches = 0
    while pending or any(r is not None for r in teng.rows):
        while pending:
            try:
                rid = jeng.add(pending[0], 6)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    teng.add(pending[0], 6)
                break
            assert teng.add(pending.pop(0), 6) == rid
        np.testing.assert_array_equal(teng.tables, jeng.tables)
        np.testing.assert_array_equal(teng.lens, jeng.lens)
        _probe_logits(jeng, teng)
        assert teng.step_chunk() == jeng.step_chunk()
        n_dispatches += 1
    assert teng.finished == jeng.finished and len(teng.finished) == 6
    assert n_dispatches >= 6
    _assert_pools_match(jeng, teng)


def test_engine_run_matches_reference_engine():
    jeng, teng = _engines(n_blocks=12, block_t=8, max_batch=2,
                          max_blocks_per_seq=4)
    prompts = _prompts(4, [6, 14, 4, 9, 20, 8])
    want = jeng.run(prompts, max_new_tokens=7)
    got = teng.run(prompts, max_new_tokens=7)
    assert got == want
    assert teng.free == jeng.free
    _assert_pools_match(jeng, teng)


def test_engine_rejects_what_the_reference_rejects():
    _, tp = _params()
    for bad in (dict(window=8), dict(prefix=4), dict(kv_int8=True)):
        cfg = tt.ModelConfig(dtype=torch.float32, **{**_FIELDS, **bad})
        with pytest.raises(ValueError):
            ts.ServingEngine(tp, cfg, n_blocks=4, device="cpu")
    eng = ts.ServingEngine(tp, TCFG, n_blocks=4, block_t=8, max_batch=1,
                           max_blocks_per_seq=4, device="cpu")
    with pytest.raises(ValueError):
        eng.add([], 3)
    eng.add([1, 2, 3], 3)
    with pytest.raises(RuntimeError, match="batch full"):
        eng.add([1, 2], 3)
    assert eng.step()                      # validation errors do not poison


def test_failed_decode_poisons_engine(monkeypatch):
    _, tp = _params()
    eng = ts.ServingEngine(tp, TCFG, n_blocks=8, block_t=8, max_batch=2,
                           max_blocks_per_seq=4, device="cpu")
    eng.add([1, 2, 3], 9)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(ts, "_decode_core", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step_chunk()
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.step()
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.add([4, 5], 2)


# admission through the engine's per-bucket body (a StepGraph, which
# the CPU runs eagerly): with 32-token blocks, 5, 17 and 32 tokens share
# the bucket (32, 1) back to back, 33 and 100 take (64, 2) and (128, 4)
ADMIT_LENS = (5, 17, 32, 33, 100)
ADMIT_KW = dict(n_blocks=24, block_t=32, max_batch=5, max_blocks_per_seq=4)


def test_admission_body_equals_the_eager_admit_prefill():
    """Each admission leaves the pools bit-equal to ``_admit_prefill``
    run eagerly from the same pools into the same blocks, and its first
    token is the argmax of that call's logits."""
    _, tp = _params()
    eng = ts.ServingEngine(tp, TCFG, device="cpu", **ADMIT_KW)
    for prompt in _prompts(6, ADMIT_LENS):
        t0 = len(prompt)
        t_bucket = max(32, 1 << (t0 - 1).bit_length())
        n_prompt = -(-t0 // 32)
        nb_bucket = 1 << (n_prompt - 1).bit_length()
        ks = [p.clone() for p in eng.pool_ks]
        vs = [p.clone() for p in eng.pool_vs]
        rid = eng.add(prompt, 4)
        row = next(r.row for r in eng.rows if r is not None and r.rid == rid)
        blocks = list(eng.tables[row, :n_prompt]) + [0] * (nb_bucket -
                                                           n_prompt)
        toks = np.asarray(prompt + [0] * (t_bucket - t0), np.int32)[None]
        logits, ks, vs = ts._admit_prefill(
            tp, torch.from_numpy(toks), ks, vs,
            torch.tensor(blocks, dtype=torch.int32), TCFG, 32, true_len=t0)
        assert eng.rows[row].tokens == [int(torch.argmax(logits))]
        for li in range(TCFG.n_layers):
            assert torch.equal(eng.pool_ks[li], ks[li])
            assert torch.equal(eng.pool_vs[li], vs[li])
    assert sorted(eng._admits) == [(32, 1), (64, 2), (128, 4)]
    assert all(isinstance(a.run, ts.StepGraph)
               for a in eng._admits.values())


def test_engine_run_through_the_admission_body_matches_generate():
    """``run`` admits every prompt through the bucket bodies (rows free
    up and the (32, 1) bucket is reused) and gives per-request greedy
    ``generate``'s tokens."""
    _, tp = _params()
    prompts = _prompts(7, ADMIT_LENS)
    eng = ts.ServingEngine(tp, TCFG, device="cpu",
                           **dict(ADMIT_KW, max_batch=2))
    got = eng.run(prompts, max_new_tokens=6)
    want = [ts.generate(tp, TCFG, torch.tensor([p], dtype=torch.int32),
                        steps=6)[0, len(p):].tolist() for p in prompts]
    assert [got[rid] for rid in sorted(got)] == want


@pytest.mark.parametrize("last", [0, 6, 12])
def test_block_prefill_reads_a_device_last_index_as_the_int(last):
    _, tp = _params()
    tokens = torch.tensor(_prompts(8, [13, 13]), dtype=torch.int32)
    got = {}
    for key, index in (("int", last),
                       ("tensor", torch.tensor(last, dtype=torch.int64))):
        cache = ts.init_kv_cache(TCFG, 2, 13, device="cpu")
        got[key] = ts.block_prefill(tp, TCFG, cache, tokens,
                                    last_index=index)
    assert torch.equal(got["int"][0], got["tensor"][0])
    for which in ("k", "v"):
        for a, b in zip(got["int"][1][which], got["tensor"][1][which]):
            assert torch.equal(a, b)
