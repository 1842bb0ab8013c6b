"""The port's beam search against the reference, on the CPU.

The reference's params (``init_params`` from a PRNG key, quantized by
its ``quantize_params`` where a test says so) are converted with
``convert.params_from_jax``; everything is fp32. The port's decode step
reads the cache through B5's plain version; the reference through its
masked read.

Sequences must be identical. Scores (total log-probabilities of about
-50) to 1e-5 relative: two fp32 paths through two layers and ten
log-softmaxes differ by summation order only, about 1e-7 relative per
contraction, while a wrong parent, cache row or position moves a
sequence's score by whole nats. The re-scoring invariant (each score
equals ``sequence_logprob`` of its sequence) is held to 1e-4 relative
on the port alone, as the reference's test holds it to 1e-3.
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

from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt

jb = importlib.import_module("tpu_dra_driver.workloads.models.beam")
tb = importlib.import_module("tpu_dra_driver_torch.workloads.models.beam")
jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

_FIELDS = dict(vocab=128, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
               d_ff=128, max_seq=64, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)
SCORE_RTOL = 1e-5
RESCORE_RTOL = 1e-4


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
def _jparams(jcfg, seed=0, quantized=False, tied_pairs=False):
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    if tied_pairs:
        # token 2i + 1's embedding row is token 2i's: the tied head gives
        # the pair equal logits, so equal scores meet in the top-k
        embed = jp["embed"]
        jp = dict(jp, embed=embed.at[1::2].set(embed[0::2]))
    return jq.quantize_params(jp) if quantized else jp


def _params(jcfg=JCFG, **kw):
    jp = _jparams(jcfg, **kw)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _prompt(seed=1, b=2, t0=8):
    return np.random.RandomState(seed).randint(
        0, _FIELDS["vocab"], (b, t0)).astype(np.int32)


def _both(jcfg, tcfg, jp, tp, prompt, steps, beam):
    want = jb.beam_search(jp, jcfg, jnp.asarray(prompt), steps, beam,
                          return_all=True)
    got = tb.beam_search(tp, tcfg, torch.from_numpy(prompt), steps, beam,
                         return_all=True)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


# name -> (config changes, params keywords, steps, beam)
CASES = {
    "fp32": ({}, {}, 10, 4),
    "int8_weights": ({}, {"quantized": True}, 8, 3),
    "kv_int8": ({"kv_int8": True}, {}, 6, 2),
    "prefix_lm": ({"prefix": 4}, {}, 8, 3),
    "learned_pos_embed": ({"use_rope": False}, {}, 8, 3),
    "ties": ({}, {"tied_pairs": True}, 8, 4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_return_all_matches_the_reference(name):
    changes, kw, steps, beam = CASES[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params(jcfg, **kw)
    prompt = _prompt()
    (wseqs, wscores), (seqs, scores) = _both(jcfg, tcfg, jp, tp, prompt,
                                             steps, beam)
    assert seqs.shape == (2, beam, prompt.shape[1] + steps)
    assert scores.dtype == np.float32
    np.testing.assert_array_equal(seqs, wseqs)
    np.testing.assert_allclose(scores, wscores, rtol=SCORE_RTOL)


def test_ties_take_the_lower_flat_index():
    """With paired embedding rows every continuation has an equal twin:
    the top-k must keep the lower ``parent * vocab + token`` first, as
    ``lax.top_k`` does, so the first expansion's beams are even tokens
    followed, at equal score, by their odd twins."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tied_pairs=True)
    prompt = _prompt(3)
    seqs, scores = tb.beam_search(tp, tcfg, torch.from_numpy(prompt), 1, 4,
                                  return_all=True)
    first = seqs[:, :, -1].numpy()
    s = scores.numpy()
    assert (first[:, 0::2] % 2 == 0).all()
    np.testing.assert_array_equal(first[:, 1::2], first[:, 0::2] + 1)
    np.testing.assert_array_equal(s[:, 1::2], s[:, 0::2])
    want = jb.beam_search(jp, jcfg, jnp.asarray(prompt), 1, 4,
                          return_all=True)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("name", ["fp32", "int8_weights", "prefix_lm"])
def test_scores_match_teacher_forced_rescoring(name):
    """The invariant that catches cache-reorder bugs: each returned
    score is its sequence's log-probability; and the port's
    ``sequence_logprob`` is the reference's."""
    changes, kw, steps, beam = CASES[name]
    jcfg, tcfg = _cfgs(**changes)
    jp, tp = _params(jcfg, **kw)
    prompt = _prompt()
    seqs, scores = tb.beam_search(tp, tcfg, torch.from_numpy(prompt), steps,
                                  beam, return_all=True)
    for k in range(beam):
        lp = tb.sequence_logprob(tp, tcfg, torch.from_numpy(prompt),
                                 seqs[:, k])
        np.testing.assert_allclose(lp.numpy(), scores[:, k].numpy(),
                                   rtol=RESCORE_RTOL)
        want = jb.sequence_logprob(jp, jcfg, jnp.asarray(prompt),
                                   jnp.asarray(seqs[:, k].numpy()))
        np.testing.assert_allclose(lp.numpy(), np.asarray(want),
                                   rtol=SCORE_RTOL)


def test_beam_one_equals_greedy():
    _, tp = _params()
    prompt = torch.from_numpy(_prompt())
    want = tg.generate(tp, TCFG, prompt, steps=12)
    got = tb.beam_search(tp, TCFG, prompt, steps=12, beam=1)
    assert torch.equal(got, want)


def test_ordering_distinct_beams_and_improvement_over_greedy():
    _, tp = _params(seed=3)
    prompt = torch.from_numpy(_prompt(4))
    seqs, scores = tb.beam_search(tp, TCFG, prompt, steps=10, beam=4,
                                  return_all=True)
    s = scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all(), "beams not sorted best-first"
    greedy = tg.generate(tp, TCFG, prompt, steps=10)
    glp = tb.sequence_logprob(tp, TCFG, prompt, greedy).numpy()
    assert (s[:, 0] >= glp - 1e-4).all(), (s[:, 0], glp)
    for row in seqs.numpy():
        assert len({tuple(r) for r in row}) == seqs.shape[1]
    assert torch.equal(seqs[:, 0], tb.beam_search(tp, TCFG, prompt, 10, 4))


def test_validation_errors():
    _, tp = _params()
    prompt = torch.from_numpy(_prompt())
    with pytest.raises(ValueError, match="beam"):
        tb.beam_search(tp, TCFG, prompt, steps=4, beam=0)
    with pytest.raises(ValueError, match="steps"):
        tb.beam_search(tp, TCFG, prompt, steps=0)
    with pytest.raises(ValueError, match="full-length"):
        tb.beam_search(tp, replace(TCFG, window=8), prompt, steps=4)
    with pytest.raises(ValueError, match="vocab"):
        tb.beam_search(tp, TCFG, prompt, steps=4, beam=1000)


def test_pos_embed_capacity_guard():
    jcfg, tcfg = _cfgs(use_rope=False)
    _, tp = _params(jcfg)
    with pytest.raises(ValueError, match="max_seq"):
        tb.beam_search(tp, tcfg, torch.from_numpy(_prompt()), steps=60,
                       beam=2)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_step_body_reads_nothing_on_the_host(kv_int8):
    """The whole search (prefill, first expansion and the step bodies the
    card replays) under a dispatch mode that raises on any host read,
    giving the same result as outside it."""
    _, tcfg = _cfgs(kv_int8=kv_int8)
    _, tp = _params()
    prompt = torch.from_numpy(_prompt(5))
    with NoHostReads():
        seqs, scores = tb.beam_search(tp, tcfg, prompt, 7, 3,
                                      return_all=True)
    want = tb.beam_search(tp, tcfg, prompt, 7, 3, return_all=True)
    assert torch.equal(seqs, want[0]) and torch.equal(scores, want[1])


def test_step_body_gathers_into_the_other_buffer():
    """One step body: B5's plain version reads ``src`` (with the step's
    new slot written), the parents' rows land in ``dst``, ``src`` keeps
    its rows; position and column advance by one."""
    _, tp = _params()
    b, beam, steps, t0 = 1, 2, 4, 8
    cache = tg.init_kv_cache(TCFG, b * beam, 16, device="cpu")
    prompt = torch.from_numpy(_prompt(6, b=b * beam))
    _, cache, _ = tg.block_prefill(tp, TCFG, cache, prompt)
    dst = {k: [torch.full_like(a, 7) for a in v] for k, v in cache.items()}
    before = {k: [a.clone() for a in v] for k, v in cache.items()}
    pos = torch.full((), t0, dtype=torch.int32)
    col = torch.ones((), dtype=torch.int64)
    last = torch.tensor([3, 5])
    scores = torch.tensor([[-1.0, -1.5]])
    toks = torch.zeros((b, beam, steps), dtype=torch.int64)
    tb._step_body(tp, TCFG, cache, dst, pos, col, last, scores, toks)()
    assert pos.item() == t0 + 1 and col.item() == 2
    assert toks[:, :, 1].ne(0).any() and (scores < -1.0).all()
    for key in cache:
        for a, a0, d in zip(cache[key], before[key], dst[key]):
            # src changed only at the step's slot
            assert torch.equal(a[:, :, :t0], a0[:, :, :t0])
            assert not torch.equal(a[:, :, t0], a0[:, :, t0])
            assert not (d == 7).any()
