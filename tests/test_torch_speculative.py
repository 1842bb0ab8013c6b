"""The port's speculative decoding against the reference, on the CPU.

The reference's params (``init_params`` from PRNG keys) are converted
with ``convert.params_from_jax``; the models are fp32 unless a test
says otherwise. The port's draft steps read the cache through B5's
plain version, its g-wide verify through the masked read, as the
reference's.

Greedy speculation is held exactly: its tokens equal the target's
greedy ``generate`` and the reference's ``speculative_generate``, and
its ``rounds`` and ``mean_accepted`` equal the reference's. Sampling
draws from other random streams than the reference's, so
``speculative_sample`` is held by its law: with a mismatched draft the
second token's conditional distribution given the first is the target's
tempered (and top-k truncated) softmax by a chi-square test at p = 1e-3
over about 4096 draws from fixed generator seeds; at T = 1e-4 it is the
greedy output; a draft equal to the target accepts every proposal.
"""

import functools
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt

jsp = importlib.import_module("tpu_dra_driver.workloads.models.speculative")
tsp = importlib.import_module(
    "tpu_dra_driver_torch.workloads.models.speculative")
jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
tg = importlib.import_module("tpu_dra_driver_torch.workloads.models.generate")

TARGET = dict(vocab=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=256, max_seq=128, use_rope=True)
DRAFT = dict(vocab=256, d_model=64, n_heads=2, n_layers=1, d_ff=128,
             max_seq=128, use_rope=True)
# a prompt whose random draft is mostly rejected (on most prompts the tied
# head at random init repeats the last token in both models, and the
# draft is accepted throughout)
PROMPT_SEED = 6
CHI2_P = 1e-3


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


@pytest.fixture
def rounds_without_host_reads(monkeypatch):
    """Runs every round's StepGraph call (the body the card replays)
    under :class:`NoHostReads`; the loop's read of the counters between
    rounds stays outside it. Counts the rounds run."""
    calls = []

    class Guarded(tsp.StepGraph):
        def __call__(self):
            calls.append(1)
            with NoHostReads():
                return super().__call__()

    monkeypatch.setattr(tsp, "StepGraph", Guarded)
    return calls


def _cfgs(fields, **kw):
    fields = {**fields, **kw}
    return (jt.ModelConfig(dtype=jnp.float32, **fields),
            tt.ModelConfig(dtype=torch.float32, **fields))


@functools.lru_cache(maxsize=None)
def _jparams(jcfg, seed, quantized=False):
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return jq.quantize_params(jp) if quantized else jp


def _params(jcfg, seed, quantized=False):
    jp = _jparams(jcfg, seed, quantized)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _prompt(seed=PROMPT_SEED, b=2, t=8, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


_jspec = jax.jit(jsp._spec_generate,
                 static_argnames=("target_cfg", "draft_cfg", "steps",
                                  "gamma"))


def _jax_spec(jtp, jtc, jdp, jdc, prompt, steps, gamma):
    out, rounds, acc = _jspec(jtp, jdp, jnp.asarray(prompt), target_cfg=jtc,
                              draft_cfg=jdc, steps=steps, gamma=gamma)
    return np.asarray(out), {"rounds": int(rounds),
                             "mean_accepted": float(acc) / max(int(rounds), 1)}


@pytest.mark.parametrize("gamma", [1, 2, 3, 5])
def test_matches_target_greedy_and_the_reference_any_draft(
        gamma, rounds_without_host_reads):
    jtc, ttc = _cfgs(TARGET)
    jdc, tdc = _cfgs(DRAFT)
    jtp, ttp = _params(jtc, 0)
    jdp, tdp = _params(jdc, 9)
    prompt = _prompt()
    want, want_stats = _jax_spec(jtp, jtc, jdp, jdc, prompt, 17, gamma)
    got, stats = tsp.speculative_generate(ttp, ttc, tdp, tdc,
                                          torch.from_numpy(prompt), 17,
                                          gamma, return_stats=True)
    greedy = tg.generate(ttp, ttc, torch.from_numpy(prompt), 17)
    assert torch.equal(got, greedy)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == want_stats
    assert len(rounds_without_host_reads) == stats["rounds"]
    # the rejection path ran: not every proposal was accepted
    assert stats["mean_accepted"] < gamma


def test_identical_draft_accepts_everything():
    _, ttc = _cfgs(TARGET)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    prompt = torch.from_numpy(_prompt(1, b=1))
    out, stats = tsp.speculative_generate(ttp, ttc, ttp, ttc, prompt, 16,
                                          gamma=4, return_stats=True)
    assert torch.equal(out, tg.generate(ttp, ttc, prompt, 16))
    assert stats["mean_accepted"] == pytest.approx(4.0)
    assert stats["rounds"] <= 4


@pytest.fixture
def loops_made(monkeypatch):
    """Starts with no kept loop; counts the round graphs made."""
    made = []

    class Counted(tsp.StepGraph):
        def __init__(self, *args, **kwargs):
            made.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(tsp, "StepGraph", Counted)
    monkeypatch.setattr(tsp, "_last_loop", None)
    return made


def test_the_last_loop_is_replayed_only_by_calls_it_fits(loops_made):
    _, ttc = _cfgs(TARGET)
    _, tdc = _cfgs(DRAFT)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    _, tdp = _params(_cfgs(DRAFT)[0], 9)

    def check(tp, prompt_seed, steps=17, gamma=3):
        prompt = torch.from_numpy(_prompt(prompt_seed))
        got = tsp.speculative_generate(tp, ttc, tdp, tdc, prompt, steps,
                                       gamma)
        assert torch.equal(got, tg.generate(tp, ttc, prompt, steps))

    # other prompts of one shape: one loop, its caches and state reset
    for seed in (PROMPT_SEED, 2, 3, PROMPT_SEED):
        check(ttp, seed)
    assert len(loops_made) == 1
    # another gamma, another length, a weight tensor swapped: new loops
    check(ttp, 2, gamma=2)
    check(ttp, 2, steps=15, gamma=2)
    swapped = {**ttp, "final_norm": {"g": ttp["final_norm"]["g"] * 1.5}}
    check(swapped, 2, steps=15, gamma=2)
    assert len(loops_made) == 4
    check(swapped, 3, steps=15, gamma=2)
    assert len(loops_made) == 4


def test_sampling_replays_equal_fresh_loops(loops_made):
    """Two calls on one generator draw the same tokens whether the second
    replays the first's loop or builds its own."""
    _, ttc = _cfgs(TARGET)
    _, tdc = _cfgs(DRAFT)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    _, tdp = _params(_cfgs(DRAFT)[0], 9)
    prompt = torch.from_numpy(_prompt())
    runs = []
    for fresh in (False, True):
        gen = torch.Generator().manual_seed(4)
        outs = []
        for _ in range(2):
            if fresh:
                tsp._last_loop = None
            outs.append(tsp.speculative_sample(ttp, ttc, tdp, tdc, prompt,
                                               12, gen, gamma=3))
        runs.append(outs)
    assert len(loops_made) == 3
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0], runs[0][1])


def test_self_speculative_int8_draft():
    jtc, ttc = _cfgs(TARGET)
    jtp, ttp = _params(jtc, 0)
    prompt = _prompt(2)
    out, stats = tsp.self_speculative_generate(
        ttp, ttc, torch.from_numpy(prompt), 12, gamma=3, return_stats=True)
    assert torch.equal(out, tg.generate(ttp, ttc, torch.from_numpy(prompt),
                                        12))
    assert stats["mean_accepted"] >= 1.0, stats
    # the same draft on both sides: the reference's quantization, carried
    want, want_stats = _jax_spec(jtp, jtc, jq.quantize_params(jtp), jtc,
                                 prompt, 12, 3)
    _, tq = _params(jtc, 0, quantized=True)
    got, got_stats = tsp.speculative_generate(
        ttp, ttc, tq, ttc, torch.from_numpy(prompt), 12, 3,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_stats == want_stats


def test_learned_pos_embed_model_and_capacity_guard():
    fields = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                  max_seq=64)
    jc, tc = _cfgs(fields)
    jp, tp = _params(jc, 0)
    prompt = _prompt(1, vocab=128)
    got, stats = tsp.speculative_generate(tp, tc, tp, tc,
                                          torch.from_numpy(prompt), 10, 2,
                                          return_stats=True)
    assert torch.equal(got, tg.generate(tp, tc, torch.from_numpy(prompt),
                                        10))
    want, want_stats = _jax_spec(jp, jc, jp, jc, prompt, 10, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == want_stats
    with pytest.raises(ValueError, match="max_seq"):
        tsp.speculative_generate(tp, tc, tp, tc, torch.from_numpy(prompt),
                                 60, 2)


def test_prefix_lm_matches_generate_and_the_reference():
    fields = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                  max_seq=64, use_rope=True, prefix=8)
    jc, tc = _cfgs(fields)
    jp, tp = _params(jc, 0)
    prompt = _prompt(1, vocab=128)
    got = tsp.speculative_generate(tp, tc, tp, tc, torch.from_numpy(prompt),
                                   10, 3)
    assert torch.equal(got, tg.generate(tp, tc, torch.from_numpy(prompt),
                                        10))
    want, _ = _jax_spec(jp, jc, jp, jc, prompt, 10, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_cache_and_config_refusals():
    _, ttc = _cfgs(TARGET)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    prompt = torch.from_numpy(_prompt())
    wcfg = replace(ttc, window=16)
    with pytest.raises(ValueError, match="window"):
        tg.wide_step(ttp, wcfg, tg.init_kv_cache(wcfg, 2, 64, device="cpu"),
                     0, prompt[:, :4])
    with pytest.raises(ValueError, match="window"):
        tsp.speculative_generate(ttp, ttc, ttp, wcfg, prompt, steps=4)
    _, vcfg = _cfgs(DRAFT, vocab=128)
    _, vparams = _params(_cfgs(DRAFT, vocab=128)[0], 1)
    with pytest.raises(ValueError, match="vocab"):
        tsp.speculative_generate(ttp, ttc, vparams, vcfg, prompt, steps=4)
    with pytest.raises(ValueError, match="gamma"):
        tsp.speculative_generate(ttp, ttc, ttp, ttc, prompt, steps=4,
                                 gamma=0)
    out, stats = tsp.speculative_generate(ttp, ttc, ttp, ttc, prompt, 0,
                                          return_stats=True)
    assert out is prompt and stats == {"rounds": 0, "mean_accepted": 0.0}


@pytest.mark.parametrize("n_layers", [1, 2])
def test_early_exit_draft_output_is_exactly_target_greedy(n_layers):
    fields = dict(vocab=128, d_model=64, n_heads=4, n_layers=4, d_ff=128,
                  max_seq=64)
    jc, tc = _cfgs(fields)
    jp, tp = _params(jc, 0)
    prompt = _prompt(1, vocab=128)
    draft, dcfg = tsp.early_exit_draft(tp, tc, n_layers, quantized=False)
    assert dcfg.n_layers == n_layers and len(draft["layers"]) == n_layers
    assert draft["layers"][0] is tp["layers"][0]
    out, stats = tsp.speculative_generate(tp, tc, draft, dcfg,
                                          torch.from_numpy(prompt), 12, 3,
                                          return_stats=True)
    assert torch.equal(out, tg.generate(tp, tc, torch.from_numpy(prompt),
                                        12))
    jdraft, jdcfg = jsp.early_exit_draft(jp, jc, n_layers, quantized=False)
    want, want_stats = _jax_spec(jp, jc, jdraft, jdcfg, prompt, 12, 3)
    np.testing.assert_array_equal(out.numpy(), want)
    assert stats == want_stats
    qdraft, _ = tsp.early_exit_draft(tp, tc, n_layers)
    assert type(qdraft["layers"][0]["wqkv"]).__name__ == "QTensor"


def test_early_exit_draft_validation():
    _, tc = _cfgs(dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                       max_seq=32))
    tp = tt.init_params(tc, 0, device="cpu")
    for bad in (0, 3):
        with pytest.raises(ValueError, match="n_layers"):
            tsp.early_exit_draft(tp, tc, bad)
    with pytest.raises(ValueError, match="scan_layers"):
        tsp.early_exit_draft(tt.stack_layer_params(tp),
                             replace(tc, scan_layers=True), 1)


def _tie_policy_setup(monkeypatch, gap: float):
    """A single-token divergence forced at position 8 of row 0, with the
    target's top-2 logit gap there set to ``gap``: the near-tie rule of
    ``_measure_early_exit`` must tolerate and report a gap within
    0.1 + 0.01 |top1| and raise beyond it."""
    fields = dict(vocab=64, d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
                  d_ff=64, max_seq=20, use_rope=True)
    _, cfg = _cfgs(fields)
    params = tt.init_params(cfg, 0, device="cpu")
    prompt = torch.zeros((1, 8), dtype=torch.int32)
    plain_tok = int(tg.generate(params, cfg, prompt, steps=1)[0, 8])
    real_spec = tsp.speculative_generate

    def tampered(tp, tc, dp, dc, pr, steps, gamma=4, return_stats=False):
        toks, stats = real_spec(tp, tc, dp, dc, pr, steps, gamma,
                                return_stats=True)
        toks = toks.clone()
        toks[0, 8] = (plain_tok + 1) % tc.vocab        # the runner-up
        return (toks, stats) if return_stats else toks

    def fake_forward(p, tokens, c, *args, **kw):
        logits = torch.full((1, tokens.shape[1], c.vocab), -30.0)
        logits[0, -1, plain_tok] = 5.0
        logits[0, -1, (plain_tok + 1) % c.vocab] = 5.0 - gap
        return logits

    monkeypatch.setattr(tsp, "speculative_generate", tampered)
    monkeypatch.setattr(tt, "forward", fake_forward)
    return params, cfg, prompt


def test_tie_divergence_within_tolerance_is_reported(monkeypatch):
    params, cfg, prompt = _tie_policy_setup(monkeypatch, gap=0.01)
    r = tsp._measure_early_exit(params, cfg, prompt, draft_layers=1,
                                gen=8, gamma=2, iters=1)
    assert r["exact_greedy"] is False
    assert r["divergence"] == [
        {"row": 0, "pos": 8, "top2_gap": pytest.approx(0.01, abs=1e-3)}]


def test_non_tie_divergence_raises(monkeypatch):
    params, cfg, prompt = _tie_policy_setup(monkeypatch, gap=3.0)
    with pytest.raises(RuntimeError, match="NOT a bf16 near-tie"):
        tsp._measure_early_exit(params, cfg, prompt, draft_layers=1,
                                gen=8, gamma=2, iters=1)


def test_benches_run():
    _, cfg = _cfgs(dict(vocab=128, d_model=64, n_heads=2, n_kv_heads=1,
                        n_layers=2, d_ff=128, max_seq=64, use_rope=True))
    out = tsp.speculative_decode_tokens_per_sec(
        b=2, prompt_len=8, gen=12, gamma=2, iters=1, cfg=cfg, device="cpu")
    assert out["spec_tokens_per_sec"] > 0 and out["plain_tokens_per_sec"] > 0
    assert 0.0 <= out["mean_accepted"] <= 2.0
    _, cfg = _cfgs(dict(vocab=256, d_model=64, n_heads=2, n_kv_heads=2,
                        n_layers=2, d_ff=128, max_seq=16 + 16 + 3 + 2,
                        use_rope=True))
    r = tsp.early_exit_decode_tokens_per_sec(
        b=1, prompt_len=16, gen=16, gamma=3, draft_layers=1,
        train_steps=10, iters=1, cfg=cfg, device="cpu")
    assert r["exact_greedy"] in (True, False)
    assert r["train_steps"] == 10 and r["spec_tokens_per_sec"] > 0
    assert np.isfinite(r["final_train_loss"])


def test_bigram_chain_law():
    """The early-exit bench's training chains: 0.9 the fixed successor,
    0.1 a uniform token."""
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    chains = tsp._bigram_chains(perm, 64, 257,
                                torch.Generator().manual_seed(1)).long()
    succ = (chains[:, 1:] == perm[chains[:, :-1]]).float().mean().item()
    # P(successor) = 0.9 + 0.1 / 64; 16384 pairs: sd 0.0023
    assert abs(succ - (0.9 + 0.1 / 64)) < 0.01
    assert chains.dtype == torch.int64 and chains.min() >= 0


# ------------------------------------------------------ speculative_sample

SAMPLE_T = dict(vocab=8, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq=32, use_rope=True)
SAMPLE_D = dict(vocab=8, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                max_seq=32, use_rope=True)


def _sample_pairs(temperature, top_k, seed0):
    """The first two generated tokens of 8 x 512 rows after one prompt,
    the draft mismatched; and the target's params and config."""
    _, tcfg = _cfgs(SAMPLE_T)
    _, dcfg = _cfgs(SAMPLE_D)
    _, tp = _params(_cfgs(SAMPLE_T)[0], 0)
    _, dp = _params(_cfgs(SAMPLE_D)[0], 99)
    prompt = torch.tensor([[1, 5, 2, 7]], dtype=torch.int32).repeat(512, 1)
    pairs = []
    for r in range(8):
        gen = torch.Generator().manual_seed(seed0 + r)
        out = tsp.speculative_sample(tp, tcfg, dp, dcfg, prompt, 2, gen,
                                     gamma=3, temperature=temperature,
                                     top_k=top_k)
        pairs.append(out[:, 4:6])
    return torch.cat(pairs).numpy(), tp, tcfg


def _target_law(tp, tcfg, x1, temperature, top_k):
    ctx = torch.tensor([[1, 5, 2, 7, x1]], dtype=torch.int32)
    with torch.no_grad():
        logits = tt.forward(tp, ctx, tcfg)[0, -1].double()
    if top_k:
        kth = torch.sort(logits).values[-top_k]
        logits = torch.where(logits >= kth, logits,
                             torch.tensor(-np.inf, dtype=torch.float64))
    return torch.softmax(logits / temperature, -1).numpy()


@pytest.mark.parametrize("top_k", [0, 3])
def test_sample_law_matches_target_sampling(top_k):
    """With a mismatched draft (the residual path runs all the time) the
    second token's law given the first is the target's tempered softmax
    (top-k truncated): tokens outside it never appear, and the counts
    pass a chi-square test against it."""
    temperature = 1.3 if top_k == 0 else 1.1
    pairs, tp, tcfg = _sample_pairs(temperature, top_k, 1000 + 7 * top_k)
    tested = 0
    for x1 in range(SAMPLE_T["vocab"]):
        sel = pairs[pairs[:, 0] == x1]
        if len(sel) < 300:
            continue
        want = _target_law(tp, tcfg, x1, temperature, top_k)
        counts = np.bincount(sel[:, 1], minlength=SAMPLE_T["vocab"])
        assert (counts[want == 0] == 0).all(), (x1, counts, want)
        live = want > 0
        expected = want[live] * len(sel)
        stat = ((counts[live] - expected) ** 2 / expected).sum()
        crit = scipy.stats.chi2.ppf(1 - CHI2_P, live.sum() - 1)
        assert stat < crit, (x1, len(sel), counts, want)
        tested += 1
    assert tested >= 2


def test_sample_low_temperature_is_greedy():
    _, ttc = _cfgs(TARGET)
    _, tdc = _cfgs(DRAFT)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    _, tdp = _params(_cfgs(DRAFT)[0], 9)
    prompt = torch.from_numpy(_prompt(2))
    want = tsp.speculative_generate(ttp, ttc, tdp, tdc, prompt, 12, gamma=3)
    got = tsp.speculative_sample(ttp, ttc, tdp, tdc, prompt, 12,
                                 torch.Generator().manual_seed(3), gamma=3,
                                 temperature=1e-4)
    assert torch.equal(got, want)


def test_sample_identical_draft_accepts_all(rounds_without_host_reads):
    _, ttc = _cfgs(TARGET)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    prompt = torch.from_numpy(_prompt(1))
    gen = torch.Generator().manual_seed(5)
    out, stats = tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 16, gen,
                                        gamma=4, return_stats=True)
    assert out.shape == (2, prompt.shape[1] + 16)
    assert stats["mean_accepted"] == pytest.approx(4.0)
    assert len(rounds_without_host_reads) == stats["rounds"]
    # one seed repeats its draws
    again = tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 16,
                                   torch.Generator().manual_seed(5), gamma=4)
    assert torch.equal(out, again)


def test_sample_validation():
    _, ttc = _cfgs(TARGET)
    _, ttp = _params(_cfgs(TARGET)[0], 0)
    prompt = torch.from_numpy(_prompt())
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="temperature"):
        tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 4, gen,
                               temperature=0.0)
    with pytest.raises(ValueError, match="gamma"):
        tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 4, gen, gamma=0)
    for bad in (-1, ttc.vocab + 1):
        with pytest.raises(ValueError, match="top_k"):
            tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 4, gen,
                                   top_k=bad)
    with pytest.raises(ValueError, match="Generator"):
        tsp.speculative_sample(ttp, ttc, ttp, ttc, prompt, 4, None)


# the real-data bench's training, port against reference on the same
# packed batches, in fp32 through AdamW steps: summation order only
TOL_REAL_DATA_LOSS_REL = 1e-5
REAL_DATA = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=3,
                 d_ff=128, max_seq=16 + 12 + 4 + 2, use_rope=True)
REAL_DATA_KEYS = {
    "spec_tokens_per_sec", "plain_tokens_per_sec", "speedup",
    "mean_accepted", "gamma", "draft_cost_ratio",
    "perfect_acceptance_bound", "exact_greedy", "divergence", "shape",
    "per_prompt", "train_steps", "final_train_loss", "corpus_bytes",
    "holdout_docs", "exit_aux"}


def _write_corpus(root, n_files=60):
    """Text files of words from a fixed vocabulary, some shorter than a
    prompt (the bench tiles those)."""
    rng = np.random.RandomState(0)
    words = ("def return class import self value the of and to in for "
             "while if else print list dict").split()
    for i in range(n_files):
        n = int(rng.randint(2, 80))
        (root / f"m{i:03d}.py").write_text(
            " ".join(words[j] for j in rng.randint(0, len(words), n)))
    return str(root)


def test_real_data_bench_trains_as_the_reference_and_measures(
        tmp_path, monkeypatch):
    """At a tiny config on a corpus the test writes, with the reference's
    initial params: the port's training losses equal the reference's
    ``make_train_step(adamw(3e-4), exit_layer=draft_layers)`` on the same
    packed batches, the step count is a multiple of 10, and the result
    carries the reference's keys."""
    import itertools

    import optax

    from tpu_dra_driver.workloads import data as jd

    root = _write_corpus(tmp_path)
    jcfg, tcfg = _cfgs(REAL_DATA)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(tsp, "init_params", lambda cfg, key, device="cuda":
                        convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                                device=device))
    losses, prompts = [], []
    real_step, real_measure = tsp.make_train_step, tsp._measure_early_exit

    def recording_step(*args, **kwargs):
        step, init = real_step(*args, **kwargs)

        def step_and_record(params, opt, batch):
            out = step(params, opt, batch)
            losses.append(out[2].item())
            return out
        return step_and_record, init

    def recording_measure(params, cfg, prompt, **kwargs):
        prompts.append(prompt.numpy())
        return real_measure(params, cfg, prompt, **kwargs)

    monkeypatch.setattr(tsp, "make_train_step", recording_step)
    monkeypatch.setattr(tsp, "_measure_early_exit", recording_measure)
    out = tsp.early_exit_real_data_tokens_per_sec(
        b=1, prompt_len=16, gen=12, gamma=4, draft_layers=1, train_steps=15,
        train_batch=4, train_seq=32, iters=1, cfg=tcfg, corpus_roots=[root],
        n_prompts=3, device="cpu")

    assert out["train_steps"] == len(losses) == 20
    assert out["train_steps"] % 10 == 0
    assert out["final_train_loss"] == losses[-1]
    assert set(out) == REAL_DATA_KEYS
    train_docs, holdout = jd.byte_corpus(roots=[root])
    assert out["corpus_bytes"] == sum(len(d) for d in train_docs)
    assert out["holdout_docs"] == len(holdout)
    assert len(out["per_prompt"]) == 3 and out["exit_aux"] is True
    assert out["shape"].endswith(" byte-LM")
    # fp32: the speculative output is the target's greedy decode exactly
    assert out["exact_greedy"] and out["divergence"] is None
    # every prompt is the start of a held-out document (tiled if short)
    for p in prompts:
        assert p.shape == (1, 16)
        assert any(np.array_equal(p[0], np.tile(d, -(-16 // len(d)))[:16])
                   for d in holdout)

    jstep, jinit = jt.make_train_step(jcfg, optimizer=optax.adamw(3e-4),
                                      exit_layer=1)
    jstep = jax.jit(jstep)
    jopt = jinit(jp)
    want = []
    for toks, tgts in itertools.islice(
            jd.packed_lm_batches(itertools.cycle(train_docs), 4, 32), 20):
        jp, jopt, loss = jstep(jp, jopt, (jnp.asarray(toks),
                                          jnp.asarray(tgts)))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=TOL_REAL_DATA_LOSS_REL)


def test_real_data_bench_refuses_a_vocab_below_bytes():
    _, tcfg = _cfgs(REAL_DATA, vocab=128)
    with pytest.raises(ValueError, match="vocab >= 256"):
        tsp.early_exit_real_data_tokens_per_sec(cfg=tcfg, device="cpu")
