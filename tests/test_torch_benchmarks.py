"""The port's single-device benchmarks against the reference, on the CPU:
the four flash-attention benchmarks (``ops/attention.py``) and the
matrix-product ones with the card's peak (``ops/collectives.py``).

Both sides' timing is replaced by one fixed number of seconds (the port's
fake also runs the chain once, at a tiny shape, so every path executes),
so each result's keys and ``shape`` string are held to the reference's,
and its FLOP accounting by ``tflops * seconds``. The band count of the
long-context benchmarks is held against a brute-force count of the pairs
``attention_reference`` lets through its window mask.
"""

import math

import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver.workloads.ops import collectives as jc
from tpu_dra_driver.workloads.utils import timing as jtiming
from tpu_dra_driver_torch.workloads import ops as tops
from tpu_dra_driver_torch.workloads.ops import attention as ta
from tpu_dra_driver_torch.workloads.ops import collectives as tc
from tpu_dra_driver_torch.workloads.utils import timing as ttiming

SECONDS = 0.125          # the fixed per-step (or per-call) time of both
TINY = dict(b=1, h=2, t=128, d=32)
TINY_LONG = dict(b=1, h=2, t=256, d=32, window=64)


@pytest.fixture
def fixed_time(monkeypatch):
    """Both packages' timers return SECONDS; the port's run each chain
    once at its long length (the reference's, which would compile Pallas
    in interpret mode, run nothing). Returns the port's chain runs."""
    ran = []

    def port_chain(make_run, chain_short, chain_long, iters=3):
        ran.append(make_run(chain_long)())
        return SECONDS

    def port_runs(make_run, chain_short, chain_long, iters=3, n_runs=1):
        port_chain(make_run, chain_short, chain_long, iters)
        return [SECONDS * (1 + i / 8) for i in range(n_runs)]

    def port_time_fn(fn, warmup=2, iters=5):
        ran.append(fn())
        return ttiming.Timed(SECONDS, SECONDS, [SECONDS])

    monkeypatch.setattr(ta, "chain_seconds_per_step", port_chain)
    monkeypatch.setattr(ta, "chain_seconds_per_step_runs", port_runs)
    monkeypatch.setattr(tc, "chain_seconds_per_step", port_chain)
    monkeypatch.setattr(tc, "time_fn", port_time_fn)
    monkeypatch.setattr(jtiming, "chain_seconds_per_step",
                        lambda *a, **k: SECONDS)
    monkeypatch.setattr(
        jtiming, "chain_seconds_per_step_runs",
        lambda make_run, short, long, iters=3, n_runs=1: [
            SECONDS * (1 + i / 8) for i in range(n_runs)])
    monkeypatch.setattr(jc, "time_fn", lambda *a, **k: jtiming.Timed(
        SECONDS, SECONDS, [SECONDS]))
    return ran


def _band(t, w):
    return w * (w + 1) // 2 + (t - w) * w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_tflops_keys_shape_and_flops(fixed_time, dtype):
    jdtype = {torch.float32: np.float32,
              torch.bfloat16: ja.jnp.bfloat16}[dtype]
    got = ta.flash_attention_tflops(**TINY, dtype=dtype, device="cpu")
    want = ja.flash_attention_tflops(**TINY, dtype=jdtype)
    assert set(got) == set(want) | {"library_attn_tflops"}
    assert got["shape"] == want["shape"] == \
        f"b1 h2 t128 d32 {str(dtype).split('.')[-1]}"
    flops = 4 * 1 * 2 * 128 * 128 * 32 / 2
    for key in ("flash_attn_tflops", "ref_attn_tflops",
                "library_attn_tflops"):
        assert got[key] * SECONDS * 1e12 == pytest.approx(flops, rel=1e-12)
    assert got["flash_attn_tflops"] == pytest.approx(
        want["flash_attn_tflops"], rel=1e-12)
    assert got["speedup_vs_ref"] == want["speedup_vs_ref"] == 1.0
    # flash, the oracle and SDPA each ran their chain, finite
    assert len(fixed_time) == 3
    assert all(torch.isfinite(x.float()).all() for x in fixed_time)


def test_flash_attention_tflops_skips_the_oracle_past_four_gib(fixed_time,
                                                              monkeypatch):
    """The oracle is timed only while b h t² 4 bytes < 4 GiB; the shape
    is tiny, so the limit is checked on the reference's formula."""
    b, h, t = 1, 2, 128
    assert b * h * t * t * 4 < 4 << 30
    b_big = (4 << 30) // (h * t * t * 4)
    assert b_big * h * t * t * 4 >= 4 << 30
    monkeypatch.setattr(ta, "_bench_inputs", lambda *a: (
        torch.zeros(1, 1, 128, 16),) * 3)
    got = ta.flash_attention_tflops(b=b_big, h=h, t=t, d=16,
                                    dtype=torch.float32, device="cpu")
    assert "ref_attn_tflops" not in got and "speedup_vs_ref" not in got


def test_flash_attention_train_tflops_keys_shape_and_flops(fixed_time):
    got = ta.flash_attention_train_tflops(**TINY, dtype=torch.float32,
                                          device="cpu")
    want = ja.flash_attention_train_tflops(**TINY, dtype=np.float32)
    assert set(got) == set(want)
    assert got["shape"] == want["shape"]
    flops = 3.5 * 4 * 1 * 2 * 128 * 128 * 32 / 2
    assert got["flash_attn_train_tflops"] * SECONDS * 1e12 == \
        pytest.approx(flops, rel=1e-12)
    assert got["flash_attn_train_tflops"] == pytest.approx(
        want["flash_attn_train_tflops"], rel=1e-12)
    q, k, v = fixed_time[0]
    assert q.shape == (1, 2, 128, 32) and k.shape == v.shape == q.shape


@pytest.mark.parametrize("n_runs", [1, 3])
def test_long_context_benchmarks_keys_shape_and_flops(fixed_time, n_runs):
    t, w = TINY_LONG["t"], TINY_LONG["window"]
    pairs = _band(t, w)
    cases = (
        (ta.flash_attention_long_context_tflops,
         ja.flash_attention_long_context_tflops,
         "flash_attn_long_ctx_tflops", "long_ctx_step_ms", 4),
        (ta.flash_attention_long_context_train_tflops,
         ja.flash_attention_long_context_train_tflops,
         "flash_attn_long_ctx_train_tflops", "long_ctx_train_step_ms", 14),
    )
    for port, ref, key, ms_key, flops_per_pair_d in cases:
        got = port(**TINY_LONG, dtype=torch.float32, n_runs=n_runs,
                   device="cpu")
        want = ref(**TINY_LONG, dtype=np.float32, n_runs=n_runs)
        assert set(got) == set(want)
        assert got["shape"] == want["shape"] == "b1 h2 t256 w64 d32 float32"
        flops = flops_per_pair_d * 1 * 2 * 32 * pairs
        pers = sorted(SECONDS * (1 + i / 8) for i in range(n_runs))
        assert len(got["runs_tflops"]) == n_runs
        for tf, per in zip(got["runs_tflops"], reversed(pers)):
            assert tf * per * 1e12 == pytest.approx(flops, rel=1e-12)
        np.testing.assert_allclose(got["runs_tflops"], want["runs_tflops"],
                                   rtol=1e-12)
        assert got[key] == pytest.approx(want[key], rel=1e-12)
        assert got[ms_key] == pytest.approx(want[ms_key], rel=1e-12)
        assert got[ms_key] == pytest.approx(pers[len(pers) // 2] * 1e3)
    assert all(torch.isfinite(torch.stack([x.float() for x in
                                           (r if isinstance(r, tuple)
                                            else (r,))])).all()
               for r in fixed_time)


@pytest.mark.parametrize("t,w", [(256, 64), (256, 1), (128, 128),
                                 (200, 37), (512, 200)])
def test_band_count_equals_the_pairs_attention_reference_lets_through(t, w):
    """With q = k = 0 every visible column of a row gets the same
    probability, and v = I reads the probabilities out: the nonzero
    entries are exactly the visible pairs."""
    q = torch.zeros(1, 1, t, t)
    v = torch.eye(t)[None, None]
    probs = ta.attention_reference(q, q, v, causal=True, window=w)
    assert int((probs > 0).sum()) == ta._band_pairs(t, w) == _band(t, w)


def test_benchmarks_run_for_real_on_the_cpu():
    """No fake timer: the marginal-chain rate of each benchmark is a
    positive finite number."""
    kw = dict(dtype=torch.float32, iters=1, device="cpu")
    outs = [
        ta.flash_attention_tflops(**TINY, chain_short=1, chain_long=2, **kw),
        ta.flash_attention_train_tflops(**TINY, chain_short=1, chain_long=2,
                                        **kw),
        ta.flash_attention_long_context_tflops(**TINY_LONG, chain_short=1,
                                               chain_long=2, **kw),
        ta.flash_attention_long_context_train_tflops(
            **TINY_LONG, chain_short=1, chain_long=2, n_runs=2, **kw),
    ]
    for out in outs:
        for key, value in out.items():
            if key != "shape":
                assert all(math.isfinite(x) and x > 0 for x in
                           (value if isinstance(value, list) else [value]))


def test_matmul_benchmarks_keys_str_and_flops(fixed_time):
    m = 64
    got = tc.matmul_tflops(m=m, dtype=torch.float32, chain=4, device="cpu")
    want = jc.matmul_tflops(m=m, dtype=np.float32, chain=4)
    assert got.__dataclass_fields__.keys() == want.__dataclass_fields__.keys()
    assert str(got) == str(want)
    assert got.tflops * SECONDS * 1e12 == pytest.approx(2 * m ** 3 * 4)
    steady = tc.matmul_tflops_steady(m=m, dtype=torch.float32, device="cpu")
    want_steady = jc.matmul_tflops_steady(m=m, dtype=np.float32)
    assert str(steady) == str(want_steady)
    assert steady.median_s == SECONDS
    assert steady.tflops * SECONDS * 1e12 == pytest.approx(2 * m ** 3)
    # the chains ran: 4 products, then 64 (the steady chain's long one);
    # b is a / sqrt(m), so the chain keeps its scale
    assert [tuple(x.shape) for x in fixed_time] == [(m, m)] * 2
    assert all(torch.isfinite(x).all() and x.abs().max() < 1e3
               for x in fixed_time)
    assert set(tops.__dict__) >= {"matmul_tflops", "matmul_tflops_steady",
                                  "flash_attention_tflops",
                                  "flash_attention_train_tflops",
                                  "flash_attention_long_context_tflops"}


def test_matmul_operands_are_one_draw():
    """a and b come from one seed: b is a's draws over sqrt(m), as the
    reference draws both from one key."""
    a, b = tc._operands(32, torch.float32, "cpu")
    torch.testing.assert_close(b, a / math.sqrt(32), rtol=1e-6, atol=0)


def test_matmul_runs_for_real_on_the_cpu():
    out = tc.matmul_tflops(m=32, iters=1, chain=2, device="cpu")
    assert out.m == 32 and out.tflops > 0 and out.median_s > 0


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0),
    ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_peak_tflops_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert tc.device_peak_tflops() == peak


def test_device_peak_tflops_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tc.device_peak_tflops() is None
