"""Flash attention of the port against the reference's Pallas kernels.

The same numpy-seeded inputs go through the reference's
``flash_attention_with_lse`` (its Pallas kernels in interpret mode, as
the reference's own tests run them on the CPU, and ``jax.vjp`` through
them) and through the port's, whose wrappers take the plain versions of
the CUDA kernels for CPU tensors. Out, lse, dq, dk and dv are compared
in fp32.

Tolerance: 1e-5 absolute and relative. Both sides compute the same f32
sums over at most 320 columns of O(1) terms in different orders; the
observed gap is below 4e-6, about what the reference's flash kernel
shows against its own oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver_torch.workloads.ops import attention as ta

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCKS = dict(block_q=128, block_kv=128)

# name -> ((b, h, h_kv, t, tkv, d), mask keywords)
CASES = {
    "causal": ((2, 2, 2, 256, 256, 64), {}),
    "gqa_2to1": ((1, 4, 2, 256, 256, 32), {}),
    "gqa_4to1": ((1, 8, 2, 128, 128, 32), {}),
    "window": ((1, 4, 1, 256, 256, 32), dict(window=64)),
    "row_offset": ((1, 2, 1, 128, 256, 32), dict(row_offset=128)),
    "prefix": ((1, 2, 1, 256, 256, 32), dict(prefix=100)),
    "noncausal_tkv_ne_t": ((1, 2, 1, 128, 256, 32), dict(causal=False)),
}


def _inputs(shape, seed):
    b, h, h_kv, t, tkv, d = shape
    rng = np.random.default_rng(seed)

    def randn(*s):
        return rng.standard_normal(s).astype(np.float32)

    return (randn(b, h, t, d), randn(b, h_kv, tkv, d), randn(b, h_kv, tkv, d),
            randn(b, h, t, d), randn(b, h, t))


def _jax_flash(q, k, v, g, g_lse, **kw):
    """(out, lse, dq, dk, dv) from the reference's Pallas kernels."""
    def f(q, k, v):
        return ja.flash_attention_with_lse(q, k, v, interpret=True,
                                           **BLOCKS, **kw)
    (out, lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return tuple(np.asarray(x) for x in (out, lse, *grads))


def _torch_flash(q, k, v, g, g_lse, with_lse=True, **kw):
    """(out, lse, dq, dk, dv) from the port (lse None without it)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    if with_lse:
        out, lse = ta.flash_attention_with_lse(tq, tk, tv, **BLOCKS, **kw)
        total = (out * torch.from_numpy(g)).sum() \
            + (lse * torch.from_numpy(g_lse)).sum()
    else:
        out, lse = ta.flash_attention(tq, tk, tv, **BLOCKS, **kw), None
        total = (out * torch.from_numpy(g)).sum()
    grads = torch.autograd.grad(total, (tq, tk, tv))
    return tuple(None if x is None else x.detach().numpy()
                 for x in (out, lse, *grads))


def _assert_all_close(got, want, names=("out", "lse", "dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_pallas_kernels(name):
    shape, kw = CASES[name]
    q, k, v, g, _ = _inputs(shape, seed=len(name))
    zero_lse = np.zeros(q.shape[:3], np.float32)
    want = _jax_flash(q, k, v, g, zero_lse, **kw)
    got = _torch_flash(q, k, v, g, zero_lse, **kw)
    _assert_all_close(got, want)
    # flash_attention (no lse output) is the same function and gradient
    plain = _torch_flash(q, k, v, g, zero_lse, with_lse=False, **kw)
    assert plain[1] is None
    for a, b in zip(plain[:1] + plain[2:], got[:1] + got[2:]):
        np.testing.assert_array_equal(a, b)


def test_flash_with_lse_nonzero_lse_cotangent():
    """A cotangent on lse enters the backward as D = rowsum(dO*O) - g_lse
    and moves dq and dk (dv does not depend on it)."""
    q, k, v, g, g_lse = _inputs((1, 4, 2, 256, 256, 32), seed=11)
    want = _jax_flash(q, k, v, g, g_lse)
    got = _torch_flash(q, k, v, g, g_lse)
    _assert_all_close(got, want)
    without = _torch_flash(q, k, v, g, np.zeros_like(g_lse))
    assert np.abs(without[2] - got[2]).max() > 1e-2


def test_merge_partials_of_kv_halves_is_whole_attention():
    q, k, v, _, _ = _inputs((1, 4, 2, 128, 256, 32), seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    halves = [ta.flash_attention_with_lse(
        tq, tk[:, :, s], tv[:, :, s], causal=False, **BLOCKS)
        for s in (slice(0, 128), slice(128, 256))]
    out, lse = ta.merge_partials(*halves[0], *halves[1])
    whole, whole_lse = ta.flash_attention_with_lse(tq, tk, tv, causal=False,
                                                   **BLOCKS)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), **TOL)
    want = ja.merge_partials(*(jnp.asarray(x.numpy())
                               for x in (*halves[0], *halves[1])))
    for a, b in zip((out, lse), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_empty_band_rows_follow_the_mathematics():
    """``window=32, row_offset=64, t=tkv=128``: rows 95 and above see no
    column. The oracle here is ``jax.grad(attention_reference)``, not the
    Pallas kernels in interpret mode: the reference's flash backward
    rebuilds P as ``exp2(s - lse * LOG2E)``, and on these rows lse * LOG2E
    rounds to NEG_INF, the very fill of a masked score, so P comes out 1
    instead of 0 and dq, dk and dv go wrong there. Its forward is right,
    so the lse is still held to the Pallas forward's."""
    kw = dict(window=32, row_offset=64)
    q, k, v, g, _ = _inputs((1, 2, 1, 128, 128, 64), seed=3)
    rows = np.arange(128)[:, None] + 64
    cols = np.arange(128)[None, :]
    empty = ~((rows >= cols) & (rows - cols < 32)).any(-1)
    assert empty.sum() == 33 and empty[95:].all()

    def ref_loss(q, k, v):
        return jnp.sum(ja.attention_reference(q, k, v, **kw) * g)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = np.asarray(ja.attention_reference(jq, jk, jv, **kw))
    want_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(jq, jk, jv)
    _, want_lse = ja.flash_attention_with_lse(jq, jk, jv, interpret=True,
                                              **BLOCKS, **kw)
    out, lse, dq, dk, dv = _torch_flash(q, k, v, g, None, with_lse=False,
                                        **kw)
    _, lse = ta.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                         **BLOCKS, **kw)
    _assert_all_close((out, dq, dk, dv), (want_out, *want_grads),
                      names=("out", "dq", "dk", "dv"))
    assert np.all(out[:, :, empty] == 0.0)
    assert np.all(dq[:, :, empty] == 0.0)
    lse = lse.numpy()
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=1e-6, atol=1e-5)
    empty_lse = (ta.NEG_INF + np.log2(np.float32(1e-30))) / ta.LOG2E
    np.testing.assert_allclose(lse[:, :, empty], empty_lse, rtol=1e-6)
    assert np.isfinite(lse).all()
    # the reference's flash backward is the one that is off on these rows
    ref_dq = _jax_flash(q, k, v, g, np.zeros(q.shape[:3], np.float32),
                        **kw)[2]
    assert np.abs(ref_dq[:, :, empty]).max() > 1.0
    # two empty partials merge to a finite zero
    tout = torch.from_numpy(out)
    tl = torch.from_numpy(lse)
    merged, _ = ta.merge_partials(tout, tl, tout, tl)
    assert torch.isfinite(merged).all()
    assert (merged[:, :, torch.from_numpy(empty)] == 0).all()


BAD_ARGS = {
    "causal_tkv_ne_t": ((1, 2, 2, 128, 256, 32), {}),
    "window_noncausal": ((1, 2, 2, 128, 128, 32),
                         dict(causal=False, window=8)),
    "window_zero": ((1, 2, 2, 128, 128, 32), dict(window=0)),
    "row_offset_noncausal": ((1, 2, 2, 128, 256, 32),
                             dict(causal=False, row_offset=4)),
    "prefix_noncausal": ((1, 2, 2, 128, 128, 32),
                         dict(causal=False, prefix=4)),
    "prefix_and_window": ((1, 2, 2, 128, 128, 32), dict(prefix=4, window=8)),
    "heads_not_grouped": ((1, 3, 2, 128, 128, 32), {}),
    "no_block_divisor": ((1, 2, 2, 256, 256, 32), dict(block_q=100)),
}


@pytest.mark.parametrize("name", list(BAD_ARGS))
def test_argument_errors_match_the_reference(name):
    shape, kw = BAD_ARGS[name]
    q, k, v, _, _ = _inputs(shape, seed=0)
    kw = {**BLOCKS, **kw}
    with pytest.raises(ValueError) as want:
        ja.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True, **kw)
    with pytest.raises(ValueError) as got:
        ta.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert str(got.value) == str(want.value)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """On the CPU each wrapper runs its kernel's plain version and counts
    no launch; a tensor on a device other than the CPU goes to the kernel
    path, whose checks refuse a non-CUDA device."""
    q, k, v, g, _ = _inputs((1, 2, 1, 128, 128, 32), seed=2)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    before = (ta.flash_forward.launches, ta.flash_backward_dq.launches,
              ta.flash_backward_dkv.launches)
    out, lse = ta.flash_forward(tq, tk, tv)
    want = ta._flash_forward_plain(tq, tk, tv)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    dd = (tg * out).sum(-1)
    ta.flash_backward_dq(tq, tk, tv, tg, lse, dd)
    ta.flash_backward_dkv(tq, tk, tv, tg, lse, dd)
    assert (ta.flash_forward.launches, ta.flash_backward_dq.launches,
            ta.flash_backward_dkv.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_forward(tq.to("meta"), tk.to("meta"), tv.to("meta"))
