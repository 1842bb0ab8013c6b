"""The port's Adafactor against optax's, on the CPU.

``default_optimizer(kind="adafactor")`` is the reference's chain:
``clip_by_global_norm`` then ``optax.adafactor`` on the warmup-cosine
schedule. optax factors a leaf's second moment only when its two largest
dims are both at least 128, so the tree here holds factored leaves
([128, 256], [256, 128] and a stacked [2, 128, 256]) beside leaves kept
whole (small matrices, a vector, a [4, 300] whose second dim is too
small, an all-zero leaf whose parameter scale is the 1e-3 floor).

Tolerances: the same gradients fed to both sides for five steps leave
params within 1e-5 of each leaf's largest value (f32 arithmetic in
other orders; a wrong decay, clip or scale moves a step by far more).
Through the model's train step, whose gradients differ by summation
order, losses agree to 1e-5 relative and params as in
``test_torch_training``: 3e-5 absolute for all but one element in a
thousand, all within two steps' largest move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt

SHAPES = {"factored": (128, 256), "factored_wide_first": (256, 128),
          "stacked": (2, 128, 256), "small": (16, 32), "vector": (64,),
          "second_dim_small": (4, 300), "zeros": (8,)}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20, kind="adafactor")


def _tree(rng, scale, zeros=False):
    """One array per leaf of SHAPES; with ``zeros``, the "zeros" leaf is
    all zeros (params whose block RMS is below the 1e-3 floor)."""
    return {k: (np.zeros(s, np.float32) if zeros and k == "zeros"
                else (scale * rng.standard_normal(s)).astype(np.float32))
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("shape", [(128, 256), (256, 128), (2, 128, 256),
                                   (128, 128), (3, 128, 128), (127, 512),
                                   (4, 300), (300,), (8, 8, 1024)])
def test_factored_dims_are_optax_s(shape):
    assert tt._factored_dims(shape) == factorized._factored_dims(
        shape, True, 128)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
def test_five_steps_match_optax(grad_scale):
    """Five updates from the same params and gradients: below and above
    the global-norm clip."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.05, zeros=True)
    grads = [_tree(rng, grad_scale) for _ in range(5)]
    jopt = jt.default_optimizer(**OPT)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tt.default_optimizer(**OPT).init(tp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate.apply([torch.from_numpy(g[k]) for k in tp])
    for k, v in tp.items():
        want = np.asarray(jp[k])
        scale = max(np.abs(want).max(), 1e-3)
        np.testing.assert_allclose(v.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    assert tstate.count == 5
    # the factored leaves keep only their row and column factors
    assert [x.shape for x in tstate.v[2]] == [(2, 128), (2, 256)]
    assert tstate.dims[3] is None and tstate.v[3].shape == (16, 32)
    # the steps moved every leaf (the first step's rate is 0)
    assert all(not np.array_equal(tp[k].detach().numpy(), params[k])
               for k in tp)


def test_weight_decay_is_refused():
    with pytest.raises(ValueError, match="weight_decay"):
        tt.default_optimizer(kind="adafactor", weight_decay=0.01)
    with pytest.raises(ValueError, match="weight_decay"):
        jt.default_optimizer(kind="adafactor", weight_decay=0.01)


def test_train_step_with_accum_steps_2_matches_reference():
    """``make_train_step`` takes Adafactor through the same interface as
    AdamW, microbatches included; the model's projections are wide
    enough to be factored."""
    fields = dict(vocab=64, d_model=128, n_heads=2, n_layers=1, d_ff=256,
                  max_seq=16, use_rope=True)
    jcfg = jt.ModelConfig(dtype=jnp.float32, **fields)
    tcfg = tt.ModelConfig(dtype=torch.float32, **fields)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    init = [np.asarray(x) for x in jax.tree.leaves(jp)]
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, kind="adafactor")
    jstep, jinit = jt.make_train_step(jcfg, jt.default_optimizer(**opt),
                                      accum_steps=2)
    tstep, tinit = tt.make_train_step(tcfg, tt.default_optimizer(**opt),
                                      accum_steps=2)
    jstep = jax.jit(jstep)
    jstate, tstate = jinit(jp), tinit(tp)
    w_up = next(i for i, leaf in enumerate(tstate.leaves)
                if leaf is tp["layers"][0]["w_up"])
    assert tstate.dims[w_up] is not None
    rng = np.random.default_rng(1)
    batch = tuple(rng.integers(0, 64, (4, 16)).astype(np.int32)
                  for _ in range(2))
    tbatch = tuple(map(torch.from_numpy, batch))
    for _ in range(2):
        jp, jstate, jl = jstep(jp, jstate, batch)
        tp, tstate, tl = tstep(tp, tstate, tbatch)
        assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    jleaves = jax.tree.leaves(jp)
    tleaves = tt._param_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for j, t, start in zip(jleaves, tleaves, init):
        want, got = np.asarray(j), t.detach().numpy()
        err = np.abs(got - want)
        # a step moves an element by at most lr * max(rms(leaf), 1e-3)
        assert err.max() <= 2 * 2 * 1e-2 * max(np.abs(want).max(), 1e-3)
        assert (err > 3e-5).mean() <= 1e-3, err.max()
        assert not np.array_equal(want, start)


def test_adafactor_refuses_quantized_params():
    from tpu_dra_driver_torch.workloads.models import quantize as tq
    params = {"w": tq.quantize(torch.randn(8, 8))}
    with pytest.raises(ValueError, match="floating-point"):
        tt.Adafactor().init(params)
