"""The port's masked-LM encoder against the reference's, on the CPU.

The two packages' random streams differ, so the parity tests hand the
reference's corruption (``mlm_corrupt`` from a PRNG key: the corrupted
tokens and the selected mask) to the port; the port's own
``mlm_corrupt`` is held to the corruption law on a large batch. Both run
``flash_attention`` (the reference its Pallas kernels in interpret mode,
the port the plain versions of B1-B3) under the encoder config's
all-visible prefix. fp32.

Tolerances: losses 1e-5 relative; gradients 1e-5 of each leaf's
largest; params after one step as in ``test_torch_training``. The law:
on 32,768 positions the selected share within 0.01 of 0.15 (about 5
standard deviations), and the [MASK]/random/kept split of the selected
within 0.03 of 80/10/10 (about 5 standard deviations of the 10% shares
on ~4,900 selected).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models import encoder as je
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver.workloads.ops import attention as ja
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import encoder as te
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops import attention as ta

_FIELDS = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_seq=32, use_rope=True)
JCFG = jt.ModelConfig(dtype=jnp.float32, **_FIELDS)
TCFG = tt.ModelConfig(dtype=torch.float32, **_FIELDS)
KEY = jax.random.PRNGKey(7)


def _params():
    jp = jt.init_params(je.encoder_config(JCFG), jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _tokens(seed=1, shape=(4, 32), vocab=63):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _jax_corruption(tokens, key=KEY, pad_id=None):
    corrupted, selected = je.mlm_corrupt(jnp.asarray(tokens), key,
                                         JCFG.vocab, 0.15, pad_id=pad_id)
    return (torch.from_numpy(np.array(corrupted)),
            torch.from_numpy(np.array(selected)))


def _use_corruption(monkeypatch, corruption):
    """The port's steps draw the reference's corruption instead of their
    own."""
    monkeypatch.setattr(te, "mlm_corrupt",
                        lambda *args, **kw: corruption)


def test_encoder_config():
    cfg = te.encoder_config(TCFG)
    assert cfg.prefix == TCFG.max_seq and cfg.window == 0
    with pytest.raises(ValueError, match="bidirectional"):
        te.encoder_config(tt.ModelConfig(window=8))


def test_loss_and_grads_match_reference_given_its_corruption():
    jp, tp = _params()
    tokens = _tokens()
    want, jgrads = jax.jit(jax.value_and_grad(functools.partial(
        je.mlm_loss_fn, cfg=JCFG, attn_fn=ja.flash_attention)))(
            jp, jnp.asarray(tokens), KEY)
    corrupted, selected = _jax_corruption(tokens)
    assert selected.any() and (corrupted != torch.from_numpy(tokens)).any()
    leaves = [x.requires_grad_() for x in tt._param_leaves(tp)]
    loss = te._mlm_loss(tp, torch.from_numpy(tokens), corrupted, selected,
                        te.encoder_config(TCFG), ta.flash_attention)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    for w, g in zip(jax.tree.leaves(jgrads), grads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_one_step_matches_reference(monkeypatch):
    jp, tp = _params()
    tokens = _tokens(2)
    jstep, jinit = je.make_mlm_train_step(JCFG, attn_fn=ja.flash_attention)
    tstep, tinit = te.make_mlm_train_step(TCFG, attn_fn=ta.flash_attention)
    jp, _, jloss = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(tokens), KEY)
    _use_corruption(monkeypatch, _jax_corruption(tokens))
    _, state, loss = tstep(tp, tinit(tp), torch.from_numpy(tokens),
                           torch.Generator())
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for w, g in zip(jax.tree.leaves(jp), state.leaves):
        err = np.abs(g.detach().numpy() - np.asarray(w))
        assert err.max() <= 2 * 1e-3
        assert (err > 3e-5).mean() <= 1e-3, err.max()


def test_accuracy_matches_reference(monkeypatch):
    jp, tp = _params()
    tokens = _tokens(3, (8, 32))
    want = je.mlm_accuracy(jp, jnp.asarray(tokens), KEY, JCFG)
    _use_corruption(monkeypatch, _jax_corruption(tokens))
    got = te.mlm_accuracy(tp, torch.from_numpy(tokens), torch.Generator(),
                          TCFG)
    assert got == pytest.approx(want, rel=1e-6)


def test_corruption_law():
    vocab, pad = 256, 0
    tokens = torch.from_numpy(_tokens(4, (64, 512), vocab=vocab - 1))
    tokens[:, ::7] = pad
    gen = torch.Generator().manual_seed(0)
    corrupted, selected = te.mlm_corrupt(tokens, gen, vocab, pad_id=pad)
    real = tokens != pad
    share = selected.sum().item() / real.sum().item()
    assert abs(share - 0.15) <= 0.01, share
    assert not (selected & ~real).any()          # pads never selected
    assert torch.equal(corrupted[~selected], tokens[~selected])
    n = selected.sum().item()
    masked = (selected & (corrupted == vocab - 1)).sum().item() / n
    kept = (selected & (corrupted == tokens)).sum().item() / n
    drawn = 1.0 - masked - kept
    assert abs(masked - 0.8) <= 0.03, masked
    assert abs(drawn - 0.1) <= 0.03, drawn
    assert abs(kept - 0.1) <= 0.03, kept
    assert not ((corrupted == pad) & real).any()  # pad never drawn
    # the same generator state draws the same corruption, the next a new
    again = te.mlm_corrupt(tokens, torch.Generator().manual_seed(0), vocab,
                           pad_id=pad)
    assert torch.equal(again[0], corrupted) and torch.equal(again[1],
                                                            selected)
    nxt = te.mlm_corrupt(tokens, gen, vocab, pad_id=pad)[1]
    assert not torch.equal(nxt, selected)


@pytest.mark.parametrize("pad_id", [None, 0])
def test_random_branch_never_draws_mask_or_pad(pad_id):
    """Every selected token drawn at random (no [MASK] share, none kept)
    from a 5-token vocabulary: the draws cover the real ids and never
    the [MASK] id 4, nor the pad id."""
    tokens = torch.ones((64, 512), dtype=torch.int32)
    corrupted, selected = te.mlm_corrupt(
        tokens, torch.Generator().manual_seed(1), 5, keep_rate=0.0,
        random_rate=1.0, pad_id=pad_id)
    drawn = set(corrupted[selected].unique().tolist())
    assert drawn == ({1, 2, 3} if pad_id == 0 else {0, 1, 2, 3})


def test_validation():
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    gen = torch.Generator()
    with pytest.raises(ValueError, match="mask_rate"):
        te.mlm_corrupt(tokens, gen, 16, mask_rate=0.0)
    with pytest.raises(ValueError, match="keep_rate"):
        te.mlm_corrupt(tokens, gen, 16, keep_rate=0.5, random_rate=0.6)


def test_training_reduces_the_loss():
    """The port's own steps, drawing their corruption from one
    generator, learn a structured sequence."""
    cfg = tt.ModelConfig(vocab=32, d_model=64, n_heads=2, n_layers=2,
                         d_ff=128, max_seq=32, use_rope=True,
                         dtype=torch.float32)
    rows = [[(s + 3 * i) % 31 for i in range(32)] for s in range(16)]
    tokens = torch.tensor(rows, dtype=torch.int32)
    params = tt.init_params(te.encoder_config(cfg), 0, device="cpu")
    step, init = te.make_mlm_train_step(cfg, optimizer=tt.AdamW(2e-3))
    state = init(params)
    gen = torch.Generator().manual_seed(0)
    losses = [step(params, state, tokens, gen)[2].item() for _ in range(80)]
    late = sum(losses[-10:]) / 10
    assert late < 0.6 * losses[0], (losses[0], late)
