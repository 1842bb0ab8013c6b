"""The plain reference against the port's own plain path (its CUDA
kernels' plain versions on the CPU), at tiny widths, all in float32.

Tolerances: logits 1e-4 absolute (about 1e-5 of their spread; the port
takes RoPE's angles in float32, the reference in float64); losses 1e-5
relative; parameters after two AdamW steps 2e-5 absolute, a tenth of a
step of lr 2e-4 (Adam moves an element whose gradient is below the two
sides' rounding by up to lr either way, and with weight 2e-4 seen on
none here)."""

import pytest
import torch

from portbench import weights
from portbench.reference import starcoder2 as ref
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops.attention import flash_attention

SHAPE = dict(vocab=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128)


def _port_cfg(window):
    return tt.ModelConfig(max_seq=256, dtype=torch.float32, use_rope=True,
                          window=window, **SHAPE)


@pytest.mark.parametrize("window", [0, 48])
def test_logits_match_the_port(window):
    shape = ref.Shape(window=window, **SHAPE)
    params = weights.make_params(shape, 11, "cpu", dtype=torch.float32)
    tokens = torch.randint(0, 96, (2, 128),
                           generator=torch.Generator().manual_seed(3))
    got = ref.logits(params, tokens, shape)
    want = tt.forward(params, tokens, _port_cfg(window),
                      attn_fn=flash_attention)
    assert (got - want).abs().max() < 1e-4


@pytest.mark.parametrize("window", [0, 48])
def test_training_matches_the_port(window):
    shape = ref.Shape(window=window, **SHAPE)
    opt = dict(lr=2e-4, weight_decay=0.1, clip_norm=1.0)
    mine = weights.make_params(shape, 5, "cpu", dtype=torch.float32)
    port = weights.make_params(shape, 5, "cpu", dtype=torch.float32)
    tr = ref.TrainReference(mine, shape, ref.AdamW(**opt))
    step, init = tt.make_train_step(
        _port_cfg(window), optimizer=tt.AdamW(
            learning_rate=opt["lr"], weight_decay=opt["weight_decay"],
            clip_norm=opt["clip_norm"]), attn_fn=flash_attention)
    state = init(port)
    for i in range(2):
        batch = torch.randint(0, 96, (2, 129),
                              generator=torch.Generator().manual_seed(i))
        want = float(step(port, state, (batch[:, :-1], batch[:, 1:]))[2])
        got = tr.step(list(batch.split(1)))
        assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(ref.leaves(mine), ref.leaves(port)):
        assert (a.detach() - b.detach()).abs().max() < 2e-5


def test_fp8_control_departs_from_f32():
    shape = ref.Shape(**SHAPE)
    params = weights.make_params(shape, 2, "cpu", dtype=torch.float32)
    tokens = torch.randint(0, 96, (1, 64),
                           generator=torch.Generator().manual_seed(1))
    f32 = ref.logits(params, tokens, shape)
    fp8 = ref.logits(params, tokens, shape, "fp8")
    assert 1e-3 < (f32 - fp8).abs().max() < 1.0


def test_leaf_order_is_the_ports():
    shape = ref.Shape(**SHAPE)
    params = weights.make_params(shape, 0, "cpu")
    assert ref.leaf_names(shape.n_layers) == tt._leaf_paths(params)
