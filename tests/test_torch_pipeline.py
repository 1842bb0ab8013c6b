"""The port's GPipe pipeline (``parallel/pipeline.py``) across gloo
processes, against the reference's plain single-device forward and
train step: the cases of the reference's ``tests/test_pipeline.py``.

One spawned group of 2 ranks and one of 4 (``launch.run_group``: a
``FileStore`` in ``tmp_path``, timeouts at the join and in
``init_process_group``) run every multi-rank case; each rank holds its
stage (``mesh.device_put`` with ``pp_param_shardings``) and its ``dp``
rows of the batch. The reference's params come from JAX
(``convert.params_from_jax``); the JAX side runs in the parent.

- the forward at (n_stages, n_micro) = (4, 2) on 4 ranks, (2, 4) on 2,
  and (1, 2) with dp 2 on 2, within 2e-5 of ``forward``;
- window + GQA at 2 stages with ``attn_fn`` None and
  ``flash_attention`` (its plain version here) within 2e-4;
- the train step at pp 4: loss within 1e-5, stage params and ``embed``
  within 5e-4 of ``make_train_step``'s after one step;
- (dp 2, pp 2) on 4 ranks: the forward within 2e-5 and the train step
  as above; the train step also at (dp 2, pp 1) with 2 microbatches on
  2 ranks, where the one stage is both ends of the hop;
- the pipeline's hop (``spmd.shift_open``) both ways;
- every ``ValueError`` by its text, and the reference's failure on a
  RoPE config (no ``pos_embed``), in the parent.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import pipeline as tp
from tpu_dra_driver_torch.workloads.parallel import spmd as ts

TIMEOUT = 240
FWD_TOL = 2e-5
WINDOW_TOL = 2e-4
LOSS_TOL = 1e-5
PARAM_TOL = 5e-4
BASE = dict(vocab=128, d_model=64, n_heads=4, n_layers=4, d_ff=128,
            max_seq=64)
WINDOW = dict(n_kv_heads=2, window=16)
# name: (world, dp, n_stages, n_micro, model, batch, seed)
FORWARDS = {
    "pp4-m2": (4, 1, 4, 2, "base", 4, 0),
    "pp2-m4": (2, 1, 2, 4, "base", 4, 0),
    "pp1-m2-dp2": (2, 2, 1, 2, "base", 4, 0),
    "dp2-pp2-m2": (4, 2, 2, 2, "base", 8, 2),
}
WINDOWED = {"none": None, "flash": "flash"}
STEPS = {"pp4-m2": (4, 1, 4, 2), "dp2-pp2-m2": (4, 2, 2, 2),
         "pp1-m2-dp2": (2, 2, 1, 2)}


def _kw(model):
    return {**BASE, **(WINDOW if model == "window" else {})}


def _port_cfg(model):
    return tt.ModelConfig(dtype=torch.float32, **_kw(model))


def _jax_cfg(model, **extra):
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import transformer as jt
    return jt.ModelConfig(dtype=jnp.float32, **{**_kw(model), **extra})


def _reference(model, batch, seed):
    """The reference's params and tokens (numpy) and its forward."""
    import jax
    from tpu_dra_driver.workloads.models import transformer as jt
    cfg = _jax_cfg(model)
    key = jax.random.PRNGKey(seed)
    params = jt.init_params(cfg, key)
    tokens = jax.random.randint(key, (batch, cfg.max_seq), 0, cfg.vocab)
    return (jax.tree.map(np.asarray, params), np.asarray(tokens),
            np.asarray(jt.forward(params, tokens, cfg)))


def _reference_step():
    """The reference's params, batch, first loss and params after one
    AdamW(1e-3) step, as its pipeline test makes them."""
    import jax
    from tpu_dra_driver.workloads.models import transformer as jt
    cfg = _jax_cfg("base")
    key = jax.random.PRNGKey(1)
    params = jt.init_params(cfg, key)
    tokens = jax.random.randint(key, (4, cfg.max_seq), 0, cfg.vocab)
    targets = jax.random.randint(key, (4, cfg.max_seq), 0, cfg.vocab)
    step, opt_init = jt.make_train_step(cfg)
    new, _, loss = jax.jit(step)(params, opt_init(params), (tokens, targets))
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (as_np(params), np.asarray(tokens), np.asarray(targets),
            float(loss), as_np(new))


def _mesh(dp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    return DeviceMesh("cpu", torch.arange(world).reshape(dp, world // dp),
                      mesh_dim_names=("dp", "pp"))


def _placed(mesh, params, n_stages):
    pp_params = tp.params_to_pp(convert.params_from_jax(params, "cpu"),
                                n_stages)
    shard = tp.pp_param_shardings(mesh, pp_params)
    return tm.device_put(pp_params, shard), shard


def _rows(mesh, x):
    return tm.device_put(torch.from_numpy(x),
                         tm.NamedSharding(mesh, ("dp", None)))


def _forward(rank, dp, n_stages, n_micro, model, params, tokens,
             attn_fn=None):
    mesh = _mesh(dp)
    local, _ = _placed(mesh, params, n_stages)
    fwd = tp.make_pp_forward(mesh, _port_cfg(model), n_stages, n_micro,
                             attn_fn=attn_fn)
    out = fwd(local, _rows(mesh, tokens))
    return ts._all_gather_nograd(out, mesh.get_group("dp"), 0) \
        if dp > 1 else out


def _step(rank, dp, n_stages, n_micro, params, tokens, targets):
    mesh = _mesh(dp)
    local, shard = _placed(mesh, params, n_stages)
    step, init = tp.make_pp_train_step(mesh, _port_cfg("base"), n_stages,
                                       n_micro)
    _, _, loss = step(local, init(local),
                      (_rows(mesh, tokens), _rows(mesh, targets)))
    return float(loss), tm.to_full(local, shard)


def _shift(rank):
    """The two hops ``_GPipe`` posts each step: ``shift_open(x, +1)``
    with x = rank + 1 everywhere, and ``shift_open(g, -1)`` with
    g = rank + 10."""
    mesh = _mesh(1)
    x = torch.full((3,), float(rank + 1))
    g = torch.full((3,), float(rank + 10))
    return ts.shift_open(x, mesh, "pp", 1), ts.shift_open(g, mesh, "pp", -1)


def _child(rank, cases):
    out = {}
    for name, (kind, args) in cases.items():
        if kind == "forward":
            out[name] = _forward(rank, *args)
        elif kind == "window":
            attn = args[-1]
            out[name] = _forward(rank, *args[:-1], attn_fn=(
                tt.flash_attention if attn == "flash" else None))
        elif kind == "step":
            out[name] = _step(rank, *args)
        else:
            out[name] = _shift(rank)
    return out


@pytest.fixture(scope="module")
def refs():
    fwd = {name: _reference(model, batch, seed)
           for name, (_, _, _, _, model, batch, seed) in FORWARDS.items()}
    return {"forward": fwd, "window": _reference("window", 4, 4),
            "step": _reference_step()}


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    step = refs["step"][:3]
    out = {}
    for world in (2, 4):
        cases = {("shift", world): ("shift", ())}
        for name, (w, dp, s, m, model, _, _) in FORWARDS.items():
            if w == world:
                params, tokens, _ = refs["forward"][name]
                cases[("forward", name)] = (
                    "forward", (dp, s, m, model, params, tokens))
        if world == 2:
            params, tokens, _ = refs["window"]
            for attn in WINDOWED:
                cases[("window", attn)] = (
                    "window", (1, 2, 2, "window", params, tokens,
                               WINDOWED[attn]))
        for name, (w, dp, s, m) in STEPS.items():
            if w == world:
                cases[("step", name)] = ("step", (dp, s, m) + step)
        results = launch.run_group(
            _child, world, cases,
            store_dir=str(tmp_path_factory.mktemp(f"pp{world}")),
            timeout=TIMEOUT)
        for key in cases:
            out[key] = [r[key] for r in results]
    return out


@pytest.mark.parametrize("name", list(FORWARDS))
def test_pp_forward_matches_plain(runs, refs, name):
    want = refs["forward"][name][2]
    for got in runs[("forward", name)]:
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL,
                                   rtol=FWD_TOL)


@pytest.mark.parametrize("attn", list(WINDOWED))
def test_pp_forward_with_attn_fn_window_and_gqa(runs, refs, attn):
    want = refs["window"][2]
    for got in runs[("window", attn)]:
        np.testing.assert_allclose(got.numpy(), want, atol=WINDOW_TOL,
                                   rtol=WINDOW_TOL)


@pytest.mark.parametrize("name", list(STEPS))
def test_pp_train_step_matches_plain(runs, refs, name):
    from tpu_dra_driver.workloads.parallel import pipeline as jp
    _, _, _, want_loss, want = refs["step"]
    n_stages = STEPS[name][2]
    want_stages = jp.stack_layers(want["layers"], n_stages)
    for loss, params in runs[("step", name)]:
        assert abs(loss - want_loss) < LOSS_TOL, (loss, want_loss)
        for k, v in want_stages.items():
            np.testing.assert_allclose(
                params["stages"][k].numpy(), np.asarray(v, np.float32),
                atol=PARAM_TOL, rtol=PARAM_TOL,
                err_msg=f"stage param {k} diverged")
        np.testing.assert_allclose(params["embed"].numpy(), want["embed"],
                                   atol=PARAM_TOL, rtol=PARAM_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_shift_is_the_open_ended_hop_and_its_transpose(runs, world):
    for rank, (y, grad) in enumerate(runs[("shift", world)]):
        assert torch.equal(y, torch.full((3,), float(rank)))
        want = 0.0 if rank == world - 1 else float(rank + 11)
        assert torch.equal(grad, torch.full((3,), want))


def _tiny(**kw):
    return tt.ModelConfig(dtype=torch.float32, **{**BASE, **kw})


def test_pp_rejects_bad_shapes():
    params = tt.init_params(_tiny(n_layers=3), 0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tp.stack_layers(params["layers"], 2)
    moe = tt.init_params(_tiny(n_experts=2), 0, device="cpu")
    with pytest.raises(ValueError, match="does not support MoE"):
        tp.stack_layers(moe["layers"], 2)
    # the mesh rules read only the axis names and sizes
    mesh = SimpleNamespace(mesh_dim_names=("pp",), shape=(2,))
    cfg = _tiny()
    with pytest.raises(ValueError, match="has size 2 but n_stages=4"):
        tp.make_pp_forward(mesh, cfg, 4, 2)
    pp = tp.params_to_pp(tt.init_params(cfg, 0, device="cpu"), 2)
    local = dict(pp, stages={k: v[:1] for k, v in pp["stages"].items()})
    tokens = torch.zeros((4, 16), dtype=torch.int32)     # 4 % 3 != 0
    with pytest.raises(ValueError, match="microbatches"):
        tp.make_pp_forward(mesh, cfg, 2, 3)(local, tokens)
    # rank 0's slice of a tree stacked for 4 stages
    four = tp.params_to_pp(tt.init_params(cfg, 0, device="cpu"), 4)
    local4 = dict(four, stages={k: v[:2] for k, v in four["stages"].items()})
    with pytest.raises(ValueError, match="stacked for 4 stages but "
                                         "n_stages=2"):
        tp.make_pp_forward(mesh, cfg, 2, 2)(local4, tokens)


def test_pp_fails_on_rope_as_the_reference_does():
    """The reference's stages apply no RoPE and its forward adds
    ``pos_embed``, which a RoPE config has not: both packages fail at
    the conversion, with the same error."""
    import jax
    from tpu_dra_driver.workloads.models import transformer as jt
    from tpu_dra_driver.workloads.parallel import pipeline as jp
    with pytest.raises(KeyError, match="pos_embed"):
        jp.params_to_pp(jt.init_params(_jax_cfg("base", use_rope=True),
                                       jax.random.PRNGKey(0)), 2)
    with pytest.raises(KeyError, match="pos_embed"):
        tp.params_to_pp(tt.init_params(_tiny(use_rope=True), 0,
                                       device="cpu"), 2)
