"""The port's mesh factorizations and sharding rules against the
reference's, leaf by leaf, without a process group.

The rules read only the mesh's axis names and sizes, so the port's side
takes a stand-in with ``mesh_dim_names`` and ``shape``; the reference's
side builds its ``Mesh`` over the 8 virtual CPU devices. Specs compare
exactly: each leaf's port spec is the tuple of the reference's
``PartitionSpec``. Building a ``DeviceMesh`` over real process groups
is held in ``test_torch_collectives.py``.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.parallel import mesh as tm

SPMD_KWARGS = [
    {}, {"dp": 2}, {"sp": 2}, {"tp": 1}, {"ep": 1}, {"dp": 2, "sp": 2},
    {"dp": 2, "sp": 2, "tp": 2, "ep": 1}, {"sp": 4}, {"ep": 8}, {"dp": 3},
    {"tp": 0}, {"dp": 1, "sp": 1, "tp": 1, "ep": 1},
    {"dp": 2, "sp": 2, "tp": 1, "ep": 1},
]
DPTP_KWARGS = [{}, {"dp": 1}, {"tp": 1}, {"tp": 2}, {"dp": 2, "tp": 2},
               {"dp": 3}, {"tp": 8}]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", SPMD_KWARGS, ids=str)
def test_build_mesh_spmd_factorization_matches_reference(n, kw):
    import jax
    from tpu_dra_driver.workloads.parallel import mesh as jm

    def ref():
        m = jm.build_mesh_spmd(jax.devices()[:n], **kw)
        return tuple(m.shape[a] for a in ("dp", "sp", "tp", "ep"))

    assert _outcome(lambda: tm.mesh_shape_spmd(n, **kw)) == _outcome(ref)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", DPTP_KWARGS, ids=str)
def test_build_mesh_factorization_matches_reference(n, kw):
    import jax
    from tpu_dra_driver.workloads.parallel import mesh as jm

    def ref():
        m = jm.build_mesh(jax.devices()[:n], **kw)
        return m.shape["dp"], m.shape["tp"]

    assert _outcome(lambda: tm.mesh_shape(n, **kw)) == _outcome(ref)


def _stand_in(names, sizes):
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(sizes))


def _jax_mesh(sizes, names):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(sizes))
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes), names)


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _ref_specs(tree, sep="/"):
    """{path: PartitionSpec as a tuple} of a reference shardings tree."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {sep.join(_key(k) for k in kp): tuple(sh.spec) for kp, sh in flat}


def _port_specs(tree):
    return {path: sh.spec for path, sh in tm._tree_paths(tree)}


PARAM_CASES = {
    "dense": dict(),
    "dense-scan": dict(scan_layers=True),
    "rope-gqa": dict(use_rope=True, n_kv_heads=2),
    "moe": dict(n_experts=4),
    "moe-topk-scan": dict(n_experts=4, moe_top_k=2, scan_layers=True),
    "int8": dict(quantized=True),
    "int8-scan": dict(quantized=True, scan_layers=True),
}
MESHES = {
    "spmd-2x1x2x2": ((2, 1, 2, 2), ("dp", "sp", "tp", "ep")),
    "spmd-1x2x2x2": ((1, 2, 2, 2), ("dp", "sp", "tp", "ep")),
    "dp-tp-2x4": ((2, 4), ("dp", "tp")),
}


def _both_params(quantized=False, **kw):
    import jax
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import transformer as jt
    # the module, not the ``quantize`` function the package exports
    jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
    cfg = jt.ModelConfig(vocab=256, d_model=128, n_heads=4, n_layers=2,
                         d_ff=256, max_seq=64, dtype=jnp.float32, **kw)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    if quantized:
        params = jq.quantize_params(params)
    return params, convert.params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", PARAM_CASES)
def test_param_shardings_match_reference(case, mesh):
    from tpu_dra_driver.workloads.parallel import mesh as jm
    sizes, names = MESHES[mesh]
    jparams, tparams = _both_params(**PARAM_CASES[case])
    want = _ref_specs(jm.param_shardings(_jax_mesh(sizes, names), jparams))
    got = _port_specs(tm.param_shardings(_stand_in(names, sizes), tparams))
    assert got == want
    if PARAM_CASES[case].get("quantized"):
        # int8 codes of a column-parallel weight shard over tp, scales
        # replicate
        key = "layers/wqkv" if "scan" in case else "layers/0/wqkv"
        assert "tp" in got[f"{key}/q"] and got[f"{key}/s"] == ()


def _ref_moments(state):
    """{port state name: spec} of a reference zero1 shardings tree over
    an optax state (AdamW's mu/nu, Adafactor's v/v_row/v_col)."""
    import jax
    out = {}
    nodes = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "v_row"))
    for node in nodes:
        if hasattr(node, "mu"):
            fields = {"exp_avg": node.mu, "exp_avg_sq": node.nu}
        elif hasattr(node, "v_row"):
            fields = {"v_row": node.v_row, "v_col": node.v_col, "v": node.v}
        else:
            continue
        for name, tree in fields.items():
            for path, spec in _ref_specs(tree, ".").items():
                out[f"{path}.{name}"] = spec
    return out


OPTIMIZERS = ("adamw", "default", "adafactor")


def _both_opts(kind):
    import optax
    from tpu_dra_driver.workloads.models import transformer as jt
    if kind == "adamw":
        return optax.adamw(1e-3), tt.AdamW(1e-3)
    if kind == "default":
        return jt.default_optimizer(), tt.default_optimizer()
    return (jt.default_optimizer(kind="adafactor"),
            tt.default_optimizer(kind="adafactor"))


@pytest.mark.parametrize("mesh", ["spmd-2x1x2x2", "dp-tp-2x4"])
@pytest.mark.parametrize("kind", OPTIMIZERS)
@pytest.mark.parametrize("case", ["dense", "moe-topk-scan", "rope-gqa"])
def test_zero1_opt_shardings_match_reference(case, kind, mesh):
    from tpu_dra_driver.workloads.parallel import mesh as jm
    sizes, names = MESHES[mesh]
    jparams, tparams = _both_params(**PARAM_CASES[case])
    jopt, topt = _both_opts(kind)
    want = _ref_moments(jm.zero1_opt_shardings(_jax_mesh(sizes, names),
                                               jparams, jopt))
    got = tm.zero1_opt_shardings(_stand_in(names, sizes), tparams, topt)
    state = {name: sh.spec for name, sh in got.items()}
    names_held = {n for n in state if not n.endswith((".step", "count"))}
    # Adafactor: optax keeps (1,)-shaped placeholders where the port
    # keeps no tensor (v of a factored leaf, factors of a whole one)
    assert names_held <= set(want)
    for name in names_held:
        assert state[name] == want[name], name
    assert state["count"] == ()
    assert all(state[n] == () for n in state if n.endswith(".step"))
    dp_sharded = [n for n in names_held if "dp" in state[n]]
    if kind != "adafactor":
        assert dp_sharded, "no moment is dp-sharded"
    # the state names are the optimizer's own state_dict names
    state_dict = topt.init(tparams).state_dict()
    assert set(state) == set(state_dict)
    for name, spec in state.items():
        assert len(spec) <= torch.as_tensor(state_dict[name]).dim()


def test_batch_sharding_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    spmd = _stand_in(("dp", "sp", "tp", "ep"), (2, 2, 2, 1))
    assert tm.batch_sharding(spmd).spec == ("dp", "sp")
    assert tm.batch_sharding(spmd).placements == (
        Shard(0), Shard(1), Replicate(), Replicate())
    flat = _stand_in(("dp", "tp"), (2, 4))
    assert tm.batch_sharding(flat).spec == ("dp", None)
    assert tm.replicated(flat).placements == (Replicate(), Replicate())
    moe = tm.NamedSharding(spmd, (None, "ep", "tp", None))
    assert moe.placements == (Replicate(), Replicate(), Shard(2), Shard(1))
