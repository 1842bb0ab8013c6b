"""A train state sharded over a gloo mesh: saved from every rank,
restored onto the mesh and onto one device, and resumed; and sharded
prefetch.

One spawned group of 4 ranks (``launch.run_group``, a ``FileStore`` in
``tmp_path``) takes one ZeRO-1 step of the sharded (dp 2, tp 2) train
step from the reference's params (``convert.params_from_jax``), then:

- saves ``{"params", "opt"}`` with ``save_train_state(...,
  shardings={"params": param_shardings})`` into a directory the parent
  gives;
- restores it onto the mesh (``abstract_like(state, shardings=...)``):
  every param shard and every moment this rank holds bit-equal, the
  ZeRO-1 moments still their ``dp`` slices;
- restores it whole in the group (``on_one_device``), bit-equal to
  ``mesh.to_full`` of the shards;
- takes one more step from the restored state and from the live one:
  the losses and params bit-identical;
- iterates ``prefetch_to_device(..., sharding=batch_sharding(mesh))``
  over three host batches: each rank gets its rows;
- saves once more with rank 1's writer failing: every rank raises, and
  nothing of that save is left.

The parent then restores the same checkpoint onto one CPU device in a
process with no group, bit-equal to the gathered state.
"""

import os

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert, data
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import ringattention as tr
from tpu_dra_driver_torch.workloads.utils import checkpoint as ck

TIMEOUT = 240
FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, max_seq=32)
BATCH = 4
PREFETCH = 3


def _reference():
    import jax
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import transformer as jt
    cfg = jt.ModelConfig(dtype=jnp.float32, **FIELDS)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab, (BATCH, cfg.max_seq)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _opt_tensors(opt):
    return {k: v for k, v in opt.state_dict().items() if torch.is_tensor(v)}


def _failed_save(rank, ckdir, state, shardings):
    """A save at step 2 whose writer fails on rank 1 alone: what each
    rank raised, and the checkpoint directory after every rank has."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    writer = dcp.FileSystemWriter
    if rank == 1:
        def broken(path, *args, **kwargs):
            raise OSError(f"no space left for {path}")
        dcp.FileSystemWriter = broken
    try:
        ck.save_train_state(ckdir, 2, state, shardings=shardings)
        raised = None
    except (OSError, RuntimeError) as e:
        raised = (type(e).__name__, str(e))
    finally:
        dcp.FileSystemWriter = writer
    dist.barrier()
    return raised, sorted(os.listdir(ckdir))


def _child(rank, params, tokens, ckdir):
    cfg = tt.ModelConfig(dtype=torch.float32, **FIELDS)
    mesh = tm.build_mesh_spmd(dp=2, sp=1, tp=2, ep=1, device_type="cpu")
    full = convert.params_from_jax(params, device="cpu")
    opt = tt.AdamW(1e-3)
    step, init = tt.make_train_step(
        cfg, optimizer=opt, attn_fn=tr.make_ring_attention(mesh))
    p_shard = tm.param_shardings(mesh, full)
    b_shard = tm.batch_sharding(mesh)
    s_params = tm.device_put(full, p_shard)
    s_opt = init(s_params, tm.zero1_opt_shardings(mesh, full, opt))
    toks = tm.device_put(torch.from_numpy(tokens), b_shard)
    batch = (toks, toks)
    step(s_params, s_opt, batch)

    state = {"params": s_params, "opt": s_opt}
    shardings = {"params": p_shard}
    ck.save_train_state(ckdir, 1, state, shardings=shardings)
    abstract = ck.abstract_like(state, shardings=shardings)
    back = ck.restore_train_state(ckdir, abstract)
    mesh_equal = all(_bits(a, b) for a, b in zip(
        tt._param_leaves(s_params), tt._param_leaves(back["params"])))
    held, got = _opt_tensors(s_opt), _opt_tensors(back["opt"])
    mesh_equal &= held.keys() == got.keys() and all(
        _bits(held[k], got[k]) for k in held)
    layout = s_opt.layout
    n_dp = sum(dim is not None for dim in layout.zero_dims)

    whole = ck.restore_train_state(ckdir, ck.on_one_device(abstract))
    gathered = tm.to_full(s_params, p_shard)
    moments = {}
    for i, path in enumerate(s_opt.paths):
        for name in ("exp_avg", "exp_avg_sq"):
            moments[f"{path}.{name}"] = layout.full(
                held[f"{path}.{name}"], layout.held_spec(i))
    one_equal = all(_bits(a, b) for a, b in zip(
        tt._param_leaves(gathered), tt._param_leaves(whole["params"])))
    whole_opt = _opt_tensors(whole["opt"])
    one_equal &= all(_bits(whole_opt[k], moments.get(k, held[k]))
                     for k in whole_opt)

    _, _, loss_cont = step(s_params, s_opt, batch)
    _, _, loss_res = step(back["params"], back["opt"], batch)
    resumed = _bits(loss_cont, loss_res) and all(_bits(a, b) for a, b in zip(
        tt._param_leaves(s_params), tt._param_leaves(back["params"])))

    host = [np.arange(i * 100, i * 100 + BATCH * 6).reshape(BATCH, 6)
            for i in range(PREFETCH)]
    fed = [b.clone() for b in data.prefetch_to_device(iter(host),
                                                      sharding=b_shard)]
    failed_save = _failed_save(rank, ckdir, state, shardings)
    return {"failed_save": failed_save, "mesh_equal": mesh_equal, "n_dp": n_dp,
            "held_shapes": {k: tuple(v.shape) for k, v in got.items()},
            "one_equal": one_equal, "resumed": resumed,
            "gathered": gathered, "moments": moments,
            "local": dict(zip(tt._leaf_paths(s_params),
                              (tuple(x.shape) for x in
                               tt._param_leaves(s_params)))),
            "dp": tm.axis_index(mesh, "dp"), "fed": fed}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    params, tokens = _reference()
    ckdir = str(tmp_path_factory.mktemp("ck"))
    results = launch.run_group(
        _child, 4, params, tokens, ckdir,
        store_dir=str(tmp_path_factory.mktemp("ck4")), timeout=TIMEOUT)
    return params, ckdir, results


def test_restore_onto_the_mesh_is_bit_equal(run):
    for r in run[2]:
        assert r["mesh_equal"]


def test_zero1_moments_keep_their_dp_slices(run):
    """Each restored moment is its param's local shard, halved on one
    dim where ZeRO-1 splits it over dp 2."""
    params = convert.params_from_jax(run[0], device="cpu")
    shapes = dict(zip(tt._leaf_paths(params),
                      (tuple(x.shape) for x in tt._param_leaves(params))))
    for r in run[2]:
        assert r["n_dp"] > 0
        sliced = 0
        for name, shape in r["held_shapes"].items():
            path, field = name.rsplit(".", 1)
            if field not in ("exp_avg", "exp_avg_sq"):
                continue
            assert tuple(r["moments"][name].shape) == shapes[path]
            local = r["local"][path]
            if shape != local:
                halved = [i for i, (a, b) in enumerate(zip(shape, local))
                          if a != b]
                assert len(halved) == 1 and \
                    2 * shape[halved[0]] == local[halved[0]], (name, shape)
                sliced += 1
        assert sliced == 2 * r["n_dp"]


def test_restore_onto_one_device_in_the_group_is_bit_equal(run):
    for r in run[2]:
        assert r["one_equal"]


def test_resumed_step_is_bit_identical(run):
    for r in run[2]:
        assert r["resumed"]


def test_restore_onto_one_cpu_device_without_a_group(run):
    """The parent (no process group) restores the 4-rank checkpoint
    whole, through a skeleton of the unsharded state."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    params, ckdir, results = run
    full = convert.params_from_jax(params, device="cpu")
    like = {"params": full, "opt": tt.AdamW(1e-3).init(full)}
    back = ck.restore_train_state(ckdir, ck.abstract_like(like,
                                                          device="cpu"))
    want = results[0]
    for a, b in zip(tt._param_leaves(want["gathered"]),
                    tt._param_leaves(back["params"])):
        assert _bits(a, b)
    got = _opt_tensors(back["opt"])
    for name, moment in want["moments"].items():
        assert _bits(got[name], moment), name
    assert back["opt"].state_dict()["count"] == 1


def test_a_save_that_fails_on_one_rank_fails_on_every_rank(run):
    """Rank 1's writer fails before DCP's collectives: every rank
    raises (rank 1 its own error, the others one naming rank 1), none
    waits, and no step or temporary directory is left."""
    for rank, r in enumerate(run[2]):
        raised, listing = r["failed_save"]
        assert raised is not None, rank
        if rank == 1:
            assert raised[0] == "OSError" and "no space left" in raised[1]
        else:
            assert raised[0] == "RuntimeError", raised
            assert "failed on rank(s) [1]" in raised[1], raised
        assert listing == [os.path.basename(ck._step_dir(".", 1))], listing


def test_prefetch_with_sharding_yields_each_ranks_rows(run):
    for r in run[2]:
        rows = slice(r["dp"] * BATCH // 2, (r["dp"] + 1) * BATCH // 2)
        assert len(r["fed"]) == PREFETCH
        for i, got in enumerate(r["fed"]):
            want = np.arange(i * 100, i * 100 + BATCH * 6).reshape(BATCH, 6)
            np.testing.assert_array_equal(got.numpy(), want[rows])


def test_prefetch_refuses_sharding_with_put():
    with pytest.raises(ValueError, match="either sharding or a custom put"):
        next(data.prefetch_to_device(iter([]), sharding=object(),
                                     put=lambda b: b))
