"""The sharded (dp, sp, tp, ep) training step across gloo processes,
against the reference's single-device step.

One spawned group of 4 ranks (:func:`..parallel.launch.run_group`: a
``FileStore`` in ``tmp_path``, timeouts at the join and in
``init_process_group``) runs every case, as the reference's dryrun
writes it: ``param_shardings`` and ``device_put`` for the params,
``batch_sharding`` for the tokens, ``make_ring_attention(mesh, "sp",
("dp",), "tp")`` as ``attn_fn``, ``zero1_opt_shardings`` on a mesh with
dp 2. Each case takes two steps from the reference's own params
(``convert.params_from_jax``); the parent holds them against
``make_train_step`` of the reference run in JAX on one device:

- the first loss within 1e-4 and the params after one step within 5e-4
  (absolute and relative), the reference's ``test_spmd_model``
  tolerances;
- the second loss below the first;
- under ZeRO-1, each moment this rank holds is its ``dp`` slice where
  the reference's ``zero1_opt_shardings`` puts ``dp``.

A group of one rank runs the same step over a mesh whose axes are all 1
and must give the unsharded port step's loss and params bit for bit.
"""

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import ringattention as tr

LOSS_TOL = 1e-4
PARAM_TOL = 5e-4
TIMEOUT = 240
BATCH = 4
BASE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=64)
MODELS = {
    # learned positions (gathered over tp), GQA
    "dense": dict(n_kv_heads=2),
    # the dense-gated mixture, scan_layers
    "moe": dict(n_experts=4, scan_layers=True),
    # top-2 routing, RoPE, remat with the dots policy
    "topk": dict(n_experts=4, moe_top_k=2, use_rope=True, remat=True,
                 remat_policy="dots"),
    # wide enough that Adafactor factors its matrices
    "wide": dict(vocab=256, d_model=128, d_ff=256, n_kv_heads=2,
                 use_rope=True),
}
MESHES = {"sp2-tp2": (1, 2, 2, 1), "sp2-ep2": (1, 2, 1, 2),
          "dp2-tp2": (2, 1, 2, 1)}
# (model, mesh, optimizer); ZeRO-1 wherever dp is 2
CASES = [(m, mesh, "adamw" if m != "topk" else "adamw-clip")
         for m in ("dense", "moe", "topk") for mesh in MESHES] + [
    ("wide", "dp2-tp2", "adafactor-clip"),
    ("wide", "sp2-tp2", "adafactor-clip")]
IDS = [f"{m}-{mesh}-{opt}" for m, mesh, opt in CASES]


def _port_opt(kind):
    if kind == "adamw":
        return tt.AdamW(1e-3)
    if kind == "adamw-clip":
        return tt.AdamW(1e-3, clip_norm=1.0)
    return tt.Adafactor(1e-2, clip_norm=1.0)


def _jax_opt(kind):
    import optax
    if kind == "adamw":
        return optax.adamw(1e-3)
    if kind == "adamw-clip":
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(1e-3))
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(1e-2))


def _cfg(model, jax_side=False):
    kw = {**BASE, **MODELS[model]}
    if jax_side:
        import jax.numpy as jnp
        from tpu_dra_driver.workloads.models import transformer as jt
        return jt.ModelConfig(dtype=jnp.float32, **kw)
    return tt.ModelConfig(dtype=torch.float32, **kw)


def _reference(model, opt_kind):
    """The reference's params and batch (numpy), its first loss, and its
    params after one step, on one device."""
    import jax
    from tpu_dra_driver.workloads.models import transformer as jt
    cfg = _cfg(model, jax_side=True)
    key = jax.random.PRNGKey(0)
    params = jt.init_params(cfg, key)
    tokens = jax.random.randint(key, (BATCH, cfg.max_seq), 0, cfg.vocab)
    targets = jax.random.randint(jax.random.PRNGKey(1),
                                 (BATCH, cfg.max_seq), 0, cfg.vocab)
    step, opt_init = jt.make_train_step(cfg, optimizer=_jax_opt(opt_kind))
    new, _, loss = jax.jit(step)(params, opt_init(params), (tokens, targets))
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (as_np(params), np.asarray(tokens), np.asarray(targets),
            float(loss), as_np(new))


def _flat(tree):
    return [np.asarray(x) for x in tt._param_leaves(tree)]


def _case(rank, model, mesh_name, opt_kind, params, tokens, targets):
    dp, sp, tp, ep = MESHES[mesh_name]
    mesh = tm.build_mesh_spmd(dp=dp, sp=sp, tp=tp, ep=ep,
                              device_type="cpu")
    cfg = _cfg(model)
    full = convert.params_from_jax(params, device="cpu")
    ring = tr.make_ring_attention(mesh, axis_name="sp", batch_axes=("dp",),
                                  head_axis="tp")
    opt = _port_opt(opt_kind)
    train_step, opt_init = tt.make_train_step(cfg, optimizer=opt,
                                              attn_fn=ring)
    p_shard = tm.param_shardings(mesh, full)
    b_shard = tm.batch_sharding(mesh)
    z_shard = tm.zero1_opt_shardings(mesh, full, opt)
    s_params = tm.device_put(full, p_shard)
    s_batch = (tm.device_put(torch.from_numpy(tokens), b_shard),
               tm.device_put(torch.from_numpy(targets), b_shard))
    s_opt = opt_init(s_params, z_shard)
    _, _, loss1 = train_step(s_params, s_opt, s_batch)
    after = _flat(tm.to_full(s_params, p_shard))
    held = {k: tuple(v.shape) for k, v in s_opt.state_dict().items()
            if torch.is_tensor(v)}
    _, _, loss2 = train_step(s_params, s_opt, s_batch)
    return {"loss": (float(loss1), float(loss2)), "params": after,
            "held": held,
            "local": {p: tuple(x.shape) for p, x in zip(
                tt._leaf_paths(s_params), tt._param_leaves(s_params))}}


def _child(rank, cases):
    return [_case(rank, *c) for c in cases]


def _child_world1(rank, params, tokens, targets):
    """The sharded step on a one-rank mesh and the unsharded step, from
    the same params."""
    cfg = _cfg("topk")
    out = []
    for sharded in (True, False):
        p = convert.params_from_jax(params, device="cpu")
        opt = tt.AdamW(1e-3, clip_norm=1.0)
        if sharded:
            mesh = tm.build_mesh_spmd(device_type="cpu")
            step, init = tt.make_train_step(
                cfg, optimizer=opt, attn_fn=tr.make_ring_attention(mesh))
            st = init(p, tm.zero1_opt_shardings(mesh, p, opt))
        else:
            step, init = tt.make_train_step(
                cfg, optimizer=opt, attn_fn=tt.flash_attention)
            st = init(p)
        losses = [step(p, st, (torch.from_numpy(tokens),
                               torch.from_numpy(targets)))[2]
                  for _ in range(2)]
        out.append((torch.stack(losses), [x.detach().clone()
                                          for x in tt._param_leaves(p)]))
    return out


@pytest.fixture(scope="module")
def refs():
    wanted = {(m, o) for m, _, o in CASES}
    return {key: _reference(*key) for key in sorted(wanted)}


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    cases = [(m, mesh, o) + refs[(m, o)][:3] for m, mesh, o in CASES]
    results = launch.run_group(
        _child, 4, cases, store_dir=str(tmp_path_factory.mktemp("step4")),
        timeout=TIMEOUT)
    return {case: [r[i] for r in results] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_single_device(runs, refs, case):
    want = refs[(case[0], case[2])][3]
    losses = [r["loss"][0] for r in runs[case]]
    assert len(set(losses)) == 1, "ranks disagree on the global loss"
    assert abs(losses[0] - want) < LOSS_TOL, (losses[0], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_params_after_one_step_match_single_device(runs, refs, case):
    want = _flat(refs[(case[0], case[2])][4])
    for r in runs[case]:
        for got, w in zip(r["params"], want):
            np.testing.assert_allclose(got, w, atol=PARAM_TOL,
                                       rtol=PARAM_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_second_step_lowers_the_loss(runs, case):
    for r in runs[case]:
        assert r["loss"][1] < r["loss"][0]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "dp2-tp2"],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[1] == "dp2-tp2"])
def test_zero1_moments_are_dp_sharded_where_the_reference_shards_them(
        runs, refs, case):
    """Each moment this rank holds has its param's local shape with the
    dim where the reference's zero1_opt_shardings puts dp divided by
    dp; the other moments have the param's local shape or are whole."""
    import jax
    from jax.sharding import Mesh
    from tpu_dra_driver.workloads.parallel import mesh as jm
    model, mesh_name, opt_kind = case
    sizes = MESHES[mesh_name]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes),
                 ("dp", "sp", "tp", "ep"))
    params = refs[(model, opt_kind)][0]
    z = jm.zero1_opt_shardings(jmesh, params, _jax_opt(opt_kind))
    moments = {}
    for node in jax.tree_util.tree_leaves(
            z, is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "v")):
        for name, tree in (("exp_avg", getattr(node, "mu", None)),
                           ("v", getattr(node, "v", None))):
            if tree is None:
                continue
            flat = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
            for kp, sh in flat:
                path = ".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                                for k in kp)
                moments[f"{path}.{name}"] = tuple(sh.spec)
    n_dp = 0
    for r in runs[case]:
        for name, shape in r["held"].items():
            path, field = name.rsplit(".", 1)
            if field not in ("exp_avg", "exp_avg_sq", "v"):
                continue
            spec = moments[f"{path}.{'exp_avg' if 'exp' in field else 'v'}"]
            want = list(r["local"][path])
            if "dp" in spec:
                want[spec.index("dp")] //= sizes[0]
                n_dp += 1
            assert shape == tuple(want), (name, shape, want, spec)
    assert n_dp > 0


def test_all_ones_mesh_is_the_unsharded_step(tmp_path):
    params, tokens, targets = _reference("topk", "adamw-clip")[:3]
    (sharded, unsharded), = launch.run_group(
        _child_world1, 1, params, tokens, targets, store_dir=str(tmp_path),
        timeout=TIMEOUT)
    assert torch.equal(sharded[0], unsharded[0])
    for a, b in zip(sharded[1], unsharded[1]):
        assert torch.equal(a, b)
