"""Ring and Ulysses attention across gloo processes, against the
reference.

One spawned group per world size (2 and 4) runs every case
(:func:`..parallel.launch.run_group`: a ``FileStore`` in ``tmp_path``,
timeouts at the join and in ``init_process_group``); each rank gets the
full f32 inputs and takes its sequence shard (t_local 32), or its
(batch, head, sequence) shard on a (dp, sp, tp, ep) mesh for the
``make_*`` wrappers. The parent holds the joined outputs, and the
gradients of ``(out ** 2).sum()``, against ``attention_reference`` and
``jax.grad`` of it (every case), and against the reference's
``ring_attention`` / ``ulysses_attention`` under ``shard_map`` on the
JAX CPU mesh (a subset: each costs seconds of interpret-mode Pallas).
Tolerances are the reference's own ring tests': 2e-5 forward, 5e-4
gradients (both absolute and relative).

The same rings also run with every rank in the parent process
(``ring_attention_all_ranks``, the loops the group runs with the chunks
rotated in place of the collective), held to the group's results and
to the reference.

Windowed ring hops give rows with an empty band (the reference's Pallas
backward is wrong there); their gradients are held to
``jax.grad(attention_reference)``.
"""

import types

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads.ops.attention import (
    _visible, attention_reference,
)
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import ringattention as tr
from tpu_dra_driver_torch.workloads.parallel import spmd

WORLDS = (2, 4)
TL = 32
B, H, H_KV, D = 2, 8, 4, 32
FWD_TOL = 2e-5
GRAD_TOL = 5e-4
TIMEOUT = 150
# (attention, causal, window, prefix): windows below, equal to and above
# t_local
CASES = {
    "ring-causal": ("ring", True, None, None),
    "ring-full": ("ring", False, None, None),
    "ring-w10": ("ring", True, 10, None),
    "ring-w32": ("ring", True, 32, None),
    "ring-w80": ("ring", True, 80, None),
    "ulysses-causal": ("ulysses", True, None, None),
    "ulysses-full": ("ulysses", False, None, None),
    "ulysses-w20": ("ulysses", True, 20, None),
    "ulysses-prefix40": ("ulysses", True, None, 40),
}
# the cases also held against the reference's own sharded functions
JAX_CASES = {2: ("ring-full", "ring-w80", "ulysses-causal"),
             4: ("ring-causal", "ring-w10", "ulysses-prefix40")}
MAKER_WINDOW = 48


def _inputs(n):
    g = np.random.default_rng(n)
    t = TL * n
    return tuple(g.standard_normal(s).astype(np.float32)
                 for s in ((B, H, t, D), (B, H_KV, t, D), (B, H_KV, t, D)))


def _grad_run(fn, shards):
    qkv = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
           for x in shards]
    out = fn(*qkv)
    grads = torch.autograd.grad((out ** 2).sum(), qkv)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _child(rank, n, qkv):
    sp_mesh = tm.build_mesh_spmd(dp=1, sp=n, tp=1, ep=1, device_type="cpu")
    rows = slice(rank * TL, (rank + 1) * TL)
    shards = [x[:, :, rows] for x in qkv]
    out = {}
    for name, (kind, causal, window, prefix) in CASES.items():
        if kind == "ring":
            def fn(q, k, v):
                return tr.ring_attention(q, k, v, "sp", causal, window,
                                         mesh=sp_mesh)
        else:
            def fn(q, k, v):
                return tr.ulysses_attention(q, k, v, "sp", causal,
                                            window=window, prefix=prefix,
                                            mesh=sp_mesh)
        out[name] = _grad_run(fn, shards)
    # the makers over (dp, sp, tp, ep): batch on dp, heads on tp, the
    # sequence on sp; a window at call time and at build time
    mesh = tm.build_mesh_spmd(dp=1, sp=2, tp=n // 2, ep=1,
                              device_type="cpu")
    spec = ("dp", "tp", "sp")
    local = [tm._local(torch.from_numpy(x), spec, mesh).numpy()
             for x in qkv]
    ring_call = tr.make_ring_attention(mesh)
    ring_built = tr.make_ring_attention(mesh, window=MAKER_WINDOW)
    uly = tr.make_ulysses_attention(mesh, attn_fn=attention_reference)
    out["maker-ring-call"] = _grad_run(
        lambda q, k, v: ring_call(q, k, v, window=MAKER_WINDOW), local)
    out["maker-ring-built"] = _grad_run(ring_built, local)
    out["maker-ulysses-call"] = _grad_run(
        lambda q, k, v: uly(q, k, v, window=MAKER_WINDOW), local)
    out["coords"] = [spmd.axis_index(mesh, a) for a in ("dp", "sp", "tp")]
    out["mesh"] = tuple(mesh.shape)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: launch.run_group(
        _child, n, n, _inputs(n),
        store_dir=str(tmp_path_factory.mktemp(f"ring{n}")),
        timeout=TIMEOUT) for n in WORLDS}


def _joined(results, name):
    """The ranks' (out, dq, dk, dv) shards joined along the sequence."""
    return [np.concatenate([r[name][i] for r in results], axis=2)
            for i in range(4)]


def _reference(qkv, causal, window, prefix):
    """(out, dq, dk, dv) of the reference's attention_reference."""
    import jax
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.ops.attention import (
        attention_reference as jref,
    )

    def f(q, k, v):
        return jref(q, k, v, causal, window=window, prefix=prefix)

    args = [jnp.asarray(x) for x in qkv]
    out = f(*args)
    grads = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _jax_sharded(qkv, n, kind, causal, window, prefix):
    """(out, dq, dk, dv) of the reference's ring_attention or
    ulysses_attention under shard_map over n CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tpu_dra_driver.workloads.ops.attention import (
        attention_reference as jref,
    )
    from tpu_dra_driver.workloads.parallel import ringattention as jr
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("sp",))
    spec = P(None, None, "sp", None)
    if kind == "ring":
        def body(q, k, v):
            return jr.ring_attention(q, k, v, "sp", causal, window=window)
    else:
        def body(q, k, v):
            return jr.ulysses_attention(q, k, v, "sp", causal, attn_fn=jref,
                                        window=window, prefix=prefix)
    f = jax.shard_map(body, mesh=mesh, check_vma=False,
                      in_specs=(spec,) * 3, out_specs=spec)
    sh = NamedSharding(mesh, spec)
    args = [jax.device_put(jnp.asarray(x), sh) for x in qkv]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(),
                             argnums=(0, 1, 2)))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL, rtol=FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_matches_attention_reference(runs, n, case):
    _, causal, window, prefix = CASES[case]
    _close(_joined(runs[n], case), _reference(_inputs(n), causal, window,
                                              prefix))


@pytest.mark.parametrize("n, case", [(n, c) for n in WORLDS
                                     for c in JAX_CASES[n]])
def test_matches_reference_under_shard_map(runs, n, case):
    kind, causal, window, prefix = CASES[case]
    _close(_joined(runs[n], case),
           _jax_sharded(_inputs(n), n, kind, causal, window, prefix))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("maker", ["maker-ring-call", "maker-ring-built",
                                   "maker-ulysses-call"])
def test_makers_take_window_at_build_or_call_time(runs, n, maker):
    results = runs[n]
    assert results[0]["mesh"] == (1, 2, n // 2, 1)
    # place each rank's shard back at its (batch, head, sequence) block
    got = [np.zeros_like(x) for x in _reference_shapes(n)]
    for r in results:
        i, j, k = r["coords"]
        for o, x in enumerate(r[maker]):
            bb, hh, tt_ = (x.shape[0], x.shape[1], x.shape[2])
            got[o][i * bb:(i + 1) * bb, k * hh:(k + 1) * hh,
                   j * tt_:(j + 1) * tt_] = x
    _close(got, _reference(_inputs(n), True, MAKER_WINDOW, None))


RING_CASES = [c for c, spec in CASES.items() if spec[0] == "ring"]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", RING_CASES)
def test_all_ranks_in_one_process_match_the_group(runs, n, case):
    """``ring_attention_all_ranks`` drives every rank's hops, forward and
    backward, through the same loops as the group's ``ring_attention``,
    with the chunks rotated in place of the collective: the group's
    results to f32 rounding, and the reference's."""
    _, causal, window, _ = CASES[case]
    qkv = _inputs(n)
    got = _grad_run(lambda q, k, v: tr.ring_attention_all_ranks(
        q, k, v, n, causal, window), qkv)
    for g, w in zip(got, _joined(runs[n], case)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    _close(got, _reference(qkv, causal, window, None))


def test_all_ranks_needs_the_sequence_divisible_by_the_ring():
    x = torch.zeros(1, 2, 30, 16)
    with pytest.raises(ValueError, match=r"sequence \(30\) not divisible "
                                         r"by the ring's 4 ranks"):
        tr.ring_attention_all_ranks(x, x, x, 4)


def _reference_shapes(n):
    q, k, v = _inputs(n)
    return q, q, k, v


def _stand_in(sp):
    return types.SimpleNamespace(mesh_dim_names=("dp", "sp", "tp", "ep"),
                                 shape=(1, sp, 1, 1))


def test_ring_maker_rejects_prefix():
    ring = tr.make_ring_attention(_stand_in(2))
    x = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="does not support prefix-LM"):
        ring(x, x, x, prefix=4)


def test_ulysses_needs_heads_divisible_by_the_axis():
    x = torch.zeros(1, 3, 32, 16)
    with pytest.raises(ValueError, match=r"heads \(3\) divisible by axis "
                                         r"size \(2\)"):
        tr.ulysses_attention(x, x, x, mesh=_stand_in(2))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 1, 10, 32, 33, 80, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_schedule_visits_exactly_the_chunks_with_visible_pairs(
        n, window, causal):
    """Every (rank, chunk) pair with a visible (row, col) in the global
    mask is visited once, by the mask that reproduces the global one on
    that chunk; every other hop is skipped or never made."""
    if window is not None and not causal:
        return
    t = TL * n
    full = _visible(
        t, t, causal, window, 0, None, "cpu")
    for idx in range(n):
        masks = tr.ring_schedule(idx, n, TL, causal, window)
        assert len(masks) == 1 + tr.ring_hops(n, TL, causal, window)
        for step in range(n):
            owner = (idx - step) % n
            block = full[idx * TL:(idx + 1) * TL, owner * TL:(owner + 1) * TL]
            mask = masks[step] if step < len(masks) else None
            if mask is None:
                assert not block.any(), (idx, step)
                continue
            got = _visible(
                TL, TL, mask["causal"], mask.get("window"),
                mask.get("row_offset", 0), None, "cpu")
            assert torch.equal(got, block), (idx, step, mask)
