"""Entry points of the port, the counterparts of ``entry()`` and
``dryrun_multichip(n)`` in ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: ``fn(*example_args)`` is the
next-token loss of a tiny flagship transformer (vocab 512, d_model 256,
4 heads, 2 layers, d_ff 512, learned positions, bf16) on a [4, 128]
batch. Weights come from seed 0 and tokens from numpy seed 0, so they
are not the reference's weights; a caller that wants those converts the
reference's params with ``convert.params_from_jax`` and passes them to
``fn``.

``dryrun_multichip(n)`` runs the whole multi-device tier on tiny shapes,
part for part as the reference's, on each rank of a process group of
``n`` ranks, and prints the reference's summary line.
``python -m tpu_dra_driver_torch.entry N`` starts N processes
(``parallel.launch.run_group``), one a card over NCCL, or on the CPU
over gloo with ``--backend gloo``, and runs it on each.
"""

from __future__ import annotations

import functools
import shutil
import sys
import tempfile
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, init_params, loss_fn,
)

CONFIG = ModelConfig(vocab=512, d_model=256, n_heads=4, n_layers=2,
                     d_ff=512, max_seq=128)
BATCH, SEQ = 4, 128


def entry(device="cuda"):
    """(fn, example_args) for the tiny flagship config on ``device``."""
    dev = resolve_device(device)
    params = init_params(CONFIG, 0, device=dev)
    rng = np.random.RandomState(0)
    tokens, targets = (
        torch.from_numpy(rng.randint(0, CONFIG.vocab, (BATCH, SEQ))
                         .astype(np.int32)).to(dev)
        for _ in range(2))
    fn = functools.partial(loss_fn, cfg=CONFIG)
    return fn, (params, (tokens, targets))


def _ints(shape, high: int, seed: int, dev, low: int = 0) -> torch.Tensor:
    """Tokens from numpy ``seed``, the same on every rank."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(low, high, shape).astype(np.int32)
                            ).to(dev)


def _from_rank0(value):
    """Rank 0's ``value`` on every rank (a part that ran on a subset of
    the ranks reports to all)."""
    got = [value]
    dist.broadcast_object_list(got, src=0)
    return got[0]


def _first(n: int, dt: str, names, shape):
    """A mesh over the first ``n`` ranks (every rank of the group takes
    part in making it; a rank outside it has no coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dt, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _in(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _local_shape(shape, spec, mesh):
    from tpu_dra_driver_torch.workloads.parallel.spmd import axis_size
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // axis_size(mesh, ax) for n, ax in zip(shape, spec))


def _zero1_part(n: int, dt: str, dev) -> tuple:
    """The (dp 2, sp 2, tp 2, ep 1) step over the first 8 ranks with the
    moments dp-sharded: every moment this rank holds has the local shape
    of its requested sharding, before and after the step."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        AdamW, ModelConfig, _leaf_paths, _param_leaves, init_params,
        make_train_step,
    )
    from tpu_dra_driver_torch.workloads.parallel import mesh as pm
    from tpu_dra_driver_torch.workloads.parallel.ringattention import (
        make_ring_attention,
    )
    if n < 8:
        return float("nan"), "skipped (n_devices < 8)"
    z_mesh = pm.build_mesh_spmd(list(range(8)), dp=2, sp=2, tp=2, ep=1,
                                device_type=dt)
    out = None
    if _in(z_mesh):
        z_cfg = ModelConfig(vocab=512, d_model=128 * 2, n_heads=2 * 2,
                            n_layers=2, d_ff=128 * 2, max_seq=32 * 2,
                            scan_layers=True)
        z_params = init_params(z_cfg, 0, device=dev)
        z_ring = make_ring_attention(z_mesh, axis_name="sp",
                                     batch_axes=("dp",), head_axis="tp")
        z_step, z_opt_init = make_train_step(z_cfg, attn_fn=z_ring)
        z_opt_shard = pm.zero1_opt_shardings(z_mesh, z_params, AdamW(1e-3))
        shapes = dict(zip(_leaf_paths(z_params),
                          (tuple(x.shape) for x in _param_leaves(z_params))))
        z_local = pm.device_put(z_params, pm.param_shardings(z_mesh,
                                                             z_params))
        z_opt = z_opt_init(z_local, z_opt_shard)

        def check(when):
            n_dp = 0
            for name, v in z_opt.state_dict().items():
                path, _, field = name.rpartition(".")
                if field not in ("exp_avg", "exp_avg_sq"):
                    continue
                spec = z_opt_shard[name].spec
                want = _local_shape(shapes[path], spec, z_mesh)
                assert tuple(v.shape) == want, (
                    f"{when} opt leaf {name} held as {tuple(v.shape)}, "
                    f"requested {spec} ({want})")
                n_dp += "dp" in spec
            return n_dp

        n_dp_sharded = check("opt")
        assert n_dp_sharded > 0, (
            "ZeRO-1 dryrun: no optimizer-state leaf is dp-sharded")
        zb = pm.device_put(_ints((2 * 2, z_cfg.max_seq), z_cfg.vocab, 1,
                                 dev), pm.batch_sharding(z_mesh))
        _, _, z_loss = z_step(z_local, z_opt, (zb, zb))
        zlv = float(z_loss)
        assert zlv == zlv and zlv > 0, f"bad loss from dp=2 step: {zlv}"
        # the step kept the ZeRO-1 slices (it did not gather the moments
        # back to whole)
        check("post-step")
        out = (zlv, f"{n_dp_sharded} moment leaves dp-sharded, "
                    f"shardings preserved through the step")
    return _from_rank0(out)


def _pp_part(n: int, dt: str, dev) -> tuple:
    """One GPipe train step over a pp axis of the first 2 ranks (1 when
    there is one)."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        ModelConfig, init_params,
    )
    from tpu_dra_driver_torch.workloads.parallel import mesh as pm
    from tpu_dra_driver_torch.workloads.parallel.pipeline import (
        make_pp_train_step, params_to_pp, pp_param_shardings,
    )
    n_stages = 2 if n >= 2 else 1
    pp_mesh = _first(n_stages, dt, ("pp",), (n_stages,))
    plv = None
    if _in(pp_mesh):
        pp_cfg = ModelConfig(vocab=256, d_model=128, n_heads=4,
                             n_layers=2 * n_stages, d_ff=128, max_seq=32)
        pp_params = init_params(pp_cfg, 0, device=dev)
        pp_step, pp_opt_init = make_pp_train_step(pp_mesh, pp_cfg, n_stages,
                                                  n_micro=2)
        ppp0 = params_to_pp(pp_params, n_stages)
        ppp = pm.device_put(ppp0, pp_param_shardings(pp_mesh, ppp0))
        pt = _ints((4, pp_cfg.max_seq), pp_cfg.vocab, 2, dev)
        _, _, pp_loss = pp_step(ppp, pp_opt_init(ppp), (pt, pt))
        plv = float(pp_loss)
        assert plv == plv and plv > 0, f"bad loss from pp step: {plv}"
    return n_stages, _from_rank0(plv)


def _whole(state: dict, shardings) -> dict:
    """A {"params", "opt"} state as one flat dict of whole tensors: the
    params gathered by their shardings, the moments by the optimizer's
    layout (the rest as the state holds it)."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        _leaf_paths, _param_leaves,
    )
    from tpu_dra_driver_torch.workloads.parallel import mesh as pm
    params = state["params"] if shardings is None \
        else pm.to_full(state["params"], shardings)
    out = dict(zip(_leaf_paths(params), _param_leaves(params)))
    opt = state["opt"]
    held = {}
    if opt.layout is not None:
        for i, path in enumerate(opt.paths):
            for name in ("exp_avg", "exp_avg_sq"):
                held[f"{path}.{name}"] = opt.layout.held_spec(i)
    for name, v in opt.state_dict().items():
        if name in held:
            v = opt.layout.full(v, held[name])
        out[f"opt.{name}"] = v
    return out


def _bit_equal(a, b) -> bool:
    if torch.is_tensor(a):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def _checkpoint_part(state: dict, p_shard, step, batch) -> None:
    """The sharded state saved from every rank and restored onto the
    mesh and whole, both bit-equal, and one step from the restored state
    bit-identical to the live continuation."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        _param_leaves,
    )
    from tpu_dra_driver_torch.workloads.utils.checkpoint import (
        abstract_like, on_one_device, restore_train_state, save_train_state,
    )
    shardings = {"params": p_shard}
    ckdir = _from_rank0(tempfile.mkdtemp(prefix="dryrun-ck-")
                        if dist.get_rank() == 0 else None)
    try:
        save_train_state(ckdir, 1, state, shardings=shardings)
        abstract = abstract_like(state, shardings=shardings)
        restored = restore_train_state(ckdir, abstract)
        for orig, back in zip(_param_leaves(state["params"]),
                              _param_leaves(restored["params"])):
            assert _bit_equal(orig, back), \
                "mesh-restored checkpoint is not bit-equal"
        held, got = state["opt"].state_dict(), restored["opt"].state_dict()
        assert held.keys() == got.keys() and all(
            _bit_equal(held[k], got[k]) for k in held), \
            "mesh-restored optimizer state is not bit-equal"
        # single-device restore: the same bytes, whole, no mesh
        solo = restore_train_state(ckdir, on_one_device(abstract))
        want, back = _whole(state, p_shard), _whole(solo, None)
        assert want.keys() == back.keys() and all(
            _bit_equal(want[k], back[k]) for k in want), \
            "single-device-restored checkpoint is not bit-equal"
        # resume: one more sharded step from the restored state must
        # equal the continuation from the live state exactly
        _, _, loss_cont = step(state["params"], state["opt"], batch)
        _, _, loss_res = step(restored["params"], restored["opt"], batch)
        assert float(loss_cont) == float(loss_res), (
            f"resumed step diverged: {float(loss_cont)} vs "
            f"{float(loss_res)}")
        for a, b in zip(_param_leaves(state["params"]),
                        _param_leaves(restored["params"])):
            assert _bit_equal(a, b), \
                "resumed params diverged from continuation"
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(ckdir, ignore_errors=True)


def _multislice_part(n: int, dt: str, dev) -> str:
    """MEGASCALE_* derived from cliques, then the DCN-boundary sum the
    env describes (a psum over "ici", then over "dcn") against the flat
    psum over the same ranks and the plain sum."""
    from tpu_dra_driver_torch.computedomain import DRIVER_NAMESPACE
    from tpu_dra_driver_torch.computedomain.multislice import (
        MEGASCALE_PORT, CliqueStore, multislice_env,
    )
    from tpu_dra_driver_torch.workloads.parallel.spmd import psum
    if not (n >= 4 and n % 2 == 0):
        return (f"multislice skipped (n_devices={n} not an even "
                f"count >= 4)")
    cliques = CliqueStore()
    cd_uid = "dryrun-cd"
    n_slices = 2
    per_slice = n // n_slices
    for s in range(n_slices):
        cliques.create({
            "apiVersion": "resource.tpu.google.com/v1beta1",
            "kind": "ComputeDomainClique",
            "metadata": {"name": f"{cd_uid}.slice-{s}",
                         "namespace": DRIVER_NAMESPACE},
            "daemons": [{"nodeName": f"host-{s}-{w}",
                         "ipAddress": f"10.{s}.0.{w + 2}",
                         "index": w, "status": "Ready"}
                        for w in range(2)],
        })
    envs = [multislice_env(cliques, cd_uid, n_slices, f"slice-{s}")
            for s in range(n_slices)]
    assert [e["MEGASCALE_SLICE_ID"] for e in envs] == ["0", "1"], envs
    assert all(e["MEGASCALE_COORDINATOR_ADDRESS"]
               == f"10.0.0.2:{MEGASCALE_PORT}" for e in envs), envs
    assert all(int(e["MEGASCALE_NUM_SLICES"]) == n_slices for e in envs)

    # the mesh the env describes: outer axis = slices (DCN), inner =
    # ranks within a slice (ICI); rank r holds row r of x
    ms_mesh = _first(n, dt, ("dcn", "ici"), (n_slices, per_slice))
    x = torch.arange(n * 4, dtype=torch.float32, device=dev).reshape(n, 4)
    block = x[dist.get_rank()]
    within = psum(block.sum(), ms_mesh, ("ici",))       # ICI reduction
    cross = float(psum(within, ms_mesh, ("dcn",)))      # DCN boundary hop
    flat_mesh = _first(n, dt, ("all",), (n,))
    ref = float(psum(block.sum(), flat_mesh, ("all",)))
    assert cross == ref == float(x.sum()), (cross, ref, float(x.sum()))
    return (f"2-slice multislice OK (MEGASCALE env from cliques, "
            f"dcn-psum over {n_slices}x{per_slice} == flat psum)")


def _collectives_part(n: int) -> str:
    """The collective benchmarks' busbw accounting against the nccl-tests
    formulas, and the ppermute ring's self-check."""
    from tpu_dra_driver_torch.workloads.ops.collectives import (
        all_gather_bandwidth, ppermute_latency, psum_bandwidth,
        reduce_scatter_bandwidth,
    )
    checks = [
        ("psum", psum_bandwidth, 2 * (n - 1) / n),
        ("all_gather", all_gather_bandwidth, (n - 1) / n),
        ("reduce_scatter", reduce_scatter_bandwidth, (n - 1) / n),
    ]
    parts = []
    for cname, fn, want in checks:
        r = fn(mib_per_device=1, iters=2)
        got = r.bus_gbps / r.algo_gbps
        assert abs(got - want) < 1e-9, (
            f"{cname} busbw accounting at n={n}: bus/algo={got:.6f}, "
            f"nccl-tests formula says {want:.6f}")
        assert r.algo_gbps > 0 and r.median_s > 0, (cname, r)
        assert r.bytes_per_device <= 1 << 20, (cname, r.bytes_per_device)
        parts.append(f"{cname} busbw/algbw={got:.3f}")
    pl = ppermute_latency(hops=n, iters=2)
    assert pl.per_hop_us > 0
    return (f"collective accounting OK at n={n}: {', '.join(parts)} "
            f"(match nccl-tests formulas 2(n-1)/n and (n-1)/n), ppermute "
            f"ring hop self-check OK ({pl.per_hop_us:.0f} us/hop "
            f"{pl.backend})")


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """One full training step sharded over an ``n_devices`` (dp, sp, tp,
    ep) mesh (ring attention over sp, Megatron tp, MoE experts over ep,
    batch over dp), then each part of the reference's dryrun in order:
    the ZeRO-1 dp 2 step (n >= 8), a GPipe train step, int8 decode under
    a (dp, tp) mesh, the tp-sharded engine token-identical to the solo
    one, the checkpoint round trip, multislice (even n >= 4), the
    sharded seq2seq loss and the collectives' accounting; prints and
    returns the reference's summary line.

    Runs on this rank of a process group of ``n_devices`` ranks (NCCL
    on the card, one card per rank; gloo with ``device="cpu"``); every
    rank calls it. Tiny shapes, bf16, weights and tokens from fixed
    seeds (the same on every rank)."""
    from tpu_dra_driver_torch.workloads.models import seq2seq as s2s
    from tpu_dra_driver_torch.workloads.models.generate import generate
    from tpu_dra_driver_torch.workloads.models.quantize import (
        quantize_params,
    )
    from tpu_dra_driver_torch.workloads.models.serving import ServingEngine
    from tpu_dra_driver_torch.workloads.models.transformer import (
        AdamW, ModelConfig, make_train_step,
    )
    from tpu_dra_driver_torch.workloads.parallel import mesh as pm
    from tpu_dra_driver_torch.workloads.parallel.ringattention import (
        make_ring_attention,
    )
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): the process group has "
            f"{world} ranks; run it on each rank of a group of "
            f"{n_devices} (python -m tpu_dra_driver_torch.entry "
            f"{n_devices} starts one)")
    dt = dev.type
    mesh = pm.build_mesh_spmd(device_type=dt)
    dp, sp, tp, ep = pm.mesh_shape_spmd(n_devices)

    # scan_layers: stacked [L, ...] weight storage under the full
    # sharding stack: ring attention over sp, Megatron tp on block
    # weights, MoE experts over ep, batch over dp
    cfg = ModelConfig(vocab=512, d_model=128 * max(1, tp),
                      n_heads=2 * tp, n_layers=2, d_ff=128 * max(1, tp),
                      max_seq=32 * sp, n_experts=2 * ep, scan_layers=True)
    params = init_params(cfg, 0, device=dev)
    ring = make_ring_attention(mesh, axis_name="sp", batch_axes=("dp",),
                               head_axis="tp")
    train_step, opt_init = make_train_step(cfg, attn_fn=ring)
    p_shard = pm.param_shardings(mesh, params)
    b_shard = pm.batch_sharding(mesh)
    batch_size = 2 * dp
    tokens = pm.device_put(_ints((batch_size, cfg.max_seq), cfg.vocab, 0,
                                 dev), b_shard)
    targets = pm.device_put(_ints((batch_size, cfg.max_seq), cfg.vocab, 1,
                                  dev), b_shard)
    # ZeRO-1: the moments placed by dp-sharded shardings (the param
    # shardings when dp is 1)
    z_shard = pm.zero1_opt_shardings(mesh, params, AdamW(1e-3))
    params = pm.device_put(params, p_shard)
    opt_state = opt_init(params, z_shard)
    params, opt_state, loss = train_step(params, opt_state,
                                         (tokens, targets))
    lv = float(loss)
    assert lv == lv and lv > 0, f"bad loss from sharded step: {lv}"

    zlv, z_assert = _zero1_part(n_devices, dt, dev)
    n_stages, plv = _pp_part(n_devices, dt, dev)

    # inference parallelism: KV-cache decode under a (dp, tp) mesh with
    # int8 weight-only quantized params (codes shard by the Megatron
    # rules, each rank's scales its codes' block)
    d_mesh = pm.build_mesh(device_type=dt)
    d_dp, d_tp = pm.mesh_shape(n_devices)
    d_cfg = ModelConfig(vocab=256, d_model=128 * max(1, d_tp),
                        n_heads=2 * d_tp, n_layers=2, d_ff=256, max_seq=32,
                        use_rope=True)
    d_params = quantize_params(init_params(d_cfg, 0, device=dev))
    d_prompt = pm.device_put(_ints((2 * d_dp, 8), d_cfg.vocab, 3, dev),
                             pm.NamedSharding(d_mesh, ("dp", None)))
    d_params = pm.device_put(d_params, pm.param_shardings(d_mesh, d_params))
    d_out = generate(d_params, d_cfg, d_prompt, steps=3, mesh=d_mesh)
    assert d_out.shape == (d_prompt.shape[0], 11), d_out.shape

    # serving: the continuous-batching engine with its paged KV pools
    # holding this rank's kv heads and params sharded by the Megatron
    # rules must match the single-device engine token for token
    s_cfg = ModelConfig(vocab=128, d_model=64 * max(1, d_tp),
                        n_heads=2 * d_tp, n_kv_heads=d_tp, n_layers=2,
                        d_ff=128, max_seq=64, use_rope=True)
    s_params = init_params(s_cfg, 7, device=dev)
    prompts = [[1, 2, 3, 4], [5, 6, 7]]

    def run_engine(params, mesh=None):
        eng = ServingEngine(params, s_cfg, n_blocks=16, block_t=8,
                            max_batch=2, device=dev, mesh=mesh)
        for pr in prompts:
            eng.add(pr, max_new_tokens=4)
        while any(r is not None for r in eng.rows):
            eng.step()
        return [eng.finished[rid] for rid in sorted(eng.finished)]

    toks_sharded = run_engine(pm.device_put(
        s_params, pm.param_shardings(d_mesh, s_params)), d_mesh)
    toks_solo = run_engine(s_params)
    assert toks_sharded == toks_solo, (
        f"tp-sharded serving diverged: {toks_sharded} vs {toks_solo}")

    _checkpoint_part({"params": params, "opt": opt_state}, p_shard,
                     train_step, (tokens, targets))
    ms_note = _multislice_part(n_devices, dt, dev)

    # the seq2seq family under the mesh: one sharded teacher-forced loss
    # with the cross-attention projections placed by
    # seq2seq_param_shardings, against the unsharded value
    s2_cfg = s2s.Seq2SeqConfig(vocab=64, d_model=32 * max(1, d_tp),
                               n_heads=2 * d_tp, n_enc_layers=1,
                               n_dec_layers=1, d_ff=64, max_src=16,
                               max_tgt=16)
    s2_params = s2s.init_seq2seq_params(s2_cfg, 0, device=dev)
    s2_src = _ints((2 * d_dp, 8), s2_cfg.vocab, 4, dev, low=1)
    s2_tgt = s2_src.flip(1)
    s2_ref = float(s2s.seq2seq_loss_fn(s2_params, (s2_src, s2_tgt), s2_cfg))
    s2_b = pm.NamedSharding(d_mesh, ("dp", None))
    s2_loss = float(s2s.seq2seq_loss_fn(
        pm.device_put(s2_params, s2s.seq2seq_param_shardings(d_mesh,
                                                             s2_params)),
        (pm.device_put(s2_src, s2_b), pm.device_put(s2_tgt, s2_b)), s2_cfg,
        mesh=d_mesh))
    assert abs(s2_loss - s2_ref) < 1e-2 * max(1.0, abs(s2_ref)), (
        f"sharded seq2seq loss {s2_loss} != {s2_ref}")

    coll_note = _collectives_part(n_devices)

    line = (f"dryrun_multichip({n_devices}): mesh dp={dp} sp={sp} tp={tp} "
            f"ep={ep}, 1 train step OK (ring-attn + MoE), loss={lv:.4f}; "
            f"ZeRO-1 dp=2 step OK (dp=2 sp=2 tp=2 ep=1, loss={zlv:.4f}, "
            f"{z_assert}); "
            f"pp={n_stages} GPipe step OK, loss={plv:.4f}; int8 sharded "
            f"decode OK (dp={d_dp}, tp={d_tp}); "
            f"tp-sharded ServingEngine token-identical to solo; "
            f"sharded seq2seq (cross-attention) loss matches unsharded "
            f"(dp={d_dp}, tp={d_tp}); "
            f"checkpoint save/restore bit-equal (mesh + single-device) and "
            f"resumed step bit-identical; {ms_note}; {coll_note}")
    print(line, flush=True)
    return line


def _dryrun_rank(rank: int, n: int, device: str) -> str:
    return dryrun_multichip(n, device=device)


def main(argv=None) -> List[str]:
    """``python -m tpu_dra_driver_torch.entry [N] [--backend nccl|gloo]``:
    ``dryrun_multichip`` on a new group of N processes (default 8), each
    printing its line; returns the lines in rank order. NCCL on the
    cards, one card a rank (``--backend nccl``, the default; raises with
    fewer than N CUDA cards), or gloo on the CPU (``--backend gloo``)."""
    import argparse

    from tpu_dra_driver_torch.workloads.parallel.launch import run_group
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("n", nargs="?", type=int, default=8)
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        default="nccl")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < args.n:
            raise RuntimeError(
                f"the nccl dryrun on {args.n} ranks needs {args.n} CUDA "
                f"cards, found {cards}; pass --backend gloo to run it on "
                f"the CPU")
    store = tempfile.mkdtemp(prefix="dryrun-group-")
    try:
        return run_group(_dryrun_rank, args.n, args.n,
                         "cuda" if args.backend == "nccl" else "cpu",
                         store_dir=store, backend=args.backend, timeout=600)
    finally:
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
