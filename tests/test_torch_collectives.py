"""The port's collectives and meshes across gloo processes on the CPU.

Each world size runs once, as one group of spawned processes
(:func:`..parallel.launch.run_group`: a ``FileStore`` in ``tmp_path``,
a timeout at the parent's join and in ``init_process_group``, the group
killed on expiry), and every check reads that run's results:

- each benchmarked collective's output against the numpy reduction of
  every rank's input;
- the bus/algo ratio of each bandwidth result against the nccl-tests
  factors, 2 (n - 1) / n and (n - 1) / n, as the reference's dryrun
  asserts them;
- ``ppermute_latency``'s data home after n hops (asserted inside it);
- ``build_mesh`` and ``build_mesh_spmd`` over the group: the reference's
  factorization, and each rank's coordinates in rank order;
- the differentiable collectives of the sharded step against their
  definitions, values and gradients;
- the bench job's ``main`` as its own process over gloo, alone and
  from a torchrun-style env of one rank, printing the five RESULT lines
  with the backend named; without ``--backend`` it takes NCCL and
  refuses to run on a host without CUDA.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_dra_driver_torch.workloads.ops import collectives as co
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import spmd

WORLDS = (2, 4)
KINDS = ("psum", "all_gather", "reduce_scatter", "all_to_all")
BENCHES = {"psum": co.psum_bandwidth,
           "all_gather": co.all_gather_bandwidth,
           "reduce_scatter": co.reduce_scatter_bandwidth,
           "all_to_all": co.all_to_all_bandwidth}
ELEMS = 24
TIMEOUT = 120


def _rank_input(rank: int) -> np.ndarray:
    return (np.arange(ELEMS, dtype=np.float32) + 100 * rank) ** 1.5


def _child(rank: int) -> dict:
    n = dist.get_world_size()
    out = {"values": {k: co.collective(k, torch.from_numpy(
        _rank_input(rank))).numpy() for k in KINDS}}
    out["bench"] = {k: fn(mib_per_device=1, iters=2)
                    for k, fn in BENCHES.items()}
    out["latency"] = co.ppermute_latency(hops=2 * n, elems=64, iters=2)
    m = tm.build_mesh_spmd(device_type="cpu")
    out["spmd"] = (tuple(m.shape), m.mesh_dim_names,
                   [spmd.axis_index(m, a) for a in m.mesh_dim_names])
    m2 = tm.build_mesh(device_type="cpu")
    out["dptp"] = (tuple(m2.shape), m2.mesh_dim_names)
    # the differentiable collectives, on a [2 n, 3] tensor per rank, each
    # rank's output weighted by (rank + 2) in its loss
    x = torch.arange(6 * n, dtype=torch.float64).reshape(2 * n, 3) \
        * (rank + 1)
    x.requires_grad_(True)
    flat = tm.build_mesh_spmd(dp=1, sp=n, tp=1, ep=1, device_type="cpu")
    grads = {}
    for name, fn in {
            "psum": lambda z: spmd.psum(z, flat, ("sp",)),
            "all_gather": lambda z: spmd.all_gather(z, flat, "sp", 1),
            "all_to_all": lambda z: spmd.all_to_all(z, flat, "sp", 0, 1),
    }.items():
        y = fn(x)
        g, = torch.autograd.grad((y * (rank + 2)).sum(), x)
        grads[name] = (y.detach().numpy(), g.numpy())
    out["autograd"] = grads
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: launch.run_group(
        _child, n, store_dir=str(tmp_path_factory.mktemp(f"world{n}")),
        timeout=TIMEOUT) for n in WORLDS}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", KINDS)
def test_collective_values_match_numpy(runs, n, kind):
    inputs = np.stack([_rank_input(r) for r in range(n)])
    for rank, res in enumerate(runs[n]):
        got = res["values"][kind]
        if kind == "psum":
            want = inputs.sum(0)
        elif kind == "all_gather":
            want = inputs.reshape(-1)
        elif kind == "reduce_scatter":
            want = inputs.sum(0).reshape(n, -1)[rank]
        else:
            want = inputs.reshape(n, n, -1)[:, rank].reshape(-1)
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", KINDS)
def test_bus_factor_is_the_nccl_tests_factor(runs, n, kind):
    factor = 2 * (n - 1) / n if kind == "psum" else (n - 1) / n
    for res in runs[n]:
        r = res["bench"][kind]
        assert r.algo_gbps > 0
        assert r.bus_gbps / r.algo_gbps == pytest.approx(factor, rel=1e-12)
        assert r.bytes_per_device == 1 << 20
        assert str(r).startswith("RESULT bandwidth: ")
        assert str(r).endswith(", gloo)")


@pytest.mark.parametrize("n", WORLDS)
def test_ppermute_latency_data_comes_home(runs, n):
    for res in runs[n]:
        lat = res["latency"]
        assert lat.hops == 2 * n and lat.per_hop_us > 0
        assert str(lat).startswith("RESULT ppermute latency: ")
        assert str(lat).endswith(", gloo)")


@pytest.mark.parametrize("n", WORLDS)
def test_meshes_over_the_group(runs, n):
    want = tm.mesh_shape_spmd(n)
    coords = []
    for rank, res in enumerate(runs[n]):
        shape, names, coord = res["spmd"]
        assert shape == want and names == ("dp", "sp", "tp", "ep")
        coords.append(coord)
        assert res["dptp"] == (tm.mesh_shape(n), ("dp", "tp"))
    # ranks fill the mesh in row-major order, ep fastest
    assert coords == [list(np.unravel_index(r, want)) for r in range(n)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ["psum", "all_gather", "all_to_all"])
def test_differentiable_collectives(runs, n, name):
    xs = [np.arange(6 * n, dtype=np.float64).reshape(2 * n, 3) * (r + 1)
          for r in range(n)]
    for rank, res in enumerate(runs[n]):
        y, g = res["autograd"][name]
        # forward: the collective's definition
        if name == "psum":
            want = sum(xs)
        elif name == "all_gather":
            want = np.concatenate(xs, axis=1)
        else:
            want = np.concatenate([x.reshape(n, 2, 3)[rank] for x in xs],
                                  axis=1)
        np.testing.assert_array_equal(y, want)
        # backward: each rank's output weighted by (rank + 2), so x's
        # gradient is the transpose's sum of those weights
        if name in ("psum", "all_gather"):
            want_g = np.full_like(xs[0], sum(r + 2 for r in range(n)))
        else:
            want_g = np.concatenate(
                [np.full((2, 3), r + 2.0) for r in range(n)], axis=0)
        np.testing.assert_array_equal(g, want_g)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _bench_job(*args, env_update=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID")}
    env.update(env_update or {})
    return subprocess.run(
        [sys.executable, "-m", "tpu_dra_driver_torch.workloads.ops.collectives",
         *args], env=env, capture_output=True, text=True, timeout=TIMEOUT)


@pytest.mark.parametrize("how", ["alone", "torchrun-env"])
def test_main_prints_the_result_lines(how):
    env = None
    if how == "torchrun-env":
        env = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()))
    run = _bench_job("--backend", "gloo", env_update=env)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = [x for x in run.stdout.splitlines() if x.startswith("RESULT")]
    assert len(lines) == 5
    assert all("bandwidth: 0.00 GB/s" in x for x in lines[:4])
    assert lines[4].startswith("RESULT ppermute latency: ")
    assert all(x.endswith(", gloo)") for x in lines)


def test_main_takes_nccl_by_default_and_refuses_without_cuda():
    run = _bench_job(env_update={"CUDA_VISIBLE_DEVICES": ""})
    assert run.returncode != 0
    assert "the nccl bench needs a CUDA card" in run.stderr
    assert "RESULT" not in run.stdout
