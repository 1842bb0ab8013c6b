"""Collective and matrix-multiply microbenchmarks.

Port of :mod:`tpu_dra_driver.workloads.ops.collectives`:

- ``psum_bandwidth``, ``all_gather_bandwidth``,
  ``reduce_scatter_bandwidth`` and ``all_to_all_bandwidth``: one
  collective over a process group (the world, or the ranks given as
  ``devices``) on a payload of ``mib_per_device``, its algorithm
  bandwidth (payload over time) and its bus bandwidth (times the
  nccl-tests factor: 2 (n - 1) / n for the all-reduce, (n - 1) / n for
  the others); NCCL on the card, gloo on the CPU. The reference lets
  XLA run these over a mesh; here they are ``torch.distributed``'s.
- ``ppermute_latency``: a dependent chain of ring shifts, whose data
  comes home after a multiple of n hops (checked).
- ``matmul_tflops`` and ``matmul_tflops_steady`` time a dependent chain
  of square matrix products (``torch.matmul``, cuBLAS on the card: the
  reference computes its chain outside any Pallas kernel too), and
  ``device_peak_tflops`` gives the published dense bf16 peak of the
  card, the denominator of a utilization.
- ``main``: the in-cluster bench job, which joins the world from the
  torchrun env or the driver's worker env over NCCL (gloo only when
  asked) and prints ``RESULT`` lines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.parallel.spmd import (
    _all_gather_into, _reduce_scatter_into, _shift_nograd,
)
from tpu_dra_driver_torch.workloads.utils.timing import (
    chain_seconds_per_step, time_fn,
)


@dataclass
class BandwidthResult:
    bytes_per_device: int
    median_s: float
    algo_gbps: float          # algorithm bandwidth: payload / time
    bus_gbps: float           # ring-corrected bus bandwidth per device
    backend: str              # the process group's: nccl or gloo

    def __str__(self) -> str:
        return (f"RESULT bandwidth: {self.bus_gbps:.2f} GB/s "
                f"(algo {self.algo_gbps:.2f} GB/s, "
                f"{self.bytes_per_device >> 20} MiB/device, "
                f"t={self.median_s*1e3:.2f} ms, {self.backend})")


def _group(devices: Optional[Sequence] = None):
    """The process group over the ranks ``devices`` (every rank calls
    this with the same list), or the world's."""
    if devices is None or list(devices) == list(range(
            dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(devices))


def _group_device(group) -> torch.device:
    """Where the group's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _outputs(kind: str, x: torch.Tensor, n: int) -> torch.Tensor:
    if kind == "all_gather":
        return x.new_empty(n * x.numel())
    if kind == "reduce_scatter":
        return x.new_empty(x.numel() // n)
    return torch.empty_like(x)


def _run(kind: str, out: torch.Tensor, x: torch.Tensor, group) -> None:
    """One collective of ``kind`` on this rank's [elems] ``x`` into
    ``out``: the sum over ranks (``psum``, in place in ``out``, which the
    caller fills), every rank's ``x`` joined, this rank's block of the
    sum, or block j of ``x`` sent to rank j and rank j's block received
    in place j (``all_to_all``)."""
    if kind == "psum":
        dist.all_reduce(out, group=group)
    elif kind == "all_gather":
        _all_gather_into(out, x, group=group)
    elif kind == "reduce_scatter":
        _reduce_scatter_into(out, x, group=group)
    else:
        dist.all_to_all_single(out, x, group=group)


def collective(kind: str, x: torch.Tensor, devices=None) -> torch.Tensor:
    """The output of one benchmarked collective (``kind`` one of
    ``psum``, ``all_gather``, ``reduce_scatter``, ``all_to_all``) on this
    rank's [elems] ``x``."""
    group = _group(devices)
    out = _outputs(kind, x, dist.get_world_size(group))
    if kind == "psum":
        out.copy_(x)
    _run(kind, out, x, group)
    return out


def _bandwidth_bench(kind, bus_factor, mib_per_device, devices, dtype,
                     iters, divisible=False) -> BandwidthResult:
    """Shared scaffold: the group, [elems] ones on its device, the
    collective timed, algo and bus GB/s."""
    group = _group(devices)
    n = dist.get_world_size(group)
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = (mib_per_device << 20) // itemsize
    if divisible:
        elems -= elems % n
    x = torch.ones(elems, dtype=dtype, device=_group_device(group))
    out = _outputs(kind, x, n)
    if kind == "psum":
        out.copy_(x)
    timed = time_fn(lambda: _run(kind, out, x, group), warmup=2,
                    iters=iters)
    payload = elems * itemsize
    algo = payload / timed.median_s / 1e9
    return BandwidthResult(payload, timed.median_s, algo,
                           algo * bus_factor(n), dist.get_backend(group))


def psum_bandwidth(mib_per_device: int = 64,
                   devices: Optional[Sequence] = None,
                   dtype=torch.float32, iters: int = 5) -> BandwidthResult:
    """All-reduce bandwidth; bus bandwidth by the ring all-reduce factor
    2 (n - 1) / n, as nccl-tests report it."""
    return _bandwidth_bench("psum", lambda n: 2 * (n - 1) / n,
                            mib_per_device, devices, dtype, iters)


def all_gather_bandwidth(mib_per_device: int = 64,
                         devices: Optional[Sequence] = None,
                         dtype=torch.float32,
                         iters: int = 5) -> BandwidthResult:
    return _bandwidth_bench("all_gather", lambda n: (n - 1) / n,
                            mib_per_device, devices, dtype, iters)


def reduce_scatter_bandwidth(mib_per_device: int = 64,
                             devices: Optional[Sequence] = None,
                             dtype=torch.float32,
                             iters: int = 5) -> BandwidthResult:
    """Reduce-scatter bandwidth, the collective behind ZeRO's sharded
    gradient sync; bus factor (n - 1) / n."""
    return _bandwidth_bench("reduce_scatter", lambda n: (n - 1) / n,
                            mib_per_device, devices, dtype, iters,
                            divisible=True)


def all_to_all_bandwidth(mib_per_device: int = 64,
                         devices: Optional[Sequence] = None,
                         dtype=torch.float32,
                         iters: int = 5) -> BandwidthResult:
    """All-to-all bandwidth, the collective behind Ulysses sequence
    parallelism and MoE dispatch; each rank sends (n - 1) / n of its
    payload."""
    return _bandwidth_bench("all_to_all", lambda n: (n - 1) / n,
                            mib_per_device, devices, dtype, iters,
                            divisible=True)


@dataclass
class LatencyResult:
    hops: int
    per_hop_us: float
    backend: str

    def __str__(self) -> str:
        return (f"RESULT ppermute latency: {self.per_hop_us:.1f} us/hop "
                f"({self.hops} chained ring hops, {self.backend})")


def ppermute_latency(hops: int = 64, elems: int = 1024,
                     devices: Optional[Sequence] = None,
                     iters: int = 5) -> LatencyResult:
    """Latency of a small-message ring shift (the ring-attention hop),
    timed as a dependent chain of ``hops`` shifts. Rank r holds row r of
    ``arange(n * elems)``; after a multiple of n hops the data is home
    again, which is asserted. With one rank the shift is the identity
    and nothing is sent."""
    group = _group(devices)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    x = torch.arange(n * elems, dtype=torch.float32).reshape(n, elems)[me]
    x = x.to(_group_device(group))

    def ring():
        z = x
        for _ in range(hops if n > 1 else 0):
            z, = _shift_nograd([z], group, 1)
        return z

    out = ring()
    if hops % n == 0:
        np.testing.assert_array_equal(out.cpu().numpy(), x.cpu().numpy())
    timed = time_fn(ring, warmup=2, iters=iters)
    return LatencyResult(hops, timed.median_s / hops * 1e6,
                         dist.get_backend(group))


@dataclass
class MatmulResult:
    m: int
    median_s: float
    tflops: float

    def __str__(self) -> str:
        return f"RESULT matmul: {self.tflops:.2f} TFLOP/s (m={self.m}, t={self.median_s*1e3:.2f} ms)"


def _operands(m: int, dtype, device):
    """a = N(0, 1) and b = the same draws / sqrt(m), both [m, m] from
    seed 0 (the reference draws both from one key), so x @ b keeps the
    chain's scale."""
    dev = resolve_device(device)
    x = torch.randn((m, m), generator=torch.Generator().manual_seed(0))
    a = x.to(dev, dtype)
    return a, a * (1.0 / m ** 0.5)


def _chain(a, b, n: int, dtype):
    def run():
        x = a
        for _ in range(n):
            x = (x @ b).to(dtype)
        return x
    return run


def matmul_tflops(m: int = 4096, dtype=torch.bfloat16, iters: int = 5,
                  chain: int = 16, device="cuda") -> MatmulResult:
    """Square matrix-product throughput: the median wall time of a
    dependent chain of ``chain`` products, each ending when the card is
    idle."""
    a, b = _operands(m, dtype, device)
    timed = time_fn(_chain(a, b, chain, dtype), warmup=2, iters=iters)
    flops = 2 * m * m * m * chain
    return MatmulResult(m, timed.median_s, flops / timed.median_s / 1e12)


def matmul_tflops_steady(m: int = 8192, dtype=torch.bfloat16,
                         iters: int = 3, device="cuda") -> MatmulResult:
    """Steady-state matrix-product throughput: seconds per product from
    :func:`chain_seconds_per_step` over chains of 16 and 64 (the
    device-busy time of the long chain on the card, the marginal rate
    without one)."""
    a, b = _operands(m, dtype, device)
    per = chain_seconds_per_step(lambda n: _chain(a, b, n, dtype), 16, 64,
                                 iters)
    return MatmulResult(m, per, 2 * m * m * m / per / 1e12)


# Published dense bf16 peak TFLOP/s (NVIDIA's data sheets, without
# sparsity), keyed by a substring of torch.cuda.get_device_name(); the
# first match wins, so a PCIe card is matched before the generic H100
# (the SXM part)
_PEAK_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100", 989.0),
)


def device_peak_tflops() -> Optional[float]:
    """Peak dense bf16 TFLOP/s of the current CUDA card from its name,
    or None where there is no CUDA card or the name is unknown."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name().lower()
    for pat, peak in _PEAK_TFLOPS:
        if pat in name:
            return peak
    return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point of the in-cluster collective bench job: joins the
    world from the torchrun env (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``), or else from the driver-injected worker env
    (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID`` and, for multislice,
    ``MEGASCALE_*``: process id = slice id * hosts per slice + worker
    id, the coordinator worker 0 of the list or
    ``MEGASCALE_COORDINATOR_ADDRESS``), or runs alone. NCCL on the card
    (``--backend nccl``, the default, raises without CUDA) or gloo on
    the CPU (``--backend gloo``). Prints the RESULT lines, each naming
    the backend."""
    import argparse
    import os

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        default="nccl")
    backend = parser.parse_args(argv).backend
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl bench needs a CUDA card; pass "
                               "--backend gloo to run it on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    hosts = [h for h in
             os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    worker_id = os.environ.get("TPU_WORKER_ID")
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    slice_id = int(os.environ.get("MEGASCALE_SLICE_ID", "0"))
    world = len(hosts) * num_slices
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    elif world > 1 and worker_id is not None:
        port = os.environ.get("MASTER_PORT", "8476")
        coord = os.environ.get("MEGASCALE_COORDINATOR_ADDRESS")
        host = coord.rsplit(":", 1)[0] if coord else hosts[0]
        dist.init_process_group(
            backend, init_method=f"tcp://{host}:{port}", world_size=world,
            rank=slice_id * len(hosts) + int(worker_id))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        print(psum_bandwidth(), flush=True)
        print(all_gather_bandwidth(), flush=True)
        print(reduce_scatter_bandwidth(), flush=True)
        print(all_to_all_bandwidth(), flush=True)
        print(ppermute_latency(), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
