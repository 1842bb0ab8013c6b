"""Matrix-multiply throughput and the card's peak: the single-device part
of :mod:`tpu_dra_driver.workloads.ops.collectives`.

``matmul_tflops`` and ``matmul_tflops_steady`` time a dependent chain of
square matrix products (``torch.matmul``, cuBLAS on the card: the
reference computes its chain outside any Pallas kernel too), and
``device_peak_tflops`` gives the published dense bf16 peak of the card,
the denominator of a utilization.

The collectives of the reference module (psum, all-gather,
reduce-scatter, all-to-all and ppermute bandwidths, and its ``main``
bench job) run over several devices and wait for the port's multi-GPU
tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.utils.timing import (
    chain_seconds_per_step, time_fn,
)


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
