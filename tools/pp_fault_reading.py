#!/usr/bin/env python3
"""Phase 28's four-microbatch check of ``chip_smoke.py`` run against
faults put into the GPipe schedule: where its limits sit between a sound
run and a broken one.

Each fault wraps ``pipeline._GPipe`` for one run of
``chip_smoke.pipeline_phase(card, micro=(4,))`` and is taken off again
(the package's source is not changed):

- ``last microbatch only``: the backward gets the cotangent of the last
  microbatch's output alone, so the stages' gradients and the input
  gradients of the first three microbatches are dropped (the tied
  unembed still sees the whole batch): a step that trains the blocks on
  a quarter of the batch;
- ``outputs one slot on``: microbatch i's output lands in slot i + 1
  (mod 4), and its cotangent is read back from there: each output is
  scored against another microbatch's targets.

The phase prints its readings (the losses' largest relative difference
and the params' update difference, each beside its limit) and must fail
under each fault; the script exits 1 when a fault passed the check.
Needs one CUDA card; from the repo root: ``python3 tools/pp_fault_reading.py``.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from tpu_dra_driver_torch.workloads.parallel import pipeline as pp  # noqa: E402,E501


def _last_only(forward, backward):
    def bwd(ctx, dout):
        dout = dout.clone()
        dout[:-1] = 0
        return backward(ctx, dout)
    return forward, bwd


def _slot_on(forward, backward):
    def fwd(ctx, *args):
        return forward(ctx, *args).roll(1, 0)

    def bwd(ctx, dout):
        return backward(ctx, dout.roll(-1, 0))
    return fwd, bwd


FAULTS = {"last microbatch only": _last_only,
          "outputs one slot on": _slot_on}


def main() -> int:
    if not torch.cuda.is_available():
        print("pp_fault_reading: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    path, seconds, _ = cs._build.build("flash_attention")
    print(f"{path.name}: nvcc {seconds:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs._card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    forward, backward = pp._GPipe.forward, pp._GPipe.backward
    missed = []
    try:
        for name, fault in FAULTS.items():
            cs.phase(f"phase 28 at 4 microbatches, fault: {name}")
            fwd, bwd = fault(forward, backward)
            pp._GPipe.forward = staticmethod(fwd)
            pp._GPipe.backward = staticmethod(bwd)
            try:
                cs.pipeline_phase(smi, micro=(4,))
            except AssertionError as e:
                print(f"caught: {e}", flush=True)
            else:
                print("NOT caught: the check passed", flush=True)
                missed.append(name)
            finally:
                pp._GPipe.forward = staticmethod(forward)
                pp._GPipe.backward = staticmethod(backward)
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"faults caught {len(FAULTS) - len(missed)} of {len(FAULTS)}"
          + (f"; missed: {missed}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
