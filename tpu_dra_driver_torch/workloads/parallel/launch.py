"""Run a function on every rank of a new process group.

The multi-rank half of the port runs as one process per rank, on the
CPU (``gloo``) or one card a rank (``nccl``, rank r on card r).
:func:`run_group` starts them: each child joins the group through a
:class:`torch.distributed.FileStore` in ``store_dir``, so two groups
never contend for a port, runs ``fn(rank, *args)`` with one thread, and
leaves its result in ``store_dir``; the parent waits at most
``timeout`` seconds, kills the group when it expires, and raises when
any rank failed or hung.
"""

from __future__ import annotations

import datetime
import os
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, world: int, backend: str, store_dir: str,
           timeout: float, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    out = os.path.join(store_dir, f"rank{rank}.pt")
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_group(fn: Callable, world: int, *args, store_dir: str,
              backend: str = "gloo", timeout: float = 120.0) -> List:
    """``fn(rank, *args)`` on each of ``world`` new processes joined in
    one process group; returns the ranks' results in rank order. ``fn``
    and its arguments must be picklable (a module-level function: the
    children import its module by name)."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        r, world, backend, store_dir, timeout, fn, args), daemon=True)
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} did not finish within "
                           f"{timeout} s; the group was killed")
    results, errors = [], []
    for r in range(world):
        path = os.path.join(store_dir, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) \
            if os.path.exists(path) else {"error": "no result"}
        if "error" in got:
            errors.append(f"rank {r}: {got['error']}")
        results.append(got.get("ok"))
    if errors:
        raise RuntimeError("the group failed:\n" + "\n".join(errors))
    return results
