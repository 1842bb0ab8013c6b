"""One decode step, replayed as a CUDA graph.

The reference runs each decode loop as one compiled program (a
``lax.scan`` in ``paged_decode_steps`` and ``_generate``); the port's
counterpart is a CUDA graph of one step, replayed once per step, so
that the host issues one launch where eager PyTorch issues every kernel.

A step body is a function of no arguments that reads its inputs (the
position, the token, the lengths) from device tensors and updates them
in place, so that each run of it is the next step. :class:`StepGraph`
runs it once per call: on the CPU eagerly, on the card by replaying one
capture. The body must not read a device value on the host, which would
make the capture fail.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional

import torch

from tpu_dra_driver_torch.workloads.ops import attention as _attention
from tpu_dra_driver_torch.workloads.ops import decode_attention as _decode
from tpu_dra_driver_torch.workloads.ops import paged_attention as _paged

# the kernel wrappers whose ``launches`` count what the card ran
_COUNTED = (_attention.flash_forward, _attention.flash_backward_dq,
            _attention.flash_backward_dkv, _decode.flash_decode_attention,
            _paged.paged_decode_attention)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``device`` on which every StepGraph warms
    up and captures: cuBLAS keeps a workspace for every stream it has run
    on, for the life of the process."""
    return torch.cuda.Stream(device)


class StepGraph:
    """Runs ``body`` once per call and returns what it returned.

    CPU: every call runs the body. CUDA: the first call runs it eagerly
    on the device's side stream (the warm-up, a real step that also
    builds the kernels and allocates cuBLAS's workspace for that
    stream); the second captures it into a CUDA graph and replays that,
    and every later call replays it. Capture records and does not run,
    so the warm-up's effects are exactly one step's and each call, the
    second included, makes one step. The values returned after the
    warm-up are the graph's static outputs, overwritten by every replay.

    The capture takes no host wait (``capture_begin`` on the side
    stream, without ``torch.cuda.graph``'s synchronize and
    ``empty_cache``); its memory comes from ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` that graphs which never run at
    the same time may share) or a private pool, and lives as long as
    the graph. A ``generator`` the body draws from is registered with
    the graph, which gives each replay fresh numbers. A failed capture
    or replay raises; nothing falls back to the eager body.

    Kernel wrappers count a launch per Python call, so the capture's own
    calls, which ran nothing, are taken back out of their ``launches``,
    and each replay adds what the capture recorded. The class counts
    every capture in ``captures`` and its host seconds in
    ``capture_seconds``."""

    captures = 0
    capture_seconds = 0.0

    def __init__(self, body: Callable[[], Any], device,
                 pool=None, generator: Optional[torch.Generator] = None):
        self.body = body
        self.cuda = torch.device(device).type == "cuda"
        self.pool = pool
        self.generator = generator
        self.stream = _side_stream(torch.device(device)) if self.cuda \
            else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm = False
        self.out: Any = None
        self._per_replay: tuple = ()

    def __call__(self) -> Any:
        if not self.cuda:
            return self.body()
        if not self.warm:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                out = self.body()
            torch.cuda.current_stream().wait_stream(self.stream)
            self.warm = True
            return out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for fn, n in self._per_replay:
            fn.launches += n
        return self.out

    def _capture(self) -> None:
        start = time.perf_counter()
        before = [fn.launches for fn in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            graph.capture_begin(*(() if self.pool is None else (self.pool,)))
            try:
                self.out = self.body()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        self._per_replay = tuple((fn, fn.launches - n)
                                 for fn, n in zip(_COUNTED, before)
                                 if fn.launches != n)
        for fn, n in zip(_COUNTED, before):
            fn.launches = n
        self.graph = graph
        StepGraph.captures += 1
        StepGraph.capture_seconds += time.perf_counter() - start
