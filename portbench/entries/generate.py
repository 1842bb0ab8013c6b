"""Offline generation: the port's ``generate`` over whole batches, greedy,
one call after another, each call on fresh prompts. Set-up makes the
weights and runs one short call at the cell's prompt shape and cache
length, which loads every kernel. Each call's tokens reach the host when
it returns; only whole calls count.

With ``--trace 1`` the profiler covers a stretch of decode replays in
the first call of the window (a whole call launches millions of
kernels): the harness counts the replays of ``torch.cuda.CUDAGraph`` and
starts and stops the profiler between two of them.

Compared: rows drawn from the seed over all calls; the reference runs
once over each prompt with its generated tokens, and the number is the
mean square of the gaps by which the generated tokens' reference logits
lie below the reference's best (as in ``serve``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness, traffic, weights
from portbench.entries.serve import served_gaps


def model_config(run: harness.Run):
    from tpu_dra_driver_torch.workloads.models.transformer import ModelConfig
    s, mix = run.shape, run.mix
    return ModelConfig(vocab=s.vocab, d_model=s.d_model, n_heads=s.n_heads,
                       n_layers=s.n_layers, d_ff=s.d_ff,
                       max_seq=mix["prompt"] + mix["output"],
                       dtype=torch.bfloat16, n_kv_heads=s.n_kv_heads,
                       use_rope=True)


@contextlib.contextmanager
def traced_replays(tracer: harness.Tracer, first: int, last: int,
                   seen: List[int]):
    """Start ``tracer`` before graph replay ``first`` and stop it after
    replay ``last`` (counted from 0 inside the block); ``seen`` gets the
    replays' numbers that were traced."""
    cls = torch.cuda.CUDAGraph
    original = cls.replay
    count = [0]

    def replay(self):
        i = count[0]
        count[0] += 1
        if i == first:
            tracer.start()
        original(self)
        if tracer.active:
            seen.append(i)
        if i == last:
            tracer.stop()

    cls.replay = replay
    try:
        yield
    finally:
        cls.replay = original
        tracer.stop()


def run(run: harness.Run) -> harness.Outcome:
    from tpu_dra_driver_torch.workloads.models.generate import generate

    s, p, dev, mix = run.shape, run.params, run.device, run.mix
    cfg = model_config(run)
    rows, t0, steps = mix["rows"], mix["prompt"], mix["output"]
    params = weights.make_params(s, run.seed, dev)
    if p.get("weights") == "int8":      # the control: the int8 path
        from tpu_dra_driver_torch.workloads.models.quantize import (
            quantize_params,
        )
        params = quantize_params(params)

    def call(i: int) -> np.ndarray:
        prompt = torch.as_tensor(
            traffic.batch_prompts(mix, run.seed, i, s.vocab), device=dev)
        with run.spans("gen_call"):
            return generate(params, cfg, prompt, steps=steps).cpu().numpy()

    warm = torch.as_tensor(traffic.batch_prompts(mix, run.seed, -1, s.vocab),
                           device=dev)
    generate(params, cfg, warm, steps=3, max_t=t0 + steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.t_begin
    run.log(f"setup_s {setup_s:.3f}")

    outs: Dict[int, np.ndarray] = {}
    with harness.steady_host():
        t_open = time.perf_counter()
        while not outs or time.perf_counter() - t_open < run.seconds:
            outs[len(outs)] = call(len(outs))
        window_s = time.perf_counter() - t_open
    n_calls = len(outs)
    # the traced stretch: decode replays of one more call, after the window
    # the traced replays run inside a gen_call span opened before the
    # profile starts
    tracer = harness.Tracer(run.trace, outside="gen_call")
    seen: List[int] = []
    if run.trace:
        first = p["trace_from_step"]
        with traced_replays(tracer, first, first + p["trace_steps"] - 1,
                            seen):
            call(n_calls)
    peak = harness.memory_peak(dev)
    tokens = n_calls * rows * steps
    run.log(f"window: {n_calls} calls, {tokens} tokens in {window_s:.3f} s, "
            f"peak {peak / 2**30:.2f} GiB")

    # every generated token of a call reads t0 + 1 .. t0 + steps - 1 keys
    # (the first comes from the prefill); a replay's step reads the keys
    # of its position
    window_keys = n_calls * rows * sum(range(t0 + 1, t0 + steps))
    traced_keys = [t0 + 2 + i for i in seen for _ in range(rows)]

    g = traffic.rng(run.seed, 2)
    k = min(p["check_rows"], rows)
    picks = [(int(c), int(r)) for c, r in zip(
        g.integers(0, n_calls, k), g.choice(rows, k, replace=False))]
    seqs = [outs[c][r] for c, r in picks]
    del params, outs
    harness.free_device(dev)
    t_ref = time.perf_counter()
    gaps = served_gaps(run, seqs, [t0] * len(seqs))
    run.log(f"reference: {gaps['tokens']} tokens of {len(seqs)} rows in "
            f"{time.perf_counter() - t_ref:.1f} s")
    return harness.Outcome(
        e2e={"setup_s": setup_s, "gen_tokens_per_s": tokens / window_s},
        attempted=n_calls * rows, failed=0, memory_peak_bytes=peak,
        checks={"msq_gap": (gaps["msq_gap"],
                            run.cell["limits"]["msq_gap"])},
        counters={"traced_contexts": traced_keys, "window_s": window_s,
                  "window_decode_tokens": n_calls * rows * (steps - 1),
                  "window_decode_keys": window_keys,
                  "gaps": gaps["gaps"]},
        trace=tracer.result)
