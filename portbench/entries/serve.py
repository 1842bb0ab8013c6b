"""Serving: the port's ``ServingEngine`` under a closed backlog. Every
row that frees takes the next request (``add``), and ``step_chunk``
decodes all rows in chunks of up to 32 steps.

Set-up makes the weights, admits the first wave (requests that carry a
share of their outputs in their prompts, so that the window opens with
rows at every stage) and runs the first chunk, which captures the decode
step's graph for the block bucket the window uses. A token reaches the
host when ``add`` returns (a request's first) or at the end of the chunk
that made it.

Compared: a sample of the finished requests drawn from the seed, the
longest among them; the reference runs once over each prompt with its
served tokens, and the number is the mean, over every served token, of
the square of the gap by which its reference logit lies below the
reference's best. (The widest gap, logged, does not separate the int8
control from sound runs by three times; the mean square does.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench import harness, traffic, weights
from portbench.reference import starcoder2 as ref


@dataclass
class Record:
    prompt_len: int
    t_first: float
    n_recv: int = 1           # tokens that reached the host
    n_window: int = 0         # of them, in the window
    t_done: float = 0.0


def model_config(run: harness.Run):
    from tpu_dra_driver_torch.workloads.models.transformer import ModelConfig
    s = run.shape
    return ModelConfig(vocab=s.vocab, d_model=s.d_model, n_heads=s.n_heads,
                       n_layers=s.n_layers, d_ff=s.d_ff,
                       max_seq=run.mix["max_context"], dtype=torch.bfloat16,
                       n_kv_heads=s.n_kv_heads, use_rope=True)


def served_gaps(run: harness.Run, seqs: List[np.ndarray],
                prompt_lens: List[int]) -> Dict:
    """The reference once over each whole sequence, and the gaps of its
    served tokens (how far each one's reference logit lies below the
    reference's best): the mean of their squares over every served
    token, which the check compares, their mean and the widest."""
    ref.strict_f32()
    params = weights.make_params(run.shape, run.seed, run.device,
                                 as_dtype=torch.float32)
    total, squares, widest, n, flips, every = 0.0, 0.0, 0.0, 0, 0, []
    for seq, p0 in zip(seqs, prompt_lens):
        toks = torch.as_tensor(seq, device=run.device)[None]
        lg = ref.logits(params, toks[:, :-1], run.shape)[0, p0 - 1:]
        gaps = harness.logit_gap(lg, toks[0, p0:])
        total += float(gaps.sum())
        squares += float((gaps * gaps).sum())
        widest = max(widest, float(gaps.max()))
        n += gaps.numel()
        flips += int((gaps > 0).sum())
        every.append(gaps.cpu().numpy())
        del lg
    run.log(f"served tokens {n}: mean gap {total / n!r}, mean square "
            f"{squares / n!r}, widest {widest!r}, {flips} not the "
            f"reference's best")
    return {"msq_gap": squares / n, "tokens": n, "gaps": every}


def sample(rng: np.random.Generator, done: Dict[int, int], k: int
           ) -> List[int]:
    """``k`` finished requests drawn from the seed, the one with the most
    served tokens among them."""
    rids = sorted(done)
    longest = max(rids, key=lambda r: done[r])
    rest = [r for r in rids if r != longest]
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)),
                        replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(picked)]


def run(run: harness.Run) -> harness.Outcome:
    from tpu_dra_driver_torch.workloads.models.serving import ServingEngine

    s, p, dev, mix = run.shape, run.params, run.device, run.mix
    cfg = model_config(run)
    params = weights.make_params(s, run.seed, dev)
    if p.get("weights") == "int8":      # the control: the int8 path
        from tpu_dra_driver_torch.workloads.models.quantize import (
            quantize_params,
        )
        params = quantize_params(params)
    reqs = traffic.backlog(mix, run.seed, s.vocab)
    rows, per_seq, block_t = (p["max_batch"], p["max_blocks_per_seq"],
                              p["block_t"])

    # the window's prompts are prefilled at the powers of two the engine
    # buckets them to: warm each on a one-row engine of its own
    window_lens = {len(r.prompt) for r in reqs[mix["first_wave"]:]}
    classes = sorted({1 << (n - 1).bit_length() for n in window_lens})
    warm = ServingEngine(params, cfg, n_blocks=1 + per_seq, block_t=block_t,
                         max_batch=1, max_blocks_per_seq=per_seq, device=dev)
    for c in classes:
        n = max(x for x in window_lens if 1 << (x - 1).bit_length() == c)
        warm.add(list(range(n)), 1)
    del warm

    eng = ServingEngine(params, cfg, n_blocks=1 + rows * per_seq,
                        block_t=block_t, max_batch=rows,
                        max_blocks_per_seq=per_seq, device=dev)
    recs: Dict[int, Record] = {}
    prompts: Dict[int, np.ndarray] = {}
    nxt = 0
    failed = 0

    def admit(in_window: bool) -> None:
        nonlocal nxt, failed
        while nxt < len(reqs) and len(recs) - len(eng.finished) < rows:
            r = reqs[nxt]
            nxt += 1
            try:
                with run.spans("admit"):
                    rid = eng.add(r.prompt.tolist(), r.max_new)
            except RuntimeError as e:
                run.log(f"request {nxt - 1} refused: {e}")
                failed += 1
                continue
            recs[rid] = Record(len(r.prompt), time.perf_counter(),
                               n_window=int(in_window))
            prompts[rid] = r.prompt

    traced: List[int] = []       # keys each traced decode step read, a row
    window_ctx = [0, 0]          # decode tokens in the window, their keys

    def chunk(in_window: bool, record: bool = False) -> int:
        active = [(rid, rec) for rid, rec in recs.items()
                  if rid not in eng.finished]
        before = {rid: rec.n_recv for rid, rec in active}
        with run.spans("chunk"):
            out = eng.step_chunk(32)
        t = time.perf_counter()
        n = 0
        for rid, toks in out.items():
            rec = recs[rid]
            # step j of the chunk reads prompt + tokens so far + j keys
            l0 = rec.prompt_len + before[rid]
            keys = [l0 + j for j in range(len(toks))]
            if record:
                traced.extend(keys)
            if in_window:
                window_ctx[0] += len(keys)
                window_ctx[1] += sum(keys)
            rec.n_recv += len(toks)
            rec.n_window += len(toks) if in_window else 0
            n += len(toks)
            if rid in eng.finished:
                rec.t_done = t
        return n

    admit(False)
    chunk(False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.t_begin
    run.log(f"setup_s {setup_s:.3f}")

    from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph
    captures = StepGraph.captures
    tokens = 0
    with harness.steady_host():
        t_open = time.perf_counter()
        finished_before = set(eng.finished)
        admitted_before = len(recs)
        while time.perf_counter() - t_open < run.seconds:
            n0 = len(recs)
            admit(True)
            tokens += len(recs) - n0
            tokens += chunk(True)
        window_s = time.perf_counter() - t_open
    done = [rid for rid in eng.finished if rid not in finished_before]
    admitted = len(recs) - admitted_before
    if StepGraph.captures != captures:
        run.log(f"warning: {StepGraph.captures - captures} graph captures "
                f"inside the window")
    # the traced stretch comes after the window, on the same engine
    tracer = harness.Tracer(run.trace)
    tracer.start()
    while tracer.active and time.perf_counter() - tracer.t0 \
            < p["trace_seconds"]:
        admit(False)
        chunk(False, record=True)
    tracer.stop()
    peak = harness.memory_peak(dev)

    tpots = []
    for rid in done:
        rec = recs[rid]
        if rec.t_first >= t_open:
            tpots.append((rec.t_done - rec.t_first) / max(1, rec.n_recv - 1))
        else:
            tpots.append((rec.t_done - t_open) / max(1, rec.n_window))
    tpots.sort()
    run.log(f"window: {tokens} tokens in {window_s:.3f} s, "
            f"{len(done)} requests finished, "
            f"{admitted} admitted, peak "
            f"{peak / 2**30:.2f} GiB")
    tpot_p90 = float(np.quantile(np.asarray(tpots), 0.9)) * 1e3 \
        if tpots else float("nan")

    served = {rid: len(toks) for rid, toks in eng.finished.items()}
    picked = sample(traffic.rng(run.seed, 2), served, p["check_requests"])
    seqs = [np.concatenate([prompts[rid], np.asarray(eng.finished[rid],
                                                     np.int32)])
            for rid in picked]
    lens = [len(prompts[rid]) for rid in picked]
    del eng, params
    harness.free_device(dev)
    t_ref = time.perf_counter()
    g = served_gaps(run, seqs, lens)
    run.log(f"reference: {g['tokens']} served tokens of {len(seqs)} "
            f"requests in {time.perf_counter() - t_ref:.1f} s")
    return harness.Outcome(
        e2e={"setup_s": setup_s, "out_tokens_per_s": tokens / window_s,
             "tpot_p90_ms": tpot_p90},
        attempted=len(recs), failed=failed, memory_peak_bytes=peak,
        checks={"msq_gap": (g["msq_gap"], run.cell["limits"]["msq_gap"])},
        counters={"traced_contexts": traced, "window_s": window_s,
                  "window_since": t_open,
                  "window_decode_tokens": window_ctx[0],
                  "window_decode_keys": window_ctx[1],
                  "gaps": g["gaps"]},
        trace=tracer.result)
