"""Training: the port's ``make_train_step`` with AdamW and the flash
kernels, one step after another on fresh packed batches.

Set-up makes the weights, builds the step and drives it through its
first steps on the seed's first batches; those steps are the ones the
reference follows after the window, and the same objects then run the
window. Compared, each by its worst case: every compared step's loss;
each leaf's first gradient as the optimizer got it (its first moment
after one step, over 1 - b1); each leaf's change after the compared
steps. A leaf whose reference gradient is below a thousandth of the
median leaf's moves by rounding alone and is not counted.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench import harness, traffic, weights
from portbench.reference import starcoder2 as ref

# the smallest gradient counted, against the median leaf's
COUNTED_GRAD = 1e-3


def model_config(run: harness.Run):
    from tpu_dra_driver_torch.workloads.models.transformer import ModelConfig
    s = run.shape
    return ModelConfig(vocab=s.vocab, d_model=s.d_model, n_heads=s.n_heads,
                       n_layers=s.n_layers, d_ff=s.d_ff,
                       max_seq=run.mix["seq"], dtype=torch.bfloat16,
                       n_kv_heads=s.n_kv_heads, use_rope=True,
                       window=s.window)


@torch.no_grad()
def change_norms(params: Dict, shape: ref.Shape, seed: int,
                 device) -> List[float]:
    """Each leaf's distance from the seed's initial weights, in the
    reference's leaf order; the initial matrices are drawn again, one
    kind at a time."""
    out: Dict[str, float] = {}

    def dist(a, b) -> float:
        return float(torch.linalg.vector_norm(a.float() - b.float()))

    for name, w in weights.matrices(shape, seed, device):
        if name == "embed":
            out["embed"] = dist(params["embed"], w)
        else:
            for i, part in enumerate(w.unbind(0)):
                out[f"layers.{i}.{name}"] = dist(params["layers"][i][name],
                                                 part)
        del w
    for i, layer in enumerate(params["layers"]):
        for norm in ("ln1", "ln2"):
            g = layer[norm]["g"]
            out[f"layers.{i}.{norm}.g"] = dist(g, torch.ones_like(g))
    g = params["final_norm"]["g"]
    out["final_norm.g"] = dist(g, torch.ones_like(g))
    return [out[n] for n in ref.leaf_names(shape.n_layers)]


def reference_run(run: harness.Run, n_steps: int, precision: str = "f32"):
    """(losses, first-gradient norms, change norms) of the reference over
    the first ``n_steps`` batches, one row at a time."""
    ref.strict_f32()
    s, opt = run.shape, run.params["optimizer"]
    params = weights.make_params(s, run.seed, run.device,
                                 as_dtype=torch.float32)
    tr = ref.TrainReference(params, s, ref.AdamW(
        lr=opt["lr"], weight_decay=opt["weight_decay"],
        clip_norm=opt["clip_norm"]), precision=precision)
    losses = []
    for i in range(n_steps):
        batch = traffic.packed_batch(run.mix, run.seed, i, s.vocab,
                                     run.device)
        losses.append(tr.step(list(batch.split(1))))
    grads = tr.first_grad_norms
    for p in tr.leaves:
        p.requires_grad_(False)
    return losses, grads, change_norms(params, s, run.seed, run.device)


def numbers(run: harness.Run, prog, refr) -> Dict[str, float]:
    """Every number a training cell can compare, each by its worst case:
    ``loss_gap``, a compared step's loss; ``grad_gap``, a leaf's first
    gradient; ``grad_spread``, the same once the program's gradient
    norms are divided by the factor all leaves share (their median
    ratio); ``change_gap``, a leaf's change after the compared steps."""
    (lp, gp, cp), (lr, gr, cr) = prog, refr
    names = ref.leaf_names(run.shape.n_layers)
    median = sorted(gr)[len(gr) // 2]
    counted = [g >= COUNTED_GRAD * median for g in gr]
    for n, c in zip(names, counted):
        if not c:
            run.log(f"not counted: {n} (reference gradient "
                    f"{gr[names.index(n)]:.3e})")
    for what, p, r in (("grad", gp, gr), ("change", cp, cr)):
        worst = max((i for i in range(len(names)) if counted[i]),
                    key=lambda i: abs(p[i] - r[i]) / r[i])
        run.log(f"{what}: worst leaf {names[worst]} program {p[worst]:.6e} "
                f"reference {r[worst]:.6e}")
    scale = harness.common_scale(gp, gr, counted)
    run.log(f"losses: program {lp} reference {lr}; gradients' common "
            f"factor {scale!r}")
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "grad_gap": harness.worst_leaf_gap(gp, gr, counted),
            "grad_spread": harness.worst_leaf_gap(gp, gr, counted, scale),
            "change_gap": harness.worst_leaf_gap(cp, cr, counted)}


def compare(run: harness.Run, prog, refr) -> Dict:
    """The numbers that the cell's limits name, each beside its limit."""
    got = numbers(run, prog, refr)
    return {k: (got[k], lim) for k, lim in run.cell["limits"].items()}


def run(run: harness.Run) -> harness.Outcome:
    from tpu_dra_driver_torch.workloads.models.transformer import (
        AdamW, make_train_step,
    )
    from tpu_dra_driver_torch.workloads.ops.attention import flash_attention

    s, p, dev, mix = run.shape, run.params, run.device, run.mix
    n_compared = p["compared_steps"]
    tokens_per_step = mix["rows"] * mix["seq"]
    params = weights.make_params(s, run.seed, dev)
    o = p["optimizer"]
    opt = AdamW(learning_rate=o["lr"], weight_decay=o["weight_decay"],
                clip_norm=o["clip_norm"])
    step_fn, init = make_train_step(model_config(run), optimizer=opt,
                                    attn_fn=flash_attention)
    state = init(params)

    def step(i: int) -> torch.Tensor:
        batch = traffic.packed_batch(mix, run.seed, i, s.vocab, dev)
        with run.spans("train_step"):
            return step_fn(params, state, (batch[:, :-1], batch[:, 1:]))[2]

    losses = []
    for i in range(n_compared):
        losses.append(float(step(i)))
        if i == 0:
            sd = state.state_dict()
            grads = [float(torch.linalg.vector_norm(
                sd[f"{n}.exp_avg"].float())) / (1.0 - opt.b1)
                for n in ref.leaf_names(s.n_layers)]
            del sd
    changes = change_norms(params, s, run.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.t_begin
    run.log(f"setup_s {setup_s:.3f}")

    window_losses = []
    with harness.steady_host():
        i, t_open = n_compared, time.perf_counter()
        while True:
            window_losses.append(step(i))
            i += 1
            if time.perf_counter() - t_open >= run.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t_open
    steps = i - n_compared
    # the traced steps come after the window, on the same state
    tracer = harness.Tracer(run.trace)
    tracer.start()
    for _ in range(p["trace_steps"] if run.trace else 0):
        step(i)
        i += 1
    tracer.stop()
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    peak = harness.memory_peak(dev)
    run.log(f"window: {steps} steps in {window_s:.3f} s, peak "
            f"{peak / 2**30:.2f} GiB")

    del params, state, step_fn, init, window_losses
    harness.free_device(dev)
    t_ref = time.perf_counter()
    refr = reference_run(run, n_compared)
    run.log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    checks = compare(run, (losses, grads, changes), refr)
    return harness.Outcome(
        e2e={"setup_s": setup_s,
             "train_tokens_per_s": steps * tokens_per_step / window_s},
        attempted=steps, failed=failed, memory_peak_bytes=peak,
        checks=checks,
        counters={"traced_steps": p["trace_steps"], "window_steps": steps,
                  "window_s": window_s, "rows": mix["rows"],
                  "seq": mix["seq"],
                  "compared": {"program": [losses, grads, changes],
                               "reference": list(refr)}},
        trace=tracer.result)
