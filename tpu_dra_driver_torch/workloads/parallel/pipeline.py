"""Pipeline parallelism (pp): the GPipe microbatch schedule over a mesh
axis.

Port of :mod:`tpu_dra_driver.workloads.parallel.pipeline`. Each rank
along ``pp`` owns a *stage*, a contiguous group of transformer blocks
whose stacked weights are split on the leading (stage) axis; here each
rank holds its own ``[1, L/S, ...]`` slice (``mesh.device_put`` with
:func:`pp_param_shardings`). Activations flow stage to stage over
neighbour hops (:func:`..spmd.shift_open`, the reference's
``ppermute``), with the classic GPipe schedule: M microbatches drain
through S stages in M + S - 1 steps, an (S - 1)-step bubble at each end.
The schedule is a Python loop: every rank runs every step and posts
every hop, bubble steps compute on zeros, only the last stage keeps its
outputs, and the final collect is one masked psum
(:func:`..spmd.masked_psum`). The backward pipeline runs the steps in
reverse with the hops' transposes (:class:`_GPipe`): an autograd pass
over the whole rank would run a hop's backward only where the rank's
loss reaches it, which differs between stages, and a hop posted on one
rank alone never completes.

On a mesh that also has ``dp``, each ``dp`` group runs its own pipeline
on its rows of the batch (the tokens are the rank's ``dp`` shard, as
``batch_sharding`` places them), and the train step's loss is the
global mean over them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# the module, read at call time: the models import ``parallel`` (through
# ``ops``) while they load
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.parallel.mesh import NamedSharding
from tpu_dra_driver_torch.workloads.parallel.spmd import (
    Layout, Spmd, axis_index, axis_size, masked_psum, shift_open,
)

# stage-stacked parameter keys -> how many leading stack dims they carry
_BLOCK_KEYS = ("ln1_g", "wqkv", "wo", "ln2_g", "w_up", "w_down")


def stack_layers(layers: List[Dict], n_stages: int) -> Dict[str, torch.Tensor]:
    """[n_layers] list of block param dicts → dict of [S, L/S, ...]
    tensors (the layout that splits over the pp axis on dim 0)."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible into {n_stages} stages")
    per = n // n_stages

    if any("moe_up" in layer for layer in layers):
        raise ValueError("pipeline parallelism does not support MoE layers; "
                         "use the ep mesh axis (spmd.py) for expert parallelism")

    def get(layer, key):
        if key == "ln1_g":
            return layer["ln1"]["g"]
        if key == "ln2_g":
            return layer["ln2"]["g"]
        return layer[key]

    out = {}
    for key in _BLOCK_KEYS:
        rows = [torch.stack([get(layers[s * per + i], key).detach()
                             for i in range(per)])
                for s in range(n_stages)]
        out[key] = torch.stack(rows)          # [S, L/S, ...]
    return out


def stage_shardings(mesh, stacked: Dict, axis_name: str = "pp") -> Dict:
    return {k: NamedSharding(mesh, (axis_name,)) for k in stacked}


def _apply_stage(stage_p: Dict, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int = 0, attn_fn=None,
                 window: int = 0, prefix: int = 0) -> torch.Tensor:
    """Run this stage's L blocks on [mb, t, d] activations (learned
    positions: like the reference's, the stage applies no RoPE). Each
    stacked leaf is split once (``unbind``), so its gradient is stacked
    once."""
    layers = {k: v.unbind(0) for k, v in stage_p.items()}
    for i in range(stage_p["wqkv"].shape[0]):
        layer = {k: layers[k][i] for k in ("wqkv", "wo", "w_up", "w_down")}
        x = x + tt._attention(tt._rmsnorm(x, layers["ln1_g"][i]), layer,
                           n_heads, n_kv_heads, attn_fn, window=window,
                           prefix=prefix)
        x = x + tt._mlp(tt._rmsnorm(x, layers["ln2_g"][i]), layer)
    return x


class _GPipe(torch.autograd.Function):
    """The schedule with its own backward. Forward: M + S - 1 steps of
    this rank's stage, each on the injected microbatch (stage 0) or on
    what the previous rank sent (the others; zeros in the bubble), each
    output sent on to the next rank, the valid outputs kept on the last
    stage. Backward: the same steps in reverse, each taking its output's
    cotangent (the kept slot's, plus what the next rank sends back) to
    its input's and the stage's gradients, the input's sent back to the
    previous rank. Every rank posts one hop each step, both ways, so no
    hop of one rank waits on a step another skips; a stage's backward is
    autograd's over the graph its forward step recorded."""

    @staticmethod
    def forward(ctx, plan, x_mb, *leaves):
        run, keys, mesh, axis, n_stages, n_micro = plan
        idx = axis_index(mesh, axis)
        first, last = idx == 0, idx == n_stages - 1
        grad = any(ctx.needs_input_grad)
        held = [v.detach().requires_grad_(grad) for v in leaves]
        out = torch.zeros_like(x_mb)
        act = torch.zeros_like(x_mb[0])
        xs, ys = [], []
        with torch.set_grad_enabled(grad):
            stage_p = {k: v[0] for k, v in zip(keys, held)}
            for s in range(n_micro + n_stages - 1):
                mb_idx = s - idx              # microbatch this stage holds
                src = x_mb[min(s, n_micro - 1)] if first else act
                xin = src.detach().requires_grad_(grad)
                y = run(stage_p, xin)
                if last and 0 <= mb_idx < n_micro:
                    out[mb_idx] = y.detach().to(out.dtype)
                act = shift_open(y.detach(), mesh, axis, 1)
                xs.append(xin)
                ys.append(y)
        ctx.saved = (plan, idx, held, xs, ys)
        return out

    @staticmethod
    def backward(ctx, dout):
        (_, _, mesh, axis, n_stages, n_micro), idx, held, xs, ys = ctx.saved
        first, last = idx == 0, idx == n_stages - 1
        dx_mb = torch.zeros_like(dout) if first else None
        grads = [torch.zeros_like(v) for v in held]
        d_in = torch.zeros_like(xs[0])
        for s in reversed(range(n_micro + n_stages - 1)):
            dy = shift_open(d_in, mesh, axis, -1)
            mb_idx = s - idx
            if last and 0 <= mb_idx < n_micro:
                dy = dy + dout[mb_idx].to(dy.dtype)
            got = torch.autograd.grad(ys[s], [xs[s]] + held, dy,
                                      allow_unused=True,
                                      materialize_grads=True)
            d_in = got[0]
            for acc, g in zip(grads, got[1:]):
                acc.add_(g)
            if first:
                dx_mb[min(s, n_micro - 1)] += d_in
        ctx.saved = None
        return (None, dx_mb) + tuple(grads)


def pipeline_apply(stacked: Dict, x_mb: torch.Tensor, *, axis_name: str,
                   n_heads: int, n_stages: int, n_micro: int,
                   n_kv_heads: int = 0, attn_fn=None,
                   window: int = 0, prefix: int = 0, mesh) -> torch.Tensor:
    """The GPipe schedule on this rank of ``mesh``'s ``axis_name``
    (:class:`_GPipe`), differentiable.

    stacked: this rank's stage slice [1, L, ...]; x_mb: the whole
    [M, mb, t, d] microbatch stack (only stage 0 reads it). Returns the
    [M, mb, t, d] outputs, the same on every rank of the axis."""
    def run(stage_p, x):
        return _apply_stage(stage_p, x, n_heads, n_kv_heads, attn_fn,
                            window=window, prefix=prefix)

    keys = tuple(stacked)
    out = _GPipe.apply((run, keys, mesh, axis_name, n_stages, n_micro),
                       x_mb, *(stacked[k] for k in keys))
    # only the last stage's buffer is real; the masked psum replicates it
    return masked_psum(out, axis_index(mesh, axis_name) == n_stages - 1,
                       mesh, axis_name)


def _batch_axes(mesh, axis_name: str):
    return tuple(ax for ax in ("dp",)
                 if ax != axis_name and ax in mesh.mesh_dim_names)


def make_pp_forward(mesh, cfg: tt.ModelConfig, n_stages: int,
                    n_micro: int, axis_name: str = "pp", attn_fn=None):
    """Build ``forward(pp_params, tokens) -> logits`` where the block
    stack runs as a pipeline over ``axis_name``. ``pp_params`` =
    {"embed", "pos_embed", "final_norm_g", "stages": stack_layers(...)}
    as this rank holds it (embed/unembed replicated; only the stages
    split), ``tokens`` this rank's rows of the batch."""
    size = axis_size(mesh, axis_name)
    if size != n_stages:
        raise ValueError(
            f"mesh axis {axis_name!r} has size {size} "
            f"but n_stages={n_stages}")

    def pipe(stages, x_mb):
        return pipeline_apply(
            stages, x_mb, axis_name=axis_name, n_heads=cfg.n_heads,
            n_stages=n_stages, n_micro=n_micro, n_kv_heads=cfg.n_kv_heads,
            attn_fn=attn_fn, window=cfg.window, prefix=cfg.prefix,
            mesh=mesh)

    def forward(pp_params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
        got = pp_params["stages"]["wqkv"].shape[0] * size
        if got != n_stages:
            raise ValueError(
                f"pp_params stacked for {got} stages but n_stages={n_stages}")
        x = pp_params["embed"][tokens] + pp_params["pos_embed"][:t]
        x_mb = x.reshape(n_micro, b // n_micro, t, cfg.d_model)
        y_mb = pipe(pp_params["stages"], x_mb)
        x = y_mb.reshape(b, t, cfg.d_model)
        x = tt._rmsnorm(x, pp_params["final_norm_g"])
        return (x @ pp_params["embed"].T).float()

    return forward


def params_to_pp(params: Dict, n_stages: int) -> Dict:
    """Convert transformer.init_params output to the pipeline layout (new
    tensors: the stages are stacked copies)."""
    params = tt.unstack_layer_params(params)    # no-op for list storage
    return {
        "embed": params["embed"],
        "pos_embed": params["pos_embed"],
        "final_norm_g": params["final_norm"]["g"],
        "stages": stack_layers(params["layers"], n_stages),
    }


def pp_param_shardings(mesh, pp_params: Dict,
                       axis_name: str = "pp") -> Dict:
    repl = NamedSharding(mesh, ())
    return {
        "embed": repl, "pos_embed": repl, "final_norm_g": repl,
        "stages": stage_shardings(mesh, pp_params["stages"], axis_name),
    }


def make_pp_train_step(mesh, cfg: tt.ModelConfig, n_stages: int,
                       n_micro: int, axis_name: str = "pp",
                       optimizer=None, attn_fn=None):
    """(pp_params, opt_state, (tokens, targets)) -> (params', opt', loss),
    the params updated IN PLACE (the reference returns new arrays) and
    the loss detached; returns ``(train_step, init_opt_state)``. The
    default optimizer is ``optax.adamw(1e-3)``: :class:`AdamW(1e-3)`.

    Every rank takes the gradient of ``loss / world`` (the hops' and the
    psum's backwards are their transposes) and sums each leaf's over
    the axes that hold it replicated: ``embed``, ``pos_embed`` and
    ``final_norm_g`` over ``pp`` (``embed`` is used by stage 0's input
    and by every rank's tied head), every leaf over ``dp``. With one
    rank the step is ``make_train_step``'s."""
    opt = optimizer or tt.AdamW(1e-3)
    forward = make_pp_forward(mesh, cfg, n_stages, n_micro, axis_name,
                              attn_fn)
    spmd = Spmd(mesh, seq_axis=axis_name,
                batch_axes=_batch_axes(mesh, axis_name), head_axis=None)
    scale = 1.0 / spmd.world

    def loss_fn(pp_params, batch):
        tokens, targets = batch
        logits = forward(pp_params, tokens)
        pos = tt.loss_positions(cfg, tokens.shape[1], tokens.device)
        if spmd.world == 1:
            return tt.nll_from_logits(logits, targets, pos)
        return spmd.mean_nll(spmd.token_nll(logits, targets), pos)

    def train_step(pp_params, opt_state, batch):
        loss = loss_fn(pp_params, batch)
        grads = torch.autograd.grad(loss if scale == 1.0 else loss * scale,
                                    opt_state.leaves, allow_unused=True,
                                    materialize_grads=True)
        opt_state.apply(opt_state.layout.sync(grads))
        return pp_params, opt_state, loss.detach()

    def init_opt_state(pp_params):
        specs = {path: sh.spec for path, sh in zip(
            tt._leaf_paths(pp_params), tt._param_leaves(pp_param_shardings(
                mesh, pp_params, axis_name)))}
        leaves = tt._param_leaves(pp_params)
        layout = Layout(spmd, leaves,
                        [specs[p] for p in tt._leaf_paths(pp_params)],
                        [None] * len(leaves))
        return opt.init(pp_params, layout=layout)

    return train_step, init_opt_state
