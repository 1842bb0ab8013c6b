"""Sequence parallelism: ring attention and Ulysses all-to-all.

Port of :mod:`tpu_dra_driver.workloads.parallel.ringattention`. Each
rank holds a [b, h, t/n, d] shard of q, k and v along the sequence.

- :func:`ring_attention`: the K/V shards travel round the ring (the
  ``ppermute``) while each rank merges the partial attentions of its own
  q against each visiting chunk (kernel B1 on the card, and
  :func:`..ops.attention.merge_partials`). The backward is the ring's
  own (:func:`ring_backward`): kernels B2 and B3 on every visited chunk
  against the merged lse and D = rowsum(dO * O), their gradients in
  f32: dq summed on the rank, each chunk's dk/dv sum sent back round
  the ring in K/V's dtype, gaining each rank's part.
- :func:`ulysses_attention`: two all-to-alls re-shard [b, h, t/n, d]
  into [b, h/n, t, d], so that each rank runs full-sequence attention
  over its heads, and back.

The reference calls these inside ``shard_map``; here every rank is
already a shard, and ``mesh`` names the process groups. The ring's
schedule (:func:`ring_schedule`), hop (:func:`ring_hop`,
:func:`ring_hop_backward`) and loops (:func:`ring_forward`,
:func:`ring_backward`) run the ranks that one process holds in
lockstep, with the shift between hops passed in: one rank and a
collective in :func:`ring_attention`, or every rank and a rotation of
their chunks in :func:`ring_attention_all_ranks`.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from tpu_dra_driver_torch.workloads.ops import attention as fa
from tpu_dra_driver_torch.workloads.ops.attention import (
    attention_reference, flash_attention, merge_partials,
)
from tpu_dra_driver_torch.workloads.parallel.spmd import (
    Spmd, _shift_nograd, all_to_all, axis_index, axis_size,
)

# the ranks one process holds, in order, each with its tensors; a shift
# by +1 gives rank i what rank i - 1 held, by -1 what rank i + 1 held
Held = List[Tuple[torch.Tensor, ...]]
Shift = Callable[[Held, int], Held]


def ring_hops(n: int, tl: int, causal: bool,
              window: Optional[int]) -> int:
    """Hops after the rank's own chunk: n - 1, or with a window (causal
    only) the ``ceil((window - 1) / tl)`` hops whose chunks can reach a
    local row's band (a chunk s hops back ends (s - 1) * tl + 1 before
    the nearest local row)."""
    if causal and window is not None:
        return min(n - 1, -(-(window - 1) // tl))
    return n - 1


def ring_schedule(idx: int, n: int, tl: int, causal: bool,
                  window: Optional[int]) -> List[Optional[dict]]:
    """The flash mask of each hop on rank ``idx`` of an ``n``-rank ring
    with ``tl`` tokens per rank, hop 0 (the rank's own chunk) first, or
    None for a hop whose chunk is skipped: hop 0 causal (offsets cancel),
    a chunk from the future (owner (idx - s) % n wrapped round, so idx <
    s) skipped under ``causal``, a windowed chunk from the past banded by
    ``row_offset = s * tl`` (rows [s tl, (s + 1) tl) against columns [0,
    tl) give every global row-column distance), a chunk from the past
    without a window mask-free."""
    masks: List[Optional[dict]] = [{"causal": causal, "window": window}]
    for step in range(1, ring_hops(n, tl, causal, window) + 1):
        if causal and idx < step:
            masks.append(None)
        elif causal and window is not None:
            masks.append({"causal": True, "window": window,
                          "row_offset": step * tl})
        else:
            masks.append({"causal": False})
    return masks


def ring_hop(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
             mask: dict, out: Optional[torch.Tensor] = None,
             lse: Optional[torch.Tensor] = None):
    """One hop: the partial attention of ``q`` against the visiting
    chunk under ``mask`` (kernel B1), merged into the running ``(out,
    lse)`` when there is one. Returns the new ``(out, lse)``: the first
    hop's output in q's dtype, a merged one in f32."""
    fa._check_flash_args(q, kc, vc, mask["causal"], 512, 512,
                         mask.get("window"), mask.get("row_offset", 0),
                         None)
    o2, l2 = fa.flash_forward(q, kc, vc, **mask)
    if out is None:
        return o2, l2
    return merge_partials(out, lse, o2, l2)


def ring_hop_backward(q, kc, vc, dout, lse, dd, mask, f32_out=False):
    """One hop's gradients against the whole ring's lse and D = rowsum(dO
    * O) (kernels B2 and B3): (dq, dk, dv) of ``q`` and the chunk, in f32
    with ``f32_out``."""
    dq = fa.flash_backward_dq(q, kc, vc, dout, lse, dd, **mask,
                              f32_out=f32_out)
    dk, dv = fa.flash_backward_dkv(q, kc, vc, dout, lse, dd, **mask,
                                   f32_out=f32_out)
    return dq, dk, dv


def ring_forward(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], idxs: Sequence[int], n: int,
                 causal: bool, window: Optional[int], shift: Shift):
    """The ring's forward on the ranks ``idxs`` that this process holds,
    their shards [b, h, tl, d] in ``qs`` and [b, h_kv, tl, d] in ``ks``,
    ``vs``: at hop s each rank holds the K/V chunk of rank (idx - s) % n
    and runs :func:`ring_hop` where its schedule has a mask. Every rank
    shifts on every hop, whatever its schedule. Returns each rank's
    output in q's dtype (one cast of the f32 merge), its lse, and the
    (k, v, mask) it visited at each hop, None where it skipped."""
    plans = [ring_schedule(i, n, qs[0].shape[2], causal, window)
             for i in idxs]
    held: Held = list(zip(ks, vs))
    outs: list = [None] * len(qs)
    lses: list = [None] * len(qs)
    visits: List[list] = [[] for _ in qs]
    for step in range(len(plans[0])):
        if step:
            held = shift(held, 1)
        for r, (q, (k, v)) in enumerate(zip(qs, held)):
            mask = plans[r][step]
            visits[r].append(None if mask is None else (k, v, mask))
            if mask is not None:
                outs[r], lses[r] = ring_hop(q, k, v, mask, outs[r], lses[r])
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses, visits


def ring_backward(qs, ks, outs, lses, visits, douts, shift: Shift):
    """The ring's backward, from :func:`ring_forward`'s results and the
    outputs' gradients ``douts``: the hops in reverse, each visited chunk
    through :func:`ring_hop_backward`, whose gradients come out in f32
    when there is more than one hop. dq is summed on the rank in f32 and
    rounded once; each chunk's (dk, dv) sum travels back round the ring
    (a shift by -1 a hop, rounded to K/V's dtype: the reference's bytes),
    gaining each rank's part in f32, and is home at hop 0. Returns each
    rank's (dq, dk, dv) in the inputs' dtypes."""
    f32 = len(visits[0]) > 1
    dds = [(g.float() * o.float()).sum(dim=-1) for g, o in zip(douts, outs)]
    douts = [g.to(q.dtype) for g, q in zip(douts, qs)]
    dqs: list = [None] * len(qs)
    sums: list = [None] * len(qs)
    for step in reversed(range(len(visits[0]))):
        for r, q in enumerate(qs):
            if visits[r][step] is None:
                if sums[r] is None:
                    sums[r] = (torch.zeros_like(ks[r]),) * 2
                continue
            k, v, mask = visits[r][step]
            dq, dk, dv = ring_hop_backward(q, k, v, douts[r], lses[r],
                                           dds[r], mask, f32)
            dqs[r] = dq if dqs[r] is None else dqs[r] + dq
            sums[r] = (dk, dv) if sums[r] is None else (
                sums[r][0] + dk, sums[r][1] + dv)
        if step:
            sums = shift([tuple(x.to(k.dtype) for x in s)
                          for s, k in zip(sums, ks)], -1)
    return [(dq.to(q.dtype),) + tuple(x.to(k.dtype) for x in s)
            for dq, s, q, k in zip(dqs, sums, qs, ks)]


class _Ring(torch.autograd.Function):
    """:func:`ring_forward` and :func:`ring_backward` over the ranks of
    ``plan = (idxs, n, causal, window, shift)``, their q, k and v shards
    given in that order. Every tensor the backward reads, the visited
    chunks too, goes through ``save_for_backward``, so that activation
    checkpointing sees them."""

    @staticmethod
    def forward(ctx, plan, *shards):
        idxs, n, causal, window, shift = plan
        m = len(idxs)
        qs, ks, vs = shards[:m], shards[m:2 * m], shards[2 * m:]
        outs, lses, visits = ring_forward(qs, ks, vs, idxs, n, causal,
                                          window, shift)
        chunks = [x for hops in visits for hop in hops if hop is not None
                  for x in hop[:2]]
        ctx.save_for_backward(*qs, *ks, *outs, *lses, *chunks)
        ctx.masks = [[None if hop is None else hop[2] for hop in hops]
                     for hops in visits]
        ctx.shift = shift
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        m = len(douts)
        saved = iter(ctx.saved_tensors)
        qs, ks, outs, lses = ([next(saved) for _ in range(m)]
                              for _ in range(4))
        visits = [[None if mask is None else (next(saved), next(saved), mask)
                   for mask in masks] for masks in ctx.masks]
        douts = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(douts, outs)]
        grads = ring_backward(qs, ks, outs, lses, visits, douts, ctx.shift)
        dq, dk, dv = zip(*grads)
        return (None,) + dq + dk + dv


def _group_shift(mesh, axis_name: str) -> Shift:
    """The shift of a process that holds one rank of the ring over
    ``axis_name``: one collective for all its tensors."""
    def shift(held: Held, direction: int) -> Held:
        (xs,) = held
        return [_shift_nograd(xs, mesh.get_group(axis_name), direction)]
    return shift


def _rotate(held: Held, direction: int) -> Held:
    """The shift of a process that holds every rank of the ring: nothing
    is sent, rank i takes rank (i - direction)'s tensors."""
    n = len(held)
    return [held[(i - direction) % n] for i in range(n)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   window: Optional[int] = None, *, mesh) -> torch.Tensor:
    """Ring attention over ``axis_name`` of ``mesh`` on this rank's
    shards [b, h, t_local, d] (k, v [b, h_kv, t_local, d]); returns the
    local output shard in q's dtype. Hops follow :func:`ring_schedule`;
    the K/V chunks travel in their own dtype, one collective a hop. With
    one rank there is one hop and nothing is sent."""
    plan = ((axis_index(mesh, axis_name),), axis_size(mesh, axis_name),
            causal, window, _group_shift(mesh, axis_name))
    out, = _Ring.apply(plan, q, k, v)
    return out


def ring_attention_all_ranks(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, n: int, causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """Every rank of an ``n``-rank ring in this one process: the whole
    sequence's q [b, h, t, d] and k, v [b, h_kv, t, d] split into n
    shards and run through :func:`ring_attention`'s forward and backward,
    hop by hop, with the chunks rotated between the ranks in place of
    the collective; the shards' outputs joined. What a ring of n cards
    computes, on one."""
    if q.shape[2] % n:
        raise ValueError(f"sequence ({q.shape[2]}) not divisible by the "
                         f"ring's {n} ranks")
    shards = [s for x in (q, k, v) for s in x.chunk(n, dim=2)]
    outs = _Ring.apply((tuple(range(n)), n, causal, window, _rotate),
                       *shards)
    return torch.cat(outs, dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", causal: bool = True,
                      attn_fn: Optional[Callable] = None,
                      window: Optional[int] = None,
                      prefix: Optional[int] = None, *, mesh) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this rank's
    shards: [b, h, t/n, d] → [b, h/n, t, d], full-sequence attention
    over the rank's heads (``attn_fn``, flash attention by default, with
    ``window``/``prefix`` passed on), and back. Needs h (and h_kv)
    divisible by the axis size."""
    n = axis_size(mesh, axis_name)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by axis size ({n})")
    fn = attn_fn or (lambda q, k, v, c, **kw: flash_attention(q, k, v, c,
                                                              **kw))
    kw = {}
    if window is not None:
        kw["window"] = window
    if prefix is not None:
        kw["prefix"] = prefix

    def scatter_heads(x):     # [b, h, tl, d] -> [b, h/n, t, d]
        return all_to_all(x, mesh, axis_name, 1, 2)

    def gather_heads(x):      # [b, h/n, t, d] -> [b, h, tl, d]
        return all_to_all(x, mesh, axis_name, 2, 1)

    out = fn(scatter_heads(q), scatter_heads(k), scatter_heads(v), causal,
             **kw)
    return gather_heads(out)


class _ShardedAttention:
    """What the ``make_*`` wrappers return: called on this rank's
    [b/|batch|, h/|head|, t/|axis|, d] shards, with ``window`` (and for
    Ulysses ``prefix``) at build or call time. ``spmd`` tells the model
    how the activations lie on the mesh, so ``forward`` and
    ``make_train_step`` run the sharded step when given this as their
    ``attn_fn``."""

    def __init__(self, fn, mesh, axis_name, batch_axes, head_axis,
                 window):
        self._fn = fn
        self._layout = (axis_name, tuple(batch_axes), head_axis)
        self.mesh = mesh
        self.window = window

    @functools.cached_property
    def spmd(self) -> Spmd:
        return Spmd(self.mesh, *self._layout)

    def __call__(self, q, k, v, window=None, prefix=None):
        return self._fn(q, k, v, self.window if window is None else window,
                        prefix)


def make_ring_attention(mesh, axis_name: str = "sp", batch_axes=("dp",),
                        head_axis: Optional[str] = "tp",
                        causal: bool = True,
                        window: Optional[int] = None) -> Callable:
    """:func:`ring_attention` over ``mesh`` as an ``attn_fn``: batch on
    ``batch_axes`` and heads on ``head_axis`` (both embarrassingly
    parallel here), the sequence on ``axis_name``. ``window`` at build
    time, or at call time as the model layer passes it. Refuses
    ``prefix``, as the reference does."""
    def fn(q, k, v, w, prefix):
        if prefix is not None:
            raise ValueError(
                "ring attention does not support prefix-LM: prefix cols "
                "would be visible to ring-future devices the causal "
                "schedule never visits; use Ulysses (full-sequence "
                "attention per chip) or dp/tp/pp sharding instead")
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                              window=w, mesh=mesh)
    return _ShardedAttention(fn, mesh, axis_name, batch_axes, head_axis,
                             window)


def make_ulysses_attention(mesh, axis_name: str = "sp", batch_axes=("dp",),
                           head_axis: Optional[str] = "tp",
                           causal: bool = True,
                           attn_fn: Optional[Callable] = None,
                           window: Optional[int] = None) -> Callable:
    """:func:`ulysses_attention` over ``mesh`` as an ``attn_fn``, laid
    out as :func:`make_ring_attention`'s; takes ``window`` and ``prefix``
    at call time."""
    def fn(q, k, v, w, prefix):
        return ulysses_attention(q, k, v, axis_name=axis_name,
                                 causal=causal, attn_fn=attn_fn, window=w,
                                 prefix=prefix, mesh=mesh)
    return _ShardedAttention(fn, mesh, axis_name, batch_axes, head_axis,
                             window)


__all__ = [
    "ring_attention", "ring_attention_all_ranks", "ulysses_attention",
    "make_ring_attention", "make_ulysses_attention",
    "attention_reference", "ring_backward", "ring_forward", "ring_hop",
    "ring_hop_backward", "ring_hops", "ring_schedule",
]
