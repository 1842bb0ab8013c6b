"""The collectives of the sharded training step, made explicit.

The reference runs its SPMD step on global arrays and lets XLA insert
every collective. Here each rank holds its local shards and runs the
step's code on them; the collectives that XLA would insert are written
out, each as an autograd function whose backward is the transposed
collective:

- :func:`psum` (all-reduce forward, all-reduce backward),
- :func:`all_gather` (all-gather forward, reduce-scatter backward),
- :func:`all_to_all` (the tiled ``lax.all_to_all`` and its inverse),
- :func:`shift_open` (the pipeline's open-ended ``lax.ppermute`` hop,
  rank i to i + 1, and its transpose, rank i to i - 1; without grad:
  the pipeline's schedule posts both itself),
- :func:`masked_psum` (the pipeline's collect: one rank's buffer
  replicated over an axis).

With exact transposes the step differentiates the sum, over every rank,
of the rank's loss; every rank computes the same global loss, so the
gradient is taken of ``loss / world`` and then summed, for each
parameter, over the mesh axes that hold it replicated
(:meth:`Layout.sync`). A parameter used on every rank (a norm gain) so
gets the sum of its uses, and one whose use is split over axes (the
router, whose gates meet an expert only on the rank that holds it) gets
its share from each.

:class:`Spmd` is what the model's layers ask of the mesh (positions,
the vocab-parallel embedding and loss, the local heads and experts);
:class:`Layout` is what the optimizers ask (the gradient sums, ZeRO-1's
slices, sums over a whole sharded leaf). Every collective over an axis
of size 1 is skipped, so on a mesh whose axes are all 1 the step runs
the single-device step's operations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the names of torch 2.11's single-tensor collectives, which later
# releases renamed (the old names warn there)
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# ------------------------------------------------------------ the mesh

def axis_size(mesh, axis: Optional[str]) -> int:
    """The size of ``axis`` in ``mesh`` (1 for None or an axis the mesh
    does not have)."""
    names = mesh.mesh_dim_names
    if axis is None or axis not in names:
        return 1
    return int(mesh.shape[names.index(axis)])


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate along ``axis`` (0 where its size is 1)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


# --------------------------------------------- collectives without grad

def _all_gather_nograd(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The shards of every rank of ``group`` joined along ``dim``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    _all_gather_into(out, xs, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_nograd(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of ``x``, of which each rank keeps its
    block along ``dim``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    _reduce_scatter_into(out, xs, group=group)
    return out.movedim(0, dim)


def _all_to_all_nograd(x: torch.Tensor, group, split_axis: int,
                       concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: block j of ``split_axis``
    goes to rank j, and the blocks received are joined along
    ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


def _shift_nograd(xs: Sequence[torch.Tensor], group, shift: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Each rank of ``group`` sends ``xs`` to the rank ``shift`` after
    it and receives those of the rank ``shift`` before it; the sends and
    receives are posted together, so no rank waits on another's order."""
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    sent = [x.contiguous() for x in xs]
    got = [torch.empty_like(x) for x in sent]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in sent]
    ops += [dist.P2POp(dist.irecv, y, src, group) for y in got]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(got)


# ------------------------------------------ collectives with their grad

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_nograd(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_nograd(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all_nograd(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_nograd(g, *ctx.args), None, None, None


def shift_open(x: torch.Tensor, mesh, axis: str, direction: int
               ) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, i + 1) for i in range(n - 1)])``
    (``direction`` +1), or its transpose (-1: rank i's ``x`` to rank
    i - 1), without grad: the rank at the open end receives zeros. Every
    rank posts one send and one receive (the send from the far end goes
    round to the open end and is dropped there), so every rank posts the
    same collective in the same order on every call. Over an axis of
    size 1 the one rank is both ends: it receives zeros, and nothing is
    sent."""
    n = axis_size(mesh, axis)
    if n == 1:
        return torch.zeros_like(x)
    y, = _shift_nograd([x], mesh.get_group(axis), direction)
    end = 0 if direction > 0 else n - 1
    return y.zero_() if axis_index(mesh, axis) == end else y


class _MaskedPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, group):
        ctx.keep, ctx.group = keep, group
        y = x.clone(memory_format=torch.contiguous_format) if keep \
            else torch.zeros_like(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``lax.psum`` over ``axes``, differentiable (axes of size 1 are
    skipped)."""
    for axis in axes:
        if axis_size(mesh, axis) > 1:
            x = _AllReduce.apply(x, mesh.get_group(axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``axis`` joined along ``dim`` (tiled), differentiable:
    the backward sums the gradient over ``axis`` and keeps this rank's
    block."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over ``axis``, differentiable (the backward is the
    inverse all-to-all)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), split_axis, concat_axis)


def masked_psum(x: torch.Tensor, keep: bool, mesh, axis: str
                ) -> torch.Tensor:
    """``psum(where(keep, x, 0), axis)``, differentiable: the buffer of
    the ranks whose ``keep`` is True (the pipeline's last stage), summed
    and so replicated over ``axis``. Its transpose gives those ranks the
    summed cotangent and the others zeros, so every rank's backward
    reaches ``x`` (and runs whatever produced it)."""
    if axis_size(mesh, axis) == 1:
        return x if keep else torch.zeros_like(x)
    return _MaskedPsum.apply(x, keep, mesh.get_group(axis))


# ------------------------------------------------- the model's questions

class Spmd:
    """A sharded step's activation layout over ``mesh``: the batch over
    ``batch_axes``, the sequence over ``seq_axis``, attention heads over
    ``head_axis``; the parameters as :func:`..mesh.param_shardings` lays
    them out (Megatron over ``tp``, experts over ``ep``). Activations
    are replicated over the axes that shard neither."""

    def __init__(self, mesh, seq_axis: str = "sp",
                 batch_axes: Sequence[str] = ("dp",),
                 head_axis: Optional[str] = "tp"):
        if head_axis not in ("tp", None) or (
                head_axis is None and axis_size(mesh, "tp") > 1):
            raise ValueError(
                f"the sharded model splits heads over 'tp', as "
                f"param_shardings splits its weights; got head_axis "
                f"{head_axis!r}")
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axes = tuple(batch_axes)
        self.world = 1
        for axis in mesh.mesh_dim_names:
            self.world *= axis_size(mesh, axis)

    def size(self, axis) -> int:
        return axis_size(self.mesh, axis)

    def index(self, axis) -> int:
        return axis_index(self.mesh, axis)

    def psum(self, x, axes):
        return psum(x, self.mesh, axes)

    def seq_start(self, t_local: int) -> int:
        """Global position of this rank's first token."""
        return self.index(self.seq_axis) * t_local

    # embedding, positions and the loss --------------------------------

    def embed(self, table, tokens: torch.Tensor, dtype=None
              ) -> torch.Tensor:
        """Rows of the vocab-sharded table (a tensor, or a row-quantized
        ``QTensor`` whose scales are its rows' own, ``dtype`` as
        ``embed_lookup`` takes it): each rank looks up the tokens its
        rows hold (zeros elsewhere) and the partial rows are summed over
        ``tp``."""
        from tpu_dra_driver_torch.workloads.models.quantize import (
            embed_lookup,
        )
        if self.size("tp") == 1:
            return embed_lookup(table, tokens, dtype)
        v_local = getattr(table, "q", table).shape[0]
        local = tokens.long() - self.index("tp") * v_local
        held = (local >= 0) & (local < v_local)
        rows = embed_lookup(table, local.clamp(0, v_local - 1), dtype)
        rows = rows * held[..., None].to(rows.dtype)
        return self.psum(rows, ("tp",))

    def vocab_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits from this rank's ``tp`` shard of
        them (its rows of the tied table), joined in rank order on the
        last dim, so a greedy pick's tie goes to the lower index as on
        one device."""
        return all_gather(logits, self.mesh, "tp", logits.dim() - 1)

    def pos_rows(self, pos_embed: torch.Tensor, t_local: int
                 ) -> torch.Tensor:
        """This rank's rows of the learned position table (whose rows
        ``param_shardings`` splits over ``tp``): the global positions of
        its tokens."""
        full = all_gather(pos_embed, self.mesh, "tp", 0)
        t0 = self.seq_start(t_local)
        return full[t0:t0 + t_local]

    def positions_mask(self, prefix: int, t_local: int, device
                       ) -> Optional[torch.Tensor]:
        """``loss_positions`` at this rank's global positions."""
        if prefix <= 0:
            return None
        t0 = self.seq_start(t_local)
        return torch.arange(t0, t0 + t_local, device=device) >= prefix

    def token_nll(self, logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
        """Per-token NLL from this rank's vocab shard of the logits: the
        log-softmax's normalizer and the target's logit summed over
        ``tp`` (the max is a constant of the normalizer, so it carries no
        gradient)."""
        if self.size("tp") == 1:
            logp = torch.log_softmax(logits, dim=-1)
            return -logp.gather(-1, targets.long()[..., None])[..., 0]
        v_local = logits.shape[-1]
        m = logits.detach().amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX,
                        group=self.mesh.get_group("tp"))
        sumexp = self.psum(torch.exp(logits - m).sum(-1), ("tp",))
        lse = m[..., 0] + torch.log(sumexp)
        local = targets.long() - self.index("tp") * v_local
        held = (local >= 0) & (local < v_local)
        picked = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])
        picked = self.psum(picked[..., 0] * held.to(logits.dtype), ("tp",))
        return lse - picked

    def mean_nll(self, nll: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        """The global mean: the sum over the batch and sequence shards
        over the global count, never a mean of the ranks' means."""
        if mask is None:
            count = float(nll.numel() * self.size(self.seq_axis)
                          * self._batch_ways())
            total = nll.sum()
        else:
            w = mask.broadcast_to(nll.shape).to(nll.dtype)
            count = w.sum().detach()
            for axis in self._token_axes():
                if self.size(axis) > 1:
                    dist.all_reduce(count, group=self.mesh.get_group(axis))
            count = count.clamp_min(1.0)
            total = (nll * w).sum()
        return self.psum(total, self._token_axes()) / count

    def _token_axes(self) -> Tuple[str, ...]:
        return self.batch_axes + (self.seq_axis,)

    def _batch_ways(self) -> int:
        n = 1
        for axis in self.batch_axes:
            n *= self.size(axis)
        return n

    # attention and the FFN --------------------------------------------

    def qkv_columns(self, wqkv, d: int, kv_d: int):
        """The fused projection's columns of this rank's heads. The
        weight's contiguous ``tp`` block is not head-aligned (its columns
        are q, then k, then v), so the blocks are gathered and this
        rank's q, k and v columns taken from the whole."""
        return self.head_columns(wqkv, (d, kv_d, kv_d))

    def head_columns(self, w, parts: Sequence[int]):
        """This rank's columns of a fused column-parallel projection
        whose columns are ``parts`` (widths, each split over ``tp`` by
        heads): the ``tp`` blocks gathered, then this rank's block of
        each part taken from the whole."""
        tp = self.size("tp")
        if tp == 1:
            return w
        full = all_gather(w, self.mesh, "tp", w.dim() - 1)
        r = self.index("tp")
        cols, start = [], 0
        for width in parts:
            n = width // tp
            cols.append(full[..., start + r * n:start + (r + 1) * n])
            start += width
        return torch.cat(cols, dim=-1)

    def local_heads(self, n_heads: int, n_kv: int) -> Tuple[int, int]:
        tp = self.size("tp")
        if n_heads % tp or n_kv % tp:
            raise ValueError(f"heads ({n_heads}, {n_kv} kv) not divisible "
                             f"by tp ({tp})")
        return n_heads // tp, n_kv // tp

    def expert_slice(self, n_experts_local: int) -> slice:
        """This rank's experts in the global expert order."""
        e0 = self.index("ep") * n_experts_local
        return slice(e0, e0 + n_experts_local)

    def queue_offsets(self, counts: torch.Tensor) -> Optional[torch.Tensor]:
        """[b, E] slots that the tokens of earlier sequence shards take
        in each expert's queue (their per-expert counts summed), or None
        when the sequence is not sharded."""
        n = self.size(self.seq_axis)
        if n == 1:
            return None
        every = _all_gather_nograd(counts[None],
                                   self.mesh.get_group(self.seq_axis), 0)
        return every[:self.index(self.seq_axis)].sum(0)


# ------------------------------------------------ the optimizers' layout

class Layout:
    """Each trainable leaf's place on the mesh: its parameter spec (the
    mesh axis of each dim, or None), its global shape, and the dim that
    ZeRO-1 splits its optimizer state over ``dp`` (or None). Built by a
    sharded step's ``init`` from the local leaves and the shardings."""

    def __init__(self, spmd: Spmd, leaves: List[torch.Tensor],
                 specs: List[Tuple], zero_dims: List[Optional[int]]):
        self.mesh = spmd.mesh
        self.world = spmd.world
        self.specs = [tuple(s) + (None,) * (leaf.dim() - len(s))
                      for s, leaf in zip(specs, leaves)]
        self.zero_dims = list(zero_dims)
        self.global_shapes = [
            tuple(n * axis_size(self.mesh, ax) for n, ax in zip(leaf.shape,
                                                               spec))
            for leaf, spec in zip(leaves, self.specs)]

    def _replicated_axes(self, i: int) -> Tuple[str, ...]:
        held = set(self.specs[i])
        return tuple(ax for ax in self.mesh.mesh_dim_names
                     if ax not in held and axis_size(self.mesh, ax) > 1)

    def held_spec(self, i: int) -> Tuple:
        """Leaf i's optimizer-side spec: its param spec, with ``dp`` on
        its ZeRO-1 dim."""
        spec = list(self.specs[i])
        if self.zero_dims[i] is not None:
            spec[self.zero_dims[i]] = "dp"
        return tuple(spec)

    @torch.no_grad()
    def sync(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's gradient summed over the axes that hold the leaf
        replicated, in one all-reduce per (axes, dtype) bucket; a ZeRO-1
        leaf's is summed over ``dp`` by a reduce-scatter that leaves this
        rank its slice."""
        grads = list(grads)
        buckets: Dict[Tuple, List[int]] = {}
        for i, g in enumerate(grads):
            axes = tuple(ax for ax in self._replicated_axes(i)
                         if not (ax == "dp"
                                 and self.zero_dims[i] is not None))
            if axes:
                buckets.setdefault((axes, g.dtype), []).append(i)
        for (axes, _), idx in buckets.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            for axis in axes:
                dist.all_reduce(flat, group=self.mesh.get_group(axis))
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                grads[i] = part.view(grads[i].shape)
        for i, dim in enumerate(self.zero_dims):
            if dim is not None:
                grads[i] = _reduce_scatter_nograd(
                    grads[i], self.mesh.get_group("dp"), dim)
        return grads

    def zero_view(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """The part of leaf i whose optimizer state this rank holds: its
        ``dp`` slice along the ZeRO-1 dim (a view, updated in place), or
        the leaf itself."""
        dim = self.zero_dims[i]
        if dim is None:
            return leaf
        n = leaf.shape[dim] // axis_size(self.mesh, "dp")
        return leaf.detach().narrow(dim, axis_index(self.mesh, "dp") * n, n)

    @torch.no_grad()
    def gather_zero(self, leaves: Sequence[torch.Tensor]) -> None:
        """After an update of the ZeRO-1 slices, every rank's slice joined
        back into each leaf (ZeRO-1's all-gather over ``dp``)."""
        for i, leaf in enumerate(leaves):
            if self.zero_dims[i] is not None:
                part = self.zero_view(i, leaf)
                leaf.copy_(_all_gather_nograd(
                    part, self.mesh.get_group("dp"), self.zero_dims[i]))

    def sum_over(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """``x``, a local partial sum over a tensor laid out by ``spec``,
        summed over the axes that shard it (in place)."""
        for axis in dict.fromkeys(a for a in spec if a is not None):
            if axis_size(self.mesh, axis) > 1:
                dist.all_reduce(x, group=self.mesh.get_group(axis))
        return x

    def full(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """The whole tensor of which ``x`` is this rank's block under
        ``spec``."""
        for dim, axis in enumerate(spec):
            if axis is not None and axis_size(self.mesh, axis) > 1:
                x = _all_gather_nograd(x, self.mesh.get_group(axis), dim)
        return x

    def block(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` under ``spec``."""
        for dim, axis in enumerate(spec):
            n = axis_size(self.mesh, axis)
            if axis is not None and n > 1:
                size = x.shape[dim] // n
                x = x.narrow(dim, axis_index(self.mesh, axis) * size, size)
        return x
