"""Mesh construction and sharding rules for the sharded workload.

Port of :mod:`tpu_dra_driver.workloads.parallel.mesh`. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the world's
ranks with the reference's axis names and order; a sharding is a
:class:`NamedSharding`, the spec (the mesh axis of each tensor dim, as
the reference's ``PartitionSpec``) with its DTensor placements. Where
the reference places a global array and lets XLA insert collectives,
each rank here holds its local shards (:func:`device_put`) and the
sharded step writes the collectives out (:mod:`.spmd`).

The sharding rules read only the mesh's axis names and sizes, so
``param_shardings`` and ``zero1_opt_shardings`` take any object with
``mesh_dim_names`` and ``shape``; building a ``DeviceMesh`` needs a
process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_driver_torch.workloads.models.quantize import QTensor
from tpu_dra_driver_torch.workloads.parallel.spmd import (
    axis_index, axis_size,
)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: one entry per leading tensor dim, a mesh
    axis name or None (trailing dims are unsharded), as the reference's
    ``NamedSharding(mesh, P(*spec))``."""

    mesh: object
    spec: Tuple[Optional[str], ...]

    @property
    def placements(self):
        """The DTensor placements, one per mesh dim: ``Shard(d)`` where
        the spec puts that axis on dim d, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, ax in enumerate(self.spec) if ax == name]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _world_ranks(devices) -> list:
    if devices is not None:
        return list(devices)
    import torch.distributed as dist
    return list(range(dist.get_world_size()))


def _mesh(device_type: str, ranks, sizes, names) -> DeviceMesh:
    return DeviceMesh(device_type, torch.tensor(np.array(ranks).reshape(
        sizes)), mesh_dim_names=names)


def _largest_pow2_divisor_le(n: int, cap: int) -> int:
    best = 1
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
        best = p
    return best


def mesh_shape(n: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) of :func:`build_mesh` over ``n`` ranks, or its
    ``ValueError``."""
    if tp is None:
        tp = _largest_pow2_divisor_le(n, 4 if n >= 4 else n)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return dp, tp


def build_mesh(devices: Optional[Sequence] = None,
               dp: Optional[int] = None, tp: Optional[int] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over ``devices`` (the world's ranks by default):
    tp along the fastest-varying dimension (adjacent ranks), dp over the
    rest. ``device_type`` is ``"cuda"`` (NCCL) or ``"cpu"`` (gloo)."""
    ranks = _world_ranks(devices)
    sizes = mesh_shape(len(ranks), dp, tp)
    return _mesh(device_type, ranks, sizes, ("dp", "tp"))


def mesh_shape_spmd(n: int, dp: Optional[int] = None,
                    sp: Optional[int] = None, tp: Optional[int] = None,
                    ep: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(dp, sp, tp, ep) of :func:`build_mesh_spmd` over ``n`` ranks, or
    its ``ValueError``: explicit axes claim their factors first, then
    tp, sp and ep take a factor of 2 each where the count allows, and dp
    the rest."""
    sizes = {"tp": tp, "sp": sp, "ep": ep, "dp": dp}
    rem = n
    for ax, size in sizes.items():
        if size is not None:
            if size <= 0 or rem % size:
                raise ValueError(
                    f"{ax}={size} does not divide remaining device count "
                    f"{rem} (of {n})")
            rem //= size
    for ax in ("tp", "sp", "ep"):
        if sizes[ax] is None:
            sizes[ax] = 2 if rem % 2 == 0 else 1
            rem //= sizes[ax]
    if sizes["dp"] is None:
        sizes["dp"] = rem
        rem = 1
    if rem != 1:
        raise ValueError(
            f"dp({sizes['dp']}) * sp({sizes['sp']}) * tp({sizes['tp']}) * "
            f"ep({sizes['ep']}) != device count ({n})")
    return sizes["dp"], sizes["sp"], sizes["tp"], sizes["ep"]


def build_mesh_spmd(devices: Optional[Sequence] = None,
                    dp: Optional[int] = None, sp: Optional[int] = None,
                    tp: Optional[int] = None, ep: Optional[int] = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """The 4-axis ``(dp, sp, tp, ep)`` mesh of the sharded workload:
    data, sequence (ring attention), tensor (Megatron) and expert (MoE)
    parallelism, ``ep`` innermost and ``dp`` outermost, with
    :func:`mesh_shape_spmd`'s factorization."""
    ranks = _world_ranks(devices)
    sizes = mesh_shape_spmd(len(ranks), dp, sp, tp, ep)
    return _mesh(device_type, ranks, sizes, ("dp", "sp", "tp", "ep"))


def batch_sharding(mesh) -> NamedSharding:
    """Inputs [b, t]: batch over dp (and the sequence over sp on an
    SPMD mesh)."""
    if "sp" in mesh.mesh_dim_names:
        return NamedSharding(mesh, ("dp", "sp"))
    return NamedSharding(mesh, ("dp", None))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _tree_paths(node, prefix=""):
    """(path, leaf) of a dict/list params tree, the path joined by '/';
    a :class:`QTensor` yields its codes and its scales as ``<path>/q``
    and ``<path>/s``."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(node, QTensor):
        yield f"{prefix}/q", node.q
        yield f"{prefix}/s", node.s
    else:
        yield prefix, node


def _tree_like(node, fn, prefix=""):
    """``node``'s structure with each leaf (QTensor codes and scales
    apart) replaced by ``fn(path, leaf)``."""
    if isinstance(node, dict):
        return {k: _tree_like(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_like(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(node)]
    if isinstance(node, QTensor):
        return QTensor(q=fn(f"{prefix}/q", node.q),
                       s=fn(f"{prefix}/s", node.s), axis=node.axis)
    return fn(prefix, node)


def _param_spec(path: str, ndim: int, stacked: bool, ep_ax) -> tuple:
    """The reference's rule for one leaf."""
    lead = ()
    if stacked and "layers" in path:
        ndim -= 1                   # rules see the per-layer rank
        lead = (None,)              # the stack axis is unsharded
    if ndim < 2:
        return ()
    if "moe_up" in path:
        return lead + (ep_ax, None, "tp")
    if "moe_down" in path:
        return lead + (ep_ax, "tp", None)
    if "router" in path:
        return ()
    if any(k in path for k in ("wqkv", "w_up", "w_gate")):
        return lead + (None, "tp")
    if any(k in path for k in ("wo", "w_down")):
        return lead + ("tp", None)
    if "embed" in path:
        return ("tp", None)
    return ()


def param_shardings(mesh, params):
    """Megatron-style tensor parallelism, the reference's rules: the
    attention qkv and MLP up/gate projections column-parallel (dim 1 on
    tp), the attention out and MLP down projections row-parallel (dim 0
    on tp), embeddings (every leaf whose path names ``embed``) on their
    first dim over tp, MoE banks over ep then tp within an expert, the
    router, norms and every leaf below rank 2 replicated. QTensor codes
    take their weight's rule and their scales (rank 1, or [L, n] when
    stacked) replicate. Both layer layouts: the per-layer list, and
    ``scan_layers``' stacked dict whose leading [L] axis stays unsharded.
    Returns a tree of :class:`NamedSharding` shaped like ``params``."""
    ep_ax = "ep" if "ep" in mesh.mesh_dim_names else None
    stacked = isinstance(params, dict) and isinstance(
        params.get("layers"), dict)
    return _tree_like(params, lambda path, x: NamedSharding(
        mesh, _param_spec(path, x.dim(), stacked, ep_ax)))


def local_scales(params, mesh):
    """This rank's shards of a quantized params tree (as
    :func:`device_put` places them by :func:`param_shardings`: each
    ``QTensor``'s codes split by its weight's rule, its scales whole)
    with each ``QTensor``'s scales narrowed to its codes' block
    (:func:`..models.quantize.block_scales`), the layout that a rank's
    products read: a column-parallel ``wqkv`` or ``w_up`` multiplies its
    columns by their own scales, a row-parallel ``wo`` or ``w_down``
    keeps every scale, the vocab-parallel ``embed`` its rows'."""
    from tpu_dra_driver_torch.workloads.models.quantize import block_scales
    specs = dict(_tree_paths(param_shardings(mesh, params)))

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
        if isinstance(node, QTensor):
            for dim, axis in enumerate(specs[f"{prefix}/q"].spec):
                node = block_scales(node, dim, axis_index(mesh, axis),
                                    axis_size(mesh, axis))
        return node

    return walk(params)


def _zero1_augment(spec: tuple, shape, dp: int) -> tuple:
    """``spec`` with ``dp`` on the first still-unsharded, dp-divisible
    dim of ``shape`` (unchanged when dp is 1 or no dim qualifies)."""
    if dp <= 1:
        return spec
    axes = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax is None and dim % dp == 0:
            axes[i] = "dp"
            return tuple(axes)
    return spec


def _state_leaves(params, opt):
    """(state name, param path, shape) of every tensor that
    ``opt.init(params)`` holds, named as its ``state_dict`` names them;
    the param path is None for a state tensor that matches no param
    (the count, the step counts, Adafactor's factors)."""
    from tpu_dra_driver_torch.workloads.models import transformer as tt
    yield "count", None, ()
    for path, leaf in zip(tt._leaf_paths(params), tt._param_leaves(params)):
        shape = tuple(leaf.shape)
        if isinstance(opt, tt.Adafactor):
            dims = tt._factored_dims(shape)
            if dims is None:
                yield f"{path}.v", path, shape
            else:
                d1, d0 = dims
                yield f"{path}.v_row", None, tuple(np.delete(shape, d0))
                yield f"{path}.v_col", None, tuple(np.delete(shape, d1))
        else:
            yield f"{path}.exp_avg", path, shape
            yield f"{path}.exp_avg_sq", path, shape
            yield f"{path}.step", None, ()


def zero1_opt_shardings(mesh, params, opt) -> dict:
    """ZeRO-1: the optimizer state sharded over ``dp`` on top of the
    param shardings. Each moment that mirrors a param (AdamW's
    ``exp_avg`` and ``exp_avg_sq``, Adafactor's unfactored ``v``) takes
    its param's spec with ``dp`` added on the first still-unsharded,
    dp-divisible dim; every other state tensor (counts, Adafactor's row
    and column factors) is replicated, as the reference's rule finds no
    param of its shape. ``params`` is the full tree (global shapes).
    Returns ``{state_dict name: NamedSharding}``; give it to the sharded
    step's ``init`` to place the state."""
    from tpu_dra_driver_torch.workloads.models import transformer as tt
    dp = axis_size(mesh, "dp")
    p_specs = {path: sh.spec for path, sh in zip(
        tt._leaf_paths(params),
        tt._param_leaves(param_shardings(mesh, params)))}
    out = {}
    for name, path, shape in _state_leaves(params, opt):
        spec = () if path is None else _zero1_augment(p_specs[path], shape,
                                                      dp)
        out[name] = NamedSharding(mesh, spec)
    return out


def _local(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis)
        if axis is not None and n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {axis} ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, axis_index(mesh, axis) * size, size)
    return x


def _fresh_local(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    part = _local(x.detach(), sh.spec, sh.mesh).contiguous()
    return part.clone() if part.data_ptr() == x.data_ptr() else part


def device_put(tree, shardings):
    """This rank's shards of a full tree (every rank holds the same full
    tree, as ``jax.device_put`` takes one global value): each leaf
    sliced by its :class:`NamedSharding`, as a fresh contiguous tensor
    (a copy also where the shard is the whole leaf) that can take
    in-place updates. ``shardings`` is a tree like ``tree``, or one
    sharding for every leaf."""
    if isinstance(shardings, NamedSharding):
        return _tree_like(tree, lambda path, x: _fresh_local(x, shardings))
    specs = dict(_tree_paths(shardings))
    return _tree_like(tree, lambda path, x: _fresh_local(x, specs[path]))


def to_full(tree, shardings):
    """The full tree from every rank's shards (``DTensor.full_tensor``
    of each leaf), on every rank, as fresh tensors (a replicated leaf is
    copied, not aliased); the inverse of :func:`device_put`."""
    from torch.distributed.tensor import DTensor
    specs = dict(_tree_paths(shardings))

    def full(path, x):
        sh = specs[path]
        out = DTensor.from_local(x.detach(), sh.mesh, sh.placements,
                                 run_check=False).full_tensor()
        return out.clone() if out.data_ptr() == x.data_ptr() else out

    return _tree_like(tree, full)
