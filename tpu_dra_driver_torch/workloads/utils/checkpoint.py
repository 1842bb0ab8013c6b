"""Train-state checkpoint and resume for the validation workloads.

Port of :mod:`tpu_dra_driver.workloads.utils.checkpoint`, on
``torch.distributed.checkpoint`` (DCP) in a single process:

- A state is a tree (dicts, lists, tuples) of tensors, optimizer states
  (:class:`~..models.transformer.OptState`,
  :class:`~..models.transformer.AdafactorState`), ``torch.Generator``
  states and plain values (ints, floats, strings). It is flattened to
  one DCP state dict keyed by each leaf's path; an optimizer state
  contributes its ``state_dict()``, whose tensors are named by their
  leaf's path in the params tree.
- Restore takes an ``abstract`` skeleton (:func:`abstract_like`): the
  shape, dtype and device of every tensor, optimizer moments included,
  so the target exists before DCP fills it (DCP loads only the keys the
  target has). It returns a new tree on the skeleton's devices: a state
  saved from the card restores onto the CPU.
- A state sharded over a mesh (each rank holding its shards, as
  ``parallel.mesh.device_put`` places them) saves from every rank of
  the process group: each sharded leaf as the global tensor
  (``DTensor.from_local`` with its ``NamedSharding``'s placements), the
  moments of a sharded optimizer state by its layout (a ZeRO-1 moment
  by its ``dp`` slice). It restores onto the same shardings (each rank
  gets its shards, ZeRO-1 moments their ``dp`` slices) or, through
  :func:`on_one_device`, whole onto one device, also in a process with
  no group: the reference's restore onto the mesh and onto
  ``SingleDeviceSharding``.
- Step-numbered directories with retention (write, then prune) and an
  atomic finalize: DCP writes its files in place, so a save goes to a
  temporary sibling (``step_N.tmp-<pid>-<hex>``) that is renamed when
  complete, and an interrupted save never parses as a step.
"""

from __future__ import annotations

import os
import shutil
import uuid
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

# DCP warns on every call that it runs without a process group; one
# process is this module's design
_SINGLE_PROCESS = "torch.distributed is disabled, unavailable or uninit"


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype and device: the counterpart of
    ``jax.ShapeDtypeStruct`` with its sharding. With ``sharding`` (a
    ``parallel.mesh.NamedSharding``), ``shape`` is the global shape and
    this rank holds its block."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    sharding: Any = None


@dataclass(frozen=True)
class GeneratorSpec:
    """A ``torch.Generator``: its device and the size of its state."""

    device: torch.device
    state_bytes: int


@dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer state: its class, its spec (``AdamW`` or
    ``Adafactor``), the path in the state tree of the params it updates,
    the skeleton of its ``state_dict()``, and the sharded step's layout
    that it is rebuilt with (``parallel.spmd.Layout``, or None)."""

    cls: type
    spec: Any
    params_at: Tuple
    state: Dict[str, Any]
    layout: Any = None


def _opt_states() -> tuple:
    """The optimizer-state classes (imported here: the models import this
    package's timing, so a module-level import would be circular)."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        AdafactorState, OptState,
    )
    return OptState, AdafactorState


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _items(node):
    if isinstance(node, dict):
        return node.items()
    return enumerate(node)


def _sub(shardings, key):
    """The part of a shardings tree at ``key`` (a sharding given for a
    subtree holds for each leaf in it)."""
    if isinstance(shardings, dict):
        return shardings.get(key)
    if isinstance(shardings, (list, tuple)):
        return shardings[key] if key < len(shardings) else None
    return shardings


def _is_sharded(sharding) -> bool:
    """Whether ``sharding`` splits its tensor over some axis of more than
    one rank (a leaf that no such axis splits is saved and restored as a
    plain tensor, whole on every rank)."""
    if sharding is None:
        return False
    from tpu_dra_driver_torch.workloads.parallel.spmd import axis_size
    return any(axis_size(sharding.mesh, ax) > 1 for ax in sharding.spec)


def _sizes(sharding, ndim: int) -> Tuple[int, ...]:
    """How many blocks ``sharding`` splits each of ``ndim`` dims into."""
    from tpu_dra_driver_torch.workloads.parallel.spmd import axis_size
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return tuple(axis_size(sharding.mesh, ax) for ax in spec[:ndim])


def _opt_shardings(opt) -> Dict[str, Any]:
    """The shardings of a sharded optimizer state's moments, by its
    layout: each moment that mirrors its leaf (AdamW's ``exp_avg`` and
    ``exp_avg_sq``, Adafactor's whole ``v``) held as the leaf's spec
    with ``dp`` on its ZeRO-1 dim; the rest (step counts, Adafactor's
    row and column factors) whole on every rank."""
    layout = getattr(opt, "layout", None)
    if layout is None:
        return {}
    from tpu_dra_driver_torch.workloads.parallel.mesh import NamedSharding
    out = {}
    for i, path in enumerate(opt.paths):
        sh = NamedSharding(layout.mesh, layout.held_spec(i))
        for name in ("exp_avg", "exp_avg_sq", "v"):
            out[f"{path}.{name}"] = sh
    return out


def _global(x: torch.Tensor, sharding):
    """This rank's block ``x`` as the global tensor it is a block of."""
    from torch.distributed.tensor import DTensor
    shape = tuple(n * k for n, k in zip(x.shape, _sizes(sharding, x.dim())))
    return DTensor.from_local(x.detach(), sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _flatten(node, prefix: str, out: Dict[str, Any], shardings=None) -> None:
    """The DCP state dict of a state tree: one entry per leaf, keyed by
    its path; a sharded leaf (``shardings``, a tree like ``node``) as its
    global tensor."""
    if isinstance(node, (dict, list, tuple)):
        for k, v in _items(node):
            _flatten(v, f"{prefix}{k}.", out, _sub(shardings, k))
    elif isinstance(node, _opt_states()):
        held = _opt_shardings(node)
        for k, v in node.state_dict().items():
            _flatten(v, f"{prefix}{k}.", out, held.get(k))
    elif isinstance(node, torch.Generator):
        out[prefix + "generator_state"] = node.get_state()
    elif isinstance(node, torch.Tensor) and _is_sharded(shardings):
        out[prefix[:-1]] = _global(node, shardings)
    else:
        out[prefix[:-1]] = node


def _grouped() -> bool:
    """Whether this process is one rank of a process group (whose ranks
    all save and restore together)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def save_train_state(directory: str, step: int, state: Any,
                     keep: Optional[int] = None, shardings=None) -> str:
    """Save a state tree (params, optimizer states, generators, step
    counters) under ``directory/step_<N>``, written to a temporary
    sibling first and renamed when complete (a state already saved at
    that step is replaced). Returns the checkpoint path. ``keep`` prunes
    to the newest N steps after a successful save (write, then prune: a
    crash mid-save never removes an older good checkpoint).

    In a process group every rank calls this with its own state
    (``directory`` on a file system they share): ``shardings`` (a tree
    like ``state`` of ``NamedSharding``, or part of one; a missing
    leaf is whole on every rank) says which leaves are this rank's
    blocks, and a sharded optimizer state's moments follow its layout.
    Rank 0 names the temporary directory, renames it and prunes. A
    failure on any rank fails the save on every rank (the others raise
    a ``RuntimeError`` naming it), and the temporary directory is
    removed."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    grouped = _grouped()
    rank0 = True
    if grouped:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
    os.makedirs(directory, exist_ok=True)
    path = _step_dir(directory, step)
    names = [f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"]
    if grouped:
        dist.broadcast_object_list(names, src=0)
    tmp = names[0]
    import torch.distributed.checkpoint as dcp
    flat: Dict[str, Any] = {}
    writer = error = None
    try:
        _flatten(state, "", flat, shardings)
        writer = dcp.FileSystemWriter(tmp)
    except BaseException as e:
        error = e
    try:
        # DCP's own collectives pass a failure inside the save to every
        # rank; one before it would leave the others waiting there
        _agree(error, grouped, "preparing the save")
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
            try:
                dcp.save(flat, storage_writer=writer)
            except BaseException as e:
                error = e
        _agree(error, grouped, "the save")
    except BaseException:
        if rank0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if rank0:
        try:
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            if keep is not None:
                for old in list_steps(directory)[:-keep]:
                    _remove_step(directory, old)
        except BaseException as e:
            error = e
    _agree(error, grouped, "renaming the save")
    return path


def _agree(error: Optional[BaseException], grouped: bool, what: str
           ) -> None:
    """Every rank of the group learns whether ``what`` failed on any:
    the rank where it did raises its ``error``, the others a
    ``RuntimeError`` naming those ranks. A collective: every rank calls
    it."""
    failed = {0: repr(error)} if error is not None else {}
    if grouped:
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, None if error is None else repr(error))
        failed = {r: e for r, e in enumerate(got) if e is not None}
    if error is not None:
        raise error
    if failed:
        raise RuntimeError(f"{what} failed on rank(s) {sorted(failed)}: "
                           f"{failed[min(failed)]}")


def list_steps(directory: str):
    """Completed checkpoint steps, ascending. A save in flight (or one
    that crashed) sits in ``step_N.tmp-*``, which fails the int parse
    and never appears."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _empty(spec: TensorSpec):
    """The tensor that DCP fills for ``spec``: this rank's block as a
    DTensor of the global shape where the spec is sharded, else the
    whole tensor."""
    if not _is_sharded(spec.sharding):
        return torch.empty(spec.shape, dtype=spec.dtype, device=spec.device)
    local = tuple(n // k for n, k in zip(
        spec.shape, _sizes(spec.sharding, len(spec.shape))))
    return _global(torch.empty(local, dtype=spec.dtype, device=spec.device),
                   spec.sharding)


def _targets(node, prefix: str, out: Dict[str, Any]) -> None:
    """The DCP state dict to load into: an empty tensor (or block of a
    sharded one) for every tensor of the skeleton, the skeleton's value
    for the rest."""
    if isinstance(node, (dict, list, tuple)):
        for k, v in _items(node):
            _targets(v, f"{prefix}{k}.", out)
    elif isinstance(node, OptimizerSpec):
        _targets(node.state, prefix, out)
    elif isinstance(node, GeneratorSpec):
        out[prefix + "generator_state"] = torch.empty(node.state_bytes,
                                                      dtype=torch.uint8)
    elif isinstance(node, TensorSpec):
        out[prefix[:-1]] = _empty(node)
    else:
        out[prefix[:-1]] = node


def _build(node, prefix: str, flat: Dict[str, Any], opts: list):
    """The restored tree, optimizer states left as None and listed in
    ``opts`` as (container, key, spec, prefix)."""
    if isinstance(node, (dict, list, tuple)):
        out = {} if isinstance(node, dict) else [None] * len(node)
        for k, v in _items(node):
            out[k] = _build(v, f"{prefix}{k}.", flat, opts)
            if isinstance(v, OptimizerSpec):
                if isinstance(node, tuple):
                    raise TypeError("an optimizer state inside a tuple "
                                    "cannot be restored; use a dict or "
                                    "a list")
                opts.append((out, k, v, f"{prefix}{k}."))
        return tuple(out) if isinstance(node, tuple) else out
    if isinstance(node, OptimizerSpec):
        return None
    if isinstance(node, GeneratorSpec):
        gen = torch.Generator(node.device)
        gen.set_state(flat[prefix + "generator_state"])
        return gen
    return _held(flat[prefix[:-1]])


def _held(x):
    """A restored value as this rank holds it: a DTensor's local block."""
    to_local = getattr(x, "to_local", None)
    return x if to_local is None else to_local()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def restore_train_state(directory: str, abstract: Any,
                        step: Optional[int] = None) -> Any:
    """Restore the state saved at ``step`` (default: the latest) as a new
    tree on the skeleton ``abstract`` (from :func:`abstract_like`): each
    tensor on its spec's device (this rank's block of a sharded one),
    each optimizer state a new one over the restored params at its
    ``params_at`` (with its layout), each generator a new one. In a
    process group every rank calls this; a skeleton from
    :func:`on_one_device` also restores in a process with no group."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    flat: Dict[str, Any] = {}
    _targets(abstract, "", flat)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        import torch.distributed.checkpoint as dcp
        dcp.load(flat, storage_reader=dcp.FileSystemReader(
            _step_dir(directory, step)))
    opts: list = []
    tree = _build(abstract, "", flat, opts)
    for container, key, spec, prefix in opts:
        opt = spec.cls(spec.spec, _at(tree, spec.params_at), spec.layout)
        opt.load_state_dict({k: _held(flat[prefix + k]) for k in spec.state})
        container[key] = opt
    return tree


def _params_path(tree, leaves, path=()):
    """The path of the subtree of ``tree`` whose leaves are exactly
    ``leaves`` (by identity), or None."""
    from tpu_dra_driver_torch.workloads.models.transformer import (
        _param_leaves,
    )
    if not isinstance(tree, (dict, list, tuple)):
        return None
    if [id(x) for x in _param_leaves(tree)] == [id(x) for x in leaves]:
        return path
    for k, v in _items(tree):
        found = _params_path(v, leaves, path + (k,))
        if found is not None:
            return found
    return None


def abstract_like(tree: Any, device=None, shardings=None) -> Any:
    """Live state tree → its skeleton for :func:`restore_train_state`:
    every tensor's shape, dtype and device (``device``, where given, in
    place of each tensor's own, for optimizer moments too; a generator
    keeps its own), every optimizer state's params path in ``tree``, the
    skeleton of its state (its moments' shapes exist before the first
    step) and its layout, plain values as they are.

    ``shardings`` (as :func:`save_train_state` takes them; the reference
    reads each array's own): a sharded leaf's spec has its global shape
    and its sharding, and a sharded optimizer state's moments follow its
    layout."""
    dev = None if device is None else torch.device(device)

    def one(node, sh):
        if isinstance(node, dict):
            return {k: one(v, _sub(sh, k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v, _sub(sh, i))
                              for i, v in enumerate(node))
        if isinstance(node, torch.Tensor):
            shape = tuple(node.shape)
            if _is_sharded(sh):
                shape = tuple(n * k for n, k in zip(
                    shape, _sizes(sh, node.dim())))
            return TensorSpec(shape, node.dtype, dev or node.device,
                              sh if _is_sharded(sh) else None)
        if isinstance(node, torch.Generator):
            return GeneratorSpec(node.device, node.get_state().numel())
        if isinstance(node, _opt_states()):
            at = _params_path(tree, node.leaves)
            if at is None:
                raise ValueError("an optimizer state's params must be in "
                                 "the same tree")
            held = _opt_shardings(node)
            return OptimizerSpec(type(node), node.spec, at,
                                 {k: one(v, held.get(k)) for k, v in
                                  node.state_dict().items()},
                                 node.layout)
        return node

    return one(tree, shardings)


def on_one_device(abstract: Any, device=None) -> Any:
    """A skeleton of :func:`abstract_like` with every sharding dropped:
    each tensor whole (its global shape) on ``device`` (default: its
    spec's), each optimizer state rebuilt without a layout. Restoring
    onto it gathers a state saved from a mesh onto one device."""
    dev = None if device is None else torch.device(device)

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v) for v in node)
        if isinstance(node, TensorSpec):
            return TensorSpec(node.shape, node.dtype, dev or node.device)
        if isinstance(node, OptimizerSpec):
            return OptimizerSpec(node.cls, node.spec, node.params_at,
                                 one(node.state))
        return node

    return one(abstract)


def _remove_step(directory: str, step: int) -> None:
    shutil.rmtree(_step_dir(directory, step))
