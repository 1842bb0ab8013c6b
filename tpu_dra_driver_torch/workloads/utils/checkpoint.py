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
  saved from the card restores onto the CPU, the single-device
  counterpart of the reference's restore onto another mesh. Restoring
  onto another layout of several devices waits for the multi-GPU tier.
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
    ``jax.ShapeDtypeStruct`` with its sharding."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


@dataclass(frozen=True)
class GeneratorSpec:
    """A ``torch.Generator``: its device and the size of its state."""

    device: torch.device
    state_bytes: int


@dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer state: its class, its spec (``AdamW`` or
    ``Adafactor``), the path in the state tree of the params it updates,
    and the skeleton of its ``state_dict()``."""

    cls: type
    spec: Any
    params_at: Tuple
    state: Dict[str, Any]


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


def _flatten(node, prefix: str, out: Dict[str, Any]) -> None:
    """The DCP state dict of a state tree: one entry per leaf, keyed by
    its path."""
    if isinstance(node, (dict, list, tuple)):
        for k, v in _items(node):
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(node, _opt_states()):
        for k, v in node.state_dict().items():
            out[prefix + k] = v
    elif isinstance(node, torch.Generator):
        out[prefix + "generator_state"] = node.get_state()
    else:
        out[prefix[:-1]] = node


def save_train_state(directory: str, step: int, state: Any,
                     keep: Optional[int] = None) -> str:
    """Save a state tree (params, optimizer states, generators, step
    counters) under ``directory/step_<N>``, written to a temporary
    sibling first and renamed when complete (a state already saved at
    that step is replaced). Returns the checkpoint path. ``keep`` prunes
    to the newest N steps after a successful save (write, then prune: a
    crash mid-save never removes an older good checkpoint)."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(directory, exist_ok=True)
    path = _step_dir(directory, step)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    flat: Dict[str, Any] = {}
    _flatten(state, "", flat)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
            import torch.distributed.checkpoint as dcp
            dcp.save(flat, storage_writer=dcp.FileSystemWriter(tmp))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        for old in list_steps(directory)[:-keep]:
            _remove_step(directory, old)
    return path


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


def _targets(node, prefix: str, out: Dict[str, Any]) -> None:
    """The DCP state dict to load into: an empty tensor for every
    tensor of the skeleton, the skeleton's value for the rest."""
    if isinstance(node, (dict, list, tuple)):
        for k, v in _items(node):
            _targets(v, f"{prefix}{k}.", out)
    elif isinstance(node, OptimizerSpec):
        _targets(node.state, prefix, out)
    elif isinstance(node, GeneratorSpec):
        out[prefix + "generator_state"] = torch.empty(node.state_bytes,
                                                      dtype=torch.uint8)
    elif isinstance(node, TensorSpec):
        out[prefix[:-1]] = torch.empty(node.shape, dtype=node.dtype,
                                       device=node.device)
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
    return flat[prefix[:-1]]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def restore_train_state(directory: str, abstract: Any,
                        step: Optional[int] = None) -> Any:
    """Restore the state saved at ``step`` (default: the latest) as a new
    tree on the skeleton ``abstract`` (from :func:`abstract_like`): each
    tensor on its spec's device, each optimizer state a new one over the
    restored params at its ``params_at``, each generator a new one."""
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
        opt = spec.cls(spec.spec, _at(tree, spec.params_at))
        opt.load_state_dict({k: flat[prefix + k] for k in spec.state})
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


def abstract_like(tree: Any, device=None) -> Any:
    """Live state tree → its skeleton for :func:`restore_train_state`:
    every tensor's shape, dtype and device (``device``, where given, in
    place of each tensor's own, for optimizer moments too; a generator
    keeps its own), every optimizer state's params path in ``tree`` and
    the skeleton of its state (its moments' shapes exist before the
    first step), plain values as they are."""
    dev = None if device is None else torch.device(device)

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v) for v in node)
        if isinstance(node, torch.Tensor):
            return TensorSpec(tuple(node.shape), node.dtype,
                              dev or node.device)
        if isinstance(node, torch.Generator):
            return GeneratorSpec(node.device, node.get_state().numel())
        if isinstance(node, _opt_states()):
            at = _params_path(tree, node.leaves)
            if at is None:
                raise ValueError("an optimizer state's params must be in "
                                 "the same tree")
            return OptimizerSpec(type(node), node.spec, at,
                                 {k: one(v) for k, v in
                                  node.state_dict().items()})
        return node

    return one(tree)


def _remove_step(directory: str, step: int) -> None:
    shutil.rmtree(_step_dir(directory, step))
