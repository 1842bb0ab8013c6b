"""JAX parameter trees → the port's parameters.

The port never imports JAX: callers hand over the reference's params
with their leaves already turned into numpy arrays (``jax.tree.map(
np.asarray, params)``). Quantized leaves are recognised by their ``q``,
``s`` and ``axis`` attributes; layers may be a list of dicts or one
dict of stacked [L, ...] arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import QTensor


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                 # a writable copy torch can share
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes, which torch.from_numpy
        # rejects: move the bits as uint16 and reinterpret them
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Convert a numpy-leaved JAX params tree (dicts, lists, QTensor-like
    leaves) to torch tensors on ``device``, keeping its structure. Each
    leaf is a fresh tensor of its own (stacked [L, ...] layers too), so
    it can take ``requires_grad_()`` and in-place optimizer updates."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if all(hasattr(node, a) for a in ("q", "s", "axis")):
            return QTensor(q=_tensor(node.q, dev), s=_tensor(node.s, dev),
                           axis=int(node.axis))
        return _tensor(node, dev)

    return walk(tree)
