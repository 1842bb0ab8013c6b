"""Seeded weights in the layout the port's transformer takes.

The weights are drawn on the device by one ``torch.Generator`` of that
device, one call per kind of matrix for all layers at once, in the type
they are served in: N(0, 0.02) matrices and unit float32 norm gains, as
the port's own initialiser draws them (on the CPU, leaf by leaf, which
costs seconds at these sizes). The same seed on the same device gives the
same values, so the reference can make them again after the program has
gone, in float32 and one kind at a time.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from portbench.reference.starcoder2 import Shape

STD = 0.02
_SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number; large
    ones are folded into 63 bits) and a stream number, so that weights,
    batches and prompts draw from separate streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) & _SEED_MASK)
    return g


def _kinds(shape: Shape) -> Tuple[Tuple[str, tuple], ...]:
    d, ff = shape.d_model, shape.d_ff
    kv_d = shape.head_dim * shape.n_kv_heads
    return (("wqkv", (d, d + 2 * kv_d)), ("wo", (d, d)),
            ("w_up", (d, ff)), ("w_down", (ff, d)))


def _draw(g: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, STD, generator=g)


def matrices(shape: Shape, seed: int, device,
             dtype=torch.bfloat16) -> Iterator[Tuple[str, torch.Tensor]]:
    """("embed", [vocab, d]), then each kind's [n_layers, ...] stack, in
    draw order."""
    g = generator(seed, device)
    yield "embed", _draw(g, (shape.vocab, shape.d_model), dtype, device)
    for name, dims in _kinds(shape):
        yield name, _draw(g, (shape.n_layers,) + dims, dtype, device)


def make_params(shape: Shape, seed: int, device, dtype=torch.bfloat16,
                as_dtype=None) -> Dict:
    """The params tree: ``embed``, ``layers`` (a list of dicts) and
    ``final_norm``. ``as_dtype`` converts each matrix after it is drawn
    (the reference's float32), one kind at a time."""
    def ones():
        return torch.ones((shape.d_model,), dtype=torch.float32,
                          device=device)

    params: Dict = {"layers": [{"ln1": {"g": ones()}, "ln2": {"g": ones()}}
                               for _ in range(shape.n_layers)],
                    "final_norm": {"g": ones()}}
    for name, w in matrices(shape, seed, device, dtype):
        if as_dtype is not None:
            w = w.to(as_dtype)
        if name == "embed":
            params["embed"] = w
            continue
        for layer, part in zip(params["layers"], w.unbind(0)):
            layer[name] = part
    order = ("ln1", "wqkv", "wo", "ln2", "w_up", "w_down")
    params["layers"] = [{k: layer[k] for k in order}
                        for layer in params["layers"]]
    return {"embed": params["embed"], "layers": params["layers"],
            "final_norm": params["final_norm"]}
