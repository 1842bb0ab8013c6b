"""The one generator of traffic. A mix is a data file,
``traffic/<mix>.json``, of parameters; its ``kind`` says which of three
shapes of load it describes:

- ``packed``: training batches of ``rows`` rows of ``seq`` tokens
  (``seq + 1`` drawn, the last as the final target), causal across the
  pack, a fresh batch every step;
- ``backlog``: a closed backlog of serving requests, prompts and outputs
  drawn from ``prompt`` and ``output`` ranges; the first ``first_wave``
  carry a seeded share of their outputs in their prompts, so that the
  rows a run starts from are at every stage of their lives;
- ``batch``: whole batches of ``rows`` prompts of ``prompt`` tokens, each
  to ``output`` more tokens, one batch a call.

Sizes come from a seed, but every seed gets the same sizes: lengths are
the quantiles of their distribution, each block of ``stratum`` requests
holding the same set in another order. So runs with different seeds do
the same work, in another order, on other tokens.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(mix: str) -> Dict:
    return json.loads((TRAFFIC_DIR / f"{mix}.json").read_text())


def _quantiles(lo: int, hi: int, n: int, dist: str) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if dist == "loguniform":
        x = lo * (hi / lo) ** u
    elif dist == "uniform":
        x = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.rint(x).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


@dataclass
class Request:
    prompt: np.ndarray       # int32 token ids
    max_new: int             # tokens to generate, the first included
    carried: int = 0         # output tokens already folded into the prompt


def backlog(mix: Dict, seed: int, vocab: int) -> List[Request]:
    """The requests of a ``backlog`` mix, in the order they are sent."""
    n, stratum = mix["requests"], mix["stratum"]
    if n % stratum:
        raise ValueError("requests must be a whole number of strata")
    g = rng(seed, 1)
    p_set = _quantiles(*mix["prompt"], stratum, mix["dist"])
    o_set = _quantiles(*mix["output"], stratum, mix["dist"])
    prompts = np.concatenate([g.permutation(p_set) for _ in range(n // stratum)])
    outputs = np.concatenate([g.permutation(o_set) for _ in range(n // stratum)])
    if int((p_set.max() + o_set.max())) > mix["max_context"]:
        raise ValueError("a request can pass max_context")
    wave = mix["first_wave"]
    shares = g.permutation((np.arange(wave) + 0.5) / wave)
    out = []
    for i in range(n):
        carried = int(shares[i] * outputs[i]) if i < wave else 0
        toks = g.integers(0, vocab, int(prompts[i]) + carried, dtype=np.int32)
        out.append(Request(toks, int(outputs[i]) - carried, carried))
    return out


def packed_batch(mix: Dict, seed: int, step: int, vocab: int,
                 device) -> torch.Tensor:
    """Step ``step``'s [rows, seq + 1] tokens, drawn on ``device``."""
    from portbench.weights import generator
    g = generator(seed, device, stream=1000 + step)
    return torch.randint(0, vocab, (mix["rows"], mix["seq"] + 1),
                         generator=g, device=device, dtype=torch.int64)


def batch_prompts(mix: Dict, seed: int, call: int, vocab: int) -> np.ndarray:
    """Call ``call``'s [rows, prompt] prompts."""
    g = rng(seed, 10_000 + call)
    return g.integers(0, vocab, (mix["rows"], mix["prompt"]), dtype=np.int32)
