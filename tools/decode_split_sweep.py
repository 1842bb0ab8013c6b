#!/usr/bin/env python3
"""B5 at the HD256 generation read (``chip_smoke.DECODE_HD256``, pos
2048) with the split count forced to each of ``SPLITS``: the split and
merge kernels of the bf16 and int8 reads and SDPA over the live slots,
timed by ``chip_smoke._decode_profile`` (one profiler session per split
count, the L2 flushed before each call). The wrapper's own count comes
from ``decode_n_split`` with one CTA per SM; this reads the counts
around it. Each forced read is first held to the plain version row by
row (``chip_smoke._bf16_reading``: within each row's allowance of an f32
reference).

Needs one CUDA card; from the repo root: ``python3 tools/decode_split_sweep.py``.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from tpu_dra_driver_torch.workloads.ops import decode_attention as da  # noqa: E402,E501

# 33 is two CTAs per SM's count (one tile a split at pos 2048), 16 one
# CTA per SM's (the route's), 50 one split per tile of the cache
SPLITS = (8, 11, 16, 22, 33, 50)


def _hold(n, int8, q, k, v, ks, vs, pos) -> None:
    """The forced read within each row's allowance of an f32 reference."""
    got = da.flash_decode_attention(q, k, v, pos, ks, vs)
    plain = da.flash_decode_attention_plain(q, k, v, pos, ks, vs)
    ref = da.flash_decode_attention_plain(
        q.float(), k if int8 else k.float(), v if int8 else v.float(), pos,
        ks, vs)
    over = cs._bf16_reading(got, plain, ref)["over"]
    print(f"  {n} splits, int8 {int8}: worst row at {over:.3f} of its "
          f"allowance")
    if not over <= 1.0:
        raise AssertionError(f"B5 at {n} splits disagrees: {over}")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card(quiet=True))
    pos = cs.DECODE_BF16_POS[0]
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=cs.DEV)
    chosen = da.decode_n_split
    own = chosen(cs.DECODE_HD256[3], cs.DECODE_HD256[0] * cs.DECODE_HD256[2],
                 da._sm_count(torch.device(cs.DEV)),
                 da.ctas_per_sm(torch.bfloat16, cs.DECODE_HD256[4]))
    print(f"the route's split count at {cs.DECODE_HD256}: {own}")
    try:
        for n in SPLITS:
            da.decode_n_split = lambda *args, n=n: n
            gen = torch.Generator().manual_seed(9)
            print(f"== {n} splits")
            for int8 in (False, True):
                _hold(n, int8, *cs._decode_inputs(
                    cs.DECODE_HD256, torch.bfloat16, gen, int8=int8), pos)
            cs._decode_profile(gen, flush, pos, cs.DECODE_HD256)
    finally:
        da.decode_n_split = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
