"""Cache-length helpers of the reference's ``ops/decode_attention.py``.

Only what ``init_kv_cache`` needs is ported here; the flash-decode
kernel over a contiguous cache is not ported yet.
"""

from __future__ import annotations

# cache-block width full-length caches are padded to a multiple of
KV_BLOCK = 128


def round_up_kv(n: int) -> int:
    """n rounded up to the next KV_BLOCK multiple."""
    return -(-n // KV_BLOCK) * KV_BLOCK
