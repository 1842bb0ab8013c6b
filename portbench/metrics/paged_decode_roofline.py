"""B4's share of its bound: the bytes the traced decode reads need (each
active row's live K and V at its length, its q and its output, in every
layer) over the HBM peak, over B4's device time (split and merge)."""

from portbench import work

FAMILIES = ("paged_decode",)


def read(r):
    seconds, _ = r.trace.family_seconds(FAMILIES[0])
    s = r.shape
    need = work.decode_attn_bytes(r.counters["traced_contexts"], s.n_heads,
                                  s.n_kv_heads, s.head_dim, s.n_layers)
    return work.share(need, work.PEAK_HBM_BYTES_S, seconds)
