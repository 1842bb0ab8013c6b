"""B2 and B3's share of their bound: five products over the band of
every layer's backward in the traced steps, over the bf16 peak, over
B2 and B3's device time."""

from portbench import work

FAMILIES = ("flash_bwd",)


def read(r):
    s, c = r.shape, r.counters
    seconds, _ = r.trace.family_seconds(FAMILIES[0])
    flops = c["traced_steps"] * s.n_layers * work.flash_bwd_flops(
        c["rows"], s.n_heads, c["seq"], s.head_dim, s.window)
    return work.share(flops, work.PEAK_BF16_FLOPS, seconds)
