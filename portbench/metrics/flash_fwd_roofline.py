"""B1's share of its bound: Q K^T and P V over the causal or windowed
band of every layer's forward in the traced steps, over the bf16 peak,
over B1's device time."""

from portbench import work

FAMILIES = ("flash_fwd",)


def read(r):
    s, c = r.shape, r.counters
    seconds, _ = r.trace.family_seconds(FAMILIES[0])
    flops = c["traced_steps"] * s.n_layers \
        * work.flash_fwd_flops(c["rows"], s.n_heads, c["seq"], s.head_dim,
                               s.window)
    return work.share(flops, work.PEAK_BF16_FLOPS, seconds)
