"""The training steps' share of the card's bf16 peak over the whole
window (host clock): six operations a weight a token and the attention
band's forward and backward, with no recomputation counted."""

from portbench import work


def read(r):
    s, c = r.shape, r.counters
    per_step = work.train_step_flops(
        c["rows"] * c["seq"], c["seq"], s.d_model, s.n_heads, s.n_kv_heads,
        s.d_ff, s.n_layers, s.vocab, s.window)
    return work.share(per_step * c["window_steps"], work.PEAK_BF16_FLOPS,
                      c["window_s"])
