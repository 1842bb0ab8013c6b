"""The decode steps' share of the card's bf16 peak over the whole window
(host clock): two operations a weight a generated token, with the head,
and Q K^T and P V over each row's keys, over the window's seconds."""

from portbench import work


def read(r):
    s, c = r.shape, r.counters
    flops = 2.0 * work.matmul_params(
        s.d_model, s.n_heads, s.n_kv_heads, s.d_ff, s.n_layers, s.vocab) \
        * c["window_decode_tokens"] \
        + 4.0 * s.n_layers * s.d_model * c["window_decode_keys"]
    return work.share(flops, work.PEAK_BF16_FLOPS, c["window_s"])
