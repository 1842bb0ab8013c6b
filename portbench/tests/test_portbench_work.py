"""The operation and byte counts of the rooflines and MFU, at shapes
small enough to count by hand, and the kernel families' patterns."""

import pytest

from portbench import harness, trace, work


def test_band_pairs_causal_and_window():
    assert work.band_pairs(4) == 4 + 3 + 2 + 1
    # rows 0..5 with a window of 3 see 1, 2, 3, 3, 3, 3 columns
    assert work.band_pairs(6, 3) == 15
    assert work.band_pairs(16384, 4096) == 4096 * 4097 // 2 \
        + (16384 - 4096) * 4096
    # a window as long as the sequence excludes nothing
    assert work.band_pairs(4096, 4096) == work.band_pairs(4096)


def test_flash_flops():
    # b 2, h 3, t 4, hd 8: 10 pairs a head, 4 operations a pair and dim
    assert work.flash_fwd_flops(2, 3, 4, 8) == 4 * 2 * 3 * 8 * 10
    assert work.flash_bwd_flops(2, 3, 4, 8) == 2.5 * 4 * 2 * 3 * 8 * 10
    assert work.flash_fwd_flops(1, 1, 6, 2, window=3) == 4 * 2 * 15


def test_decode_bytes_ragged():
    # rows of 1, 5 and 10 keys; h 4, h_kv 2, hd 8, bf16, one layer: a key
    # is K and V of 2 heads of 8 (64 bytes), q and out 2 x 4 x 8 x 2
    assert work.decode_attn_bytes([1, 5, 10], 4, 2, 8, 1) \
        == 16 * 64 + 3 * 128
    assert work.decode_attn_bytes([1, 5, 10], 4, 2, 8, 3) \
        == 3 * (16 * 64 + 3 * 128)


def test_model_flops():
    # d 8, 2 heads of 4 with 1 KV head, d_ff 16, 1 layer, vocab 10:
    # wqkv 8 x 16, wo 8 x 8, up and down 8 x 16 each, head 10 x 8
    p = work.matmul_params(8, 2, 1, 16, 1, 10)
    assert p == 8 * 16 + 64 + 2 * 128 + 80
    assert work.decode_token_flops(5, 8, 2, 1, 16, 1, 10) \
        == 2 * p + 4 * 1 * 8 * 5
    # two rows of 4: 6 a weight a token, and 3 x the causal forward
    assert work.train_step_flops(8, 4, 8, 2, 1, 16, 1, 10) \
        == 6 * p * 8 + 3 * work.flash_fwd_flops(2, 2, 4, 4)


def test_share():
    assert work.share(2e12, 1e12, 4.0) == pytest.approx(50.0)
    assert work.share(1.0, 1e12, 0.0) is None
    assert work.share(0.0, 1e12, 1.0) is None


NAMES = {
    "flash_fwd": "void (anonymous namespace)::flash_fwd_kernel_sm90<128>"
                 "(CUtensorMap, CUtensorMap, CUtensorMap, Args)",
    "flash_bwd": "void (anonymous namespace)::flash_bwd_dkv_kernel_sm90<128>"
                 "(CUtensorMap)",
    "paged_decode": "void (anonymous namespace)::"
                    "paged_decode_split_mma_kernel<128, 256>(Args)",
    "decode": "void (anonymous namespace)::flash_decode_mma_kernel"
              "<__nv_bfloat16, 128>(Args)",
    "cublas": "nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT",
}


@pytest.mark.parametrize("family", sorted(NAMES))
def test_each_family_matches_its_kernel_only(family):
    for other, name in NAMES.items():
        hit = any(p.search(name) for p in trace.kernel_patterns(family))
        assert hit == (other == family), (family, name)


def test_elementwise_share_and_missing_families():
    def iv(name, dur):
        return trace.Interval(name, 0, dur, "kernel", "chunk", True)

    kernels = [iv(NAMES["cublas"], 30), iv(NAMES["decode"], 20),
               iv("void at::native::vectorized_elementwise_kernel<4>", 50)]
    assert trace.elementwise_share(kernels) == pytest.approx(50.0)

    class Fake(trace.DeviceTrace):
        def __init__(self):
            self.intervals = kernels

    assert trace.check_families(Fake(), ["decode", "flash_fwd"]) \
        == ["flash_fwd"]


def test_union_seconds():
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40)]) \
        == pytest.approx(30e-9)
    assert trace.union_seconds([]) == 0.0


def test_grad_spread_leaves_out_the_factor_all_leaves_share():
    ref, counted = [1.0, 2.0, 4.0], [True, True, True]
    # every leaf 1% high: the worst leaf reads 1%, the spread nothing
    prog = [1.01, 2.02, 4.04]
    assert harness.worst_leaf_gap(prog, ref, counted) == pytest.approx(0.01)
    scale = harness.common_scale(prog, ref, counted)
    assert scale == pytest.approx(1.01)
    assert harness.worst_leaf_gap(prog, ref, counted, scale) \
        == pytest.approx(0.0, abs=1e-12)
    # one leaf 5% high: the median ratio is 1, and the spread reads 0.2 / 4
    prog = [1.0, 2.0, 4.2]
    scale = harness.common_scale(prog, ref, counted)
    assert scale == 1.0
    assert harness.worst_leaf_gap(prog, ref, counted, scale) \
        == pytest.approx(0.05)
    # leaves that did not move share no factor, and read a gap of 1
    prog = [0.0, 0.0, 0.0]
    scale = harness.common_scale(prog, ref, counted)
    assert scale == 1.0
    assert harness.worst_leaf_gap(prog, ref, counted, scale) == 1.0
