"""Port parity for the flash-decode read over a contiguous KV cache.

The port's ``flash_decode_attention`` on CPU tensors (its kernel's
plain version) is held against the reference's Pallas kernel in
interpret mode and against the reference's masked read
``_decode_attention``, on the same numpy-seeded fp32 inputs.

Tolerance 1e-5 (relative and absolute): in fp32 the three differ only
by summation order over at most 640 slots (about 1e-7 relative), and
the outputs are softmax-weighted averages of O(1) values, while one slot
masked wrongly moves a row by about 1/640 > 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.models.generate import (
    _decode_attention as jax_decode_attention,
)
from tpu_dra_driver.workloads.ops import decode_attention as jd
from tpu_dra_driver_torch.workloads.ops import decode_attention as td

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (b, h, h_kv, L, hd, pos, int8)
CASES = {
    "gqa4_pos0": (2, 8, 2, 640, 64, 0, False),
    "gqa4_pos_mid": (2, 8, 2, 640, 64, 300, False),
    "gqa4_pos_last": (2, 8, 2, 640, 64, 639, False),
    "gqa4_int8_scales": (2, 8, 2, 640, 64, 300, True),
    "int8_pos_last": (1, 4, 2, 384, 32, 383, True),
    "ring_wrapped": (2, 8, 2, 256, 64, 1000, False),
    "ring_wrapped_int8": (1, 4, 1, 256, 16, 700, True),
    # head dim 256 over one KV head (Gemma-class MQA)
    "hd256_mqa_pos_mid": (2, 8, 1, 384, 256, 200, False),
    "hd256_mqa_int8": (2, 8, 1, 384, 256, 383, True),
}

# bf16 queries (and a bf16 or int8 cache) against the Pallas kernel fed
# the same bf16 numbers: 2^-6 of the output's largest |value|. Both sum
# in f32 but round P to bf16 for P.V against different running maxima
# (one bf16 ulp, 2^-8, of each weight) and round the output to bf16.
# Observed: at most 2.6e-3 of that value.
TOL_BF16 = 2.0 ** -6
# name -> (b, h, h_kv, L, hd, pos, int8), bf16 queries
BF16_CASES = {
    "hd256_bf16": (2, 8, 1, 384, 256, 300, False),
    "hd256_bf16_int8": (2, 8, 1, 384, 256, 300, True),
    "hd128_bf16": (2, 8, 2, 384, 128, 300, False),
}


def _inputs(b, h, h_kv, L, hd, int8, seed=0):
    """(q, k, v, k_scale, v_scale) as numpy arrays; scales None for an
    fp cache."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, 1, hd).astype(np.float32)
    if not int8:
        k = rng.randn(b, h_kv, L, hd).astype(np.float32)
        v = rng.randn(b, h_kv, L, hd).astype(np.float32)
        return q, k, v, None, None
    k = rng.randint(-127, 128, (b, h_kv, L, hd)).astype(np.int8)
    v = rng.randint(-127, 128, (b, h_kv, L, hd)).astype(np.int8)
    ks = (np.abs(rng.randn(b, h_kv, L)) * 0.02 + 0.01).astype(np.float32)
    vs = (np.abs(rng.randn(b, h_kv, L)) * 0.02 + 0.01).astype(np.float32)
    return q, k, v, ks, vs


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_pallas_kernel_and_masked_read(name):
    b, h, h_kv, L, hd, pos, int8 = CASES[name]
    arrays = _inputs(b, h, h_kv, L, hd, int8)
    got = td.flash_decode_attention(*_torch(*arrays[:3]), pos,
                                    *_torch(*arrays[3:])).numpy()
    q, k, v, ks, vs = _jax(*arrays)
    kernel = jd.flash_decode_attention(q, k, v, jnp.int32(pos), ks, vs,
                                       interpret=True)
    masked = jax_decode_attention(q, k, v, jnp.int32(pos), ks, vs)
    assert got.shape == (b, h, 1, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(masked), **TOL)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_queries_match_pallas_kernel(name):
    b, h, h_kv, L, hd, pos, int8 = BF16_CASES[name]
    q, k, v, ks, vs = _inputs(b, h, h_kv, L, hd, int8, seed=1)

    def port(x):
        x = torch.from_numpy(x)
        return x if x.dtype == torch.int8 else x.to(torch.bfloat16)

    def ref(x):
        return jnp.asarray(x) if x.dtype == np.int8 \
            else jnp.asarray(x, jnp.bfloat16)

    got = td.flash_decode_attention(port(q), port(k), port(v), pos,
                                    *_torch(ks, vs))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, 1, hd)
    want = jd.flash_decode_attention(ref(q), ref(k), ref(v), jnp.int32(pos),
                                     *_jax(ks, vs), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16 * np.abs(want).max())


def test_plain_version_reads_only_visible_slots():
    b, h, h_kv, L, hd = 1, 4, 2, 256, 16
    q, k, v, _, _ = _torch(*_inputs(b, h, h_kv, L, hd, False))
    want = td.flash_decode_attention(q, k, v, 40)
    k[:, :, 41:] = float("nan")
    v[:, :, 41:] = float("nan")
    np.testing.assert_array_equal(td.flash_decode_attention(q, k, v, 40),
                                  want)


@pytest.mark.parametrize("L,requested,want", [
    (3584, 512, 512),
    (3200, 512, 128),       # largest 128-multiple divisor
    (640, 512, 128),
    (1280, 512, 256),
    (640, 384, 128),        # non-pow2 request
    (70, 512, 0),
    (128, 512, 128),
])
def test_decode_block_t(L, requested, want):
    assert td.decode_block_t(L, requested) == want
    assert jd.decode_block_t(L, requested) == want


def _bad_args(lib, to):
    """The reference's four rejected argument sets, for ``lib``."""
    q, k, v, _, _ = to(*_inputs(2, 8, 2, 640, 64, False))
    cat = torch.cat if to is _torch else jnp.concatenate
    i8 = (lambda x: x.to(torch.int8)) if to is _torch \
        else (lambda x: x.astype(jnp.int8))
    zeros = (lambda *s: torch.zeros(s)) if to is _torch \
        else (lambda *s: jnp.zeros(s))
    kw = {} if to is _torch else {"interpret": True}
    pos = 0 if to is _torch else jnp.int32(0)
    return {
        "g=1": lambda: lib.flash_decode_attention(
            cat([q, q], 2), k, v, pos, **kw),
        "k_scale": lambda: lib.flash_decode_attention(
            q, i8(k), i8(v), pos, zeros(2, 2, 10), zeros(2, 2, 10), **kw),
        "v_scale": lambda: lib.flash_decode_attention(
            q, i8(k), i8(v), pos, zeros(2, 2, 640), zeros(2, 2, 10), **kw),
        "divisor": lambda: lib.flash_decode_attention(
            q, k[:, :, :70], v[:, :, :70], pos, **kw),
    }


@pytest.mark.parametrize("match", ["g=1", "k_scale", "v_scale", "divisor"])
def test_bad_arguments_raise_as_in_the_reference(match):
    for lib, to in ((td, _torch), (jd, _jax)):
        with pytest.raises(ValueError, match=match):
            _bad_args(lib, to)[match]()


def test_non_cpu_tensors_never_take_the_plain_version():
    q, k, v, _, _ = _torch(*_inputs(1, 4, 2, 128, 16, False))
    with pytest.raises(ValueError, match="CUDA device"):
        td.flash_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                  3)
    with pytest.raises(ValueError, match="CUDA device"):
        td.flash_decode_attention(q, k.to("meta"), v, 3)
    assert td.flash_decode_attention.launches == 0


# ``pos`` as a tensor: the reference takes ``atleast_1d(pos)`` of an
# int32 array; the port takes an int32 tensor of shape [] or [1]
@pytest.mark.parametrize("shape", [(), (1,)])
@pytest.mark.parametrize("name", ["gqa4_pos_mid", "gqa4_int8_scales",
                                  "ring_wrapped"])
def test_pos_tensor_matches_int_and_pallas_kernel(name, shape):
    b, h, h_kv, L, hd, pos, int8 = CASES[name]
    arrays = _inputs(b, h, h_kv, L, hd, int8)
    q, k, v, ks, vs = _torch(*arrays)
    want = td.flash_decode_attention(q, k, v, pos, ks, vs)
    pos_t = torch.full(shape, pos, dtype=torch.int32)
    got = td.flash_decode_attention(q, k, v, pos_t, ks, vs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jq, jk, jv, jks, jvs = _jax(*arrays)
    kernel = jd.flash_decode_attention(jq, jk, jv,
                                       jnp.full(shape, pos, jnp.int32),
                                       jks, jvs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)


@pytest.mark.parametrize("bad", [
    torch.tensor([3, 4], dtype=torch.int32),      # two positions
    torch.tensor([[3]], dtype=torch.int32),       # [1, 1]
    torch.tensor(3, dtype=torch.int64),           # not int32
    torch.tensor(-1, dtype=torch.int32),          # a CPU pos is checked
])
def test_bad_pos_tensor_raises(bad):
    q, k, v, _, _ = _torch(*_inputs(1, 4, 2, 128, 16, False))
    with pytest.raises(ValueError, match="pos"):
        td.flash_decode_attention(q, k, v, bad)


def test_cpu_inputs_refuse_a_pos_on_another_device():
    q, k, v, _, _ = _torch(*_inputs(1, 4, 2, 128, 16, False))
    with pytest.raises(ValueError, match="CUDA device"):
        td.flash_decode_attention(q, k, v,
                                  torch.tensor(3, dtype=torch.int32,
                                               device="meta"))
    assert td.flash_decode_attention.launches == 0


# The kernel's grid: splits from L, b * h_kv and the SM count only, and
# from the route's CTAs per SM: two, but one for bf16 queries past head
# dim 128 (the tensor-core kernel with its 192 KiB ring); at most 8, the
# CTAs of one portable thread-block cluster, which merges them, and,
# past clusters of two, about 1.5 CTAs per SM (a GPC packs a cluster's
# CTAs onto as few SMs as fit). No position enters. (L, bh, n_sm, ctas,
# want)
N_SPLIT_CASES = [
    (3200, 32, 132, 2, 6),    # the full-width read: 192 CTAs
    (3200, 512, 132, 2, 1),   # a wide batch: one split, no merge
    (128, 1, 132, 2, 2),      # at most one split per 64-slot tile
    (256, 8, 132, 2, 4),
    (32768, 1, 132, 2, 8),    # one cluster of 8, not 264 splits
    # the HD256 generation read (b 8, one KV head): 8 splits, 64 CTAs of
    # one per SM (16 before the cap: 64 CTAs read as fast as 128)
    (3200, 8, 132, td.ctas_per_sm(torch.bfloat16, 256), 8),
    (3200, 8, 132, td.ctas_per_sm(torch.bfloat16, 160), 8),
    (3200, 8, 132, td.ctas_per_sm(torch.float32, 256), 8),
    (3200, 32, 132, td.ctas_per_sm(torch.bfloat16, 128), 6),
    # the speculative drafts' reads (b 1, 4 KV heads): one split a tile
    (512, 4, 132, td.ctas_per_sm(torch.bfloat16, 128), 8),
    (384, 4, 132, td.ctas_per_sm(torch.bfloat16, 128), 6),
    # the beam's 32 rows: clusters of two, 256 CTAs
    (2176, 128, 132, td.ctas_per_sm(torch.bfloat16, 128), 2),
]


@pytest.mark.parametrize(
    "L,bh,n_sm,ctas,want", N_SPLIT_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[4]}" + ("" if i < 5 else f"-route{i - 5}")
         for i, c in enumerate(N_SPLIT_CASES)])
def test_decode_n_split(L, bh, n_sm, ctas, want):
    assert td.decode_n_split(L, bh, n_sm, ctas) == want
    assert 1 <= want <= td._MAX_SPLITS
    if ctas == 2:                   # the default: two CTAs per SM
        assert td.decode_n_split(L, bh, n_sm) == want


def _live_slots(L, pos):
    return min(pos + 1, L)


# (L, n_split): the full-width read, a split count that does not divide
# the tiles, one split per tile, one split, and a ring
PARTITIONS = [(3200, 8), (640, 3), (256, 4), (384, 1), (256, 7)]


@pytest.mark.parametrize("L,n_split", PARTITIONS)
def test_partition_covers_each_live_slot_once(L, n_split):
    # every position of the cache, and positions past a wrapped ring
    for pos in list(range(L)) + [L, L + 37, 5 * L + 1]:
        n_live = _live_slots(L, pos)
        ranges = td.decode_partition(L, n_live, n_split)
        assert len(ranges) == n_split
        seen = np.zeros(L, dtype=int)
        for start, end in ranges:
            assert 0 <= start <= end <= n_live
            seen[start:end] += 1
            if start < end:
                # whole 64-slot tiles, only the live range's last short
                assert start % 64 == 0
                assert end % 64 == 0 or end == n_live
        assert (seen[:n_live] == 1).all() and (seen[n_live:] == 0).all()
        # balanced: split sizes in tiles differ by at most one
        tiles = [-(-(e - s) // 64) for s, e in ranges]
        assert max(tiles) - min(tiles) <= 1


def _split_then_merge(q, k, v, pos, n_split, ks=None, vs=None):
    """A plain model of the kernel's one launch in f32. Each split (a CTA
    of the row's cluster) publishes its partial (m, l, acc) over its
    slots of ``decode_partition`` with the reference's numerics (taken
    in f64, held in f32); an empty split publishes (NEG_INF, 0, 0). Then
    CTA c takes the head dims [c hd // n, (c + 1) hd // n) and, for each,
    folds every split's state in split order: m = max_s m_s, w_s =
    exp(m_s - m), l = sum_s w_s l_s, acc = sum_s w_s acc_s, and acc over
    max(l, 1e-30)."""
    b, h, _, hd = q.shape
    h_kv, L = k.shape[1], k.shape[2]
    rep = h // h_kv
    qg = q.reshape(b, h_kv, rep, hd).double()
    parts = []
    for start, end in td.decode_partition(L, min(pos + 1, L), n_split):
        if start == end:
            parts.append((torch.full((b, h_kv, rep, 1), td.NEG_INF),
                          torch.zeros((b, h_kv, rep, 1)),
                          torch.zeros((b, h_kv, rep, hd))))
            continue
        s = torch.einsum("bkrd,bktd->bkrt", qg, k[:, :, start:end].double())
        if ks is not None:
            s = s * ks[:, :, None, start:end].double()
        s = s * (1.0 / np.sqrt(hd))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if vs is not None:
            p = p * vs[:, :, None, start:end].double()
        acc = torch.einsum("bkrt,bktd->bkrd", p, v[:, :, start:end].double())
        parts.append((m.float(), l.float(), acc.float()))
    m = parts[0][0]
    for part in parts[1:]:
        m = torch.maximum(m, part[0])
    w = [torch.exp(part[0] - m) for part in parts]
    l = torch.zeros_like(m)
    for wi, part in zip(w, parts):
        l = l + wi * part[1]
    out = torch.full((b, h_kv, rep, hd), float("nan"))
    for c in range(n_split):
        d0, d1 = c * hd // n_split, (c + 1) * hd // n_split
        acc = torch.zeros((b, h_kv, rep, d1 - d0))
        for wi, part in zip(w, parts):
            acc = acc + wi * part[2][..., d0:d1]
        out[..., d0:d1] = acc / l.clamp_min(1e-30)
    assert not out.isnan().any()          # the slices cover every dim
    return out.reshape(b, h, 1, hd)


# the HD256 generation read's split count (b 8, one KV head, 132 SMs,
# bf16 queries at hd 256): its partition, at b 1 here
HD256_SPLITS = td.decode_n_split(3200, 8, 132,
                                 td.ctas_per_sm(torch.bfloat16, 256))
# ... and those of the other reads on the card's paths (132 SMs, bf16
# queries at hd 128): generation (b 8, 4 KV heads), the beam's 32 rows,
# the drafts (b 1) over caches of 512 and 384 slots
READ_SPLITS = {
    "hd128": td.decode_n_split(3200, 32, 132,
                               td.ctas_per_sm(torch.bfloat16, 128)),
    "beam": td.decode_n_split(2176, 128, 132,
                              td.ctas_per_sm(torch.bfloat16, 128)),
    "draft512": td.decode_n_split(512, 4, 132,
                                  td.ctas_per_sm(torch.bfloat16, 128)),
    "draft384": td.decode_n_split(384, 4, 132,
                                  td.ctas_per_sm(torch.bfloat16, 128)),
}
GQA4_HD64 = (2, 8, 2, 64)           # (b, h, h_kv, hd)
GQA8_HD256 = (1, 8, 1, 256)         # Gemma-class: 8 query heads, 1 KV head
GQA4_HD128 = (1, 16, 4, 128)        # the generation cell's heads, b 1

# (name, L, pos, n_split, int8, (b, h, h_kv, hd), bf16): the first slot,
# a tile less one, one tile, a tile and a slot, the last slot, and a
# wrapped ring; three splits leave most of them empty at short
# positions; then the HD256 read's partition (2-3 tiles a split at pos
# 2048, most splits empty at pos 95) in f32, bf16 and int8
MERGE_CASES = [
    ("pos0", 640, 0, 3, False, GQA4_HD64, False),
    ("pos63", 640, 63, 3, False, GQA4_HD64, False),
    ("pos64", 640, 64, 3, False, GQA4_HD64, False),
    ("pos65", 640, 65, 3, False, GQA4_HD64, False),
    ("pos_last", 640, 639, 3, False, GQA4_HD64, False),
    ("pos_last_int8", 640, 639, 4, True, GQA4_HD64, False),
    ("ring_wrapped", 256, 1000, 4, False, GQA4_HD64, False),
    ("one_split_per_tile", 256, 200, 4, False, GQA4_HD64, False),
    ("hd256_gqa8_pos2048", 3200, 2048, HD256_SPLITS, False, GQA8_HD256,
     False),
    ("hd256_gqa8_pos95", 3200, 95, HD256_SPLITS, False, GQA8_HD256, False),
    ("hd256_gqa8_pos2048_bf16", 3200, 2048, HD256_SPLITS, False, GQA8_HD256,
     True),
    ("hd256_gqa8_pos2048_int8", 3200, 2048, HD256_SPLITS, True, GQA8_HD256,
     False),
    # the split counts of the reads on the card's paths, bf16 queries over
    # bf16 and int8 caches
    ("hd256_gqa8_pos2048_bf16_int8", 3200, 2048, HD256_SPLITS, True,
     GQA8_HD256, True),
    ("hd128_gqa4_pos2048_bf16", 3200, 2048, READ_SPLITS["hd128"], False,
     GQA4_HD128, True),
    ("hd128_gqa4_pos2048_bf16_int8", 3200, 2048, READ_SPLITS["hd128"], True,
     GQA4_HD128, True),
    ("beam_pos2048_bf16", 2176, 2048, READ_SPLITS["beam"], False,
     GQA4_HD128, True),
    ("draft512_pos393_bf16", 512, 393, READ_SPLITS["draft512"], False,
     GQA4_HD128, True),
    ("draft512_pos393_bf16_int8", 512, 393, READ_SPLITS["draft512"], True,
     GQA4_HD128, True),
    ("draft384_pos329_bf16", 384, 329, READ_SPLITS["draft384"], False,
     GQA4_HD128, True),
]


@pytest.mark.parametrize("name,L,pos,n_split,int8,shape,bf16", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_split_then_merge_matches_pallas_kernel(name, L, pos, n_split, int8,
                                                shape, bf16):
    b, h, h_kv, hd = shape
    arrays = _inputs(b, h, h_kv, L, hd, int8, seed=3)
    if bf16:
        # bf16 numbers, held in f32 by the split model, fed to the Pallas
        # kernel in bf16: TOL_BF16 as for the bf16 queries above
        arrays = [a if a is None or a.dtype == np.int8 else np.array(
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in arrays]
    q, k, v, ks, vs = _torch(*arrays)
    got = _split_then_merge(q, k, v, pos, n_split, ks, vs)
    jq, jk, jv, jks, jvs = _jax(*arrays)
    if bf16:
        jq, jk, jv = (x if x.dtype == jnp.int8 else x.astype(jnp.bfloat16)
                      for x in (jq, jk, jv))
    kernel = np.asarray(jd.flash_decode_attention(
        jq, jk, jv, jnp.int32(pos), jks, jvs, interpret=True).astype(
            jnp.float32))
    tol = (dict(rtol=0, atol=TOL_BF16 * np.abs(kernel).max()) if bf16
           else TOL)
    np.testing.assert_allclose(got.numpy(), kernel, **tol)
    np.testing.assert_allclose(
        got.numpy(), td.flash_decode_attention(q, k, v, pos, ks, vs).numpy(),
        **TOL)
