"""Port parity for the paged KV cache: ``pool_append``, the oracle, and
``paged_decode_attention`` (CPU tensors take the kernel's plain version)
against the JAX Pallas kernel run in interpret mode.

Tolerances: fp32 compares to 1e-5 (summation order of a few dozen
terms differs between the online softmax and the plain one); bf16 to
2e-2, since P is rounded to bf16 against the running max in the JAX
kernel and against the final max in the plain version, about one bf16
ulp (2^-8) of each weight.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads.ops import paged_attention as jpa
from tpu_dra_driver_torch.workloads.ops import paged_attention as tpa

B, H, H_KV, HD, BLOCK_T, N_BLOCKS, MAX_BLOCKS = 4, 4, 2, 16, 8, 16, 6
TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case(lens, seed=0, garbage=True, block_t=BLOCK_T,
          max_blocks=MAX_BLOCKS, n_blocks=N_BLOCKS, h_kv=H_KV, hd=HD, h=H):
    """Random pools with each row's live blocks at shuffled physical ids
    (block 0 stays the null block) and, when ``garbage``, table entries
    past the live range that are not valid block ids."""
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((n_blocks, h_kv, block_t, hd)).astype(
        np.float32)
    pool_v = rng.standard_normal(pool_k.shape).astype(np.float32)
    q = rng.standard_normal((B, h, 1, hd)).astype(np.float32)
    phys = iter(rng.permutation(np.arange(1, n_blocks)))
    table = np.zeros((B, max_blocks), np.int32)
    for i, n in enumerate(lens):
        live = -(-n // block_t)
        for j in range(live):
            table[i, j] = next(phys)
        if garbage:
            table[i, max(live, 1):] = 10_000 + i
    return q, pool_k, pool_v, table, np.asarray(lens, np.int32)


def _jax_kernel(q, pk, pv, table, lens, n_live, dtype=jnp.float32):
    out = jpa.paged_decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(pk, dtype), jnp.asarray(pv, dtype),
        jnp.asarray(table), jnp.asarray(lens), interpret=True,
        n_live_blocks=n_live)
    return np.asarray(out.astype(jnp.float32))


def _port(q, pk, pv, table, lens, n_live, dtype=torch.float32):
    def t(a):
        return torch.from_numpy(a).to(dtype)
    return tpa.paged_decode_attention(
        t(q), t(pk), t(pv), torch.from_numpy(table), torch.from_numpy(lens),
        n_live_blocks=n_live).float().numpy()


@pytest.mark.parametrize("lens,n_live", [
    ((0, 8, 13, 21), 4),      # a length-0 row, a row on a block edge
    ((16, 1, 24, 7), 3),      # every live block walked, edges at 16 and 24
])
def test_kernel_path_matches_pallas_kernel_fp32(lens, n_live):
    case = _case(lens)
    launches = tpa.paged_decode_attention.launches
    got = _port(*case, n_live)
    assert tpa.paged_decode_attention.launches == launches  # CPU: no kernel
    want = _jax_kernel(*case, n_live)
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    q, pk, pv, table, jlens = case
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any(), "a length-0 row gives 0"
            table = table.copy()
            table[i, 0] = 10_000        # not followed: the row reads nothing
    np.testing.assert_array_equal(_port(q, pk, pv, table, jlens, n_live),
                                  got)


def test_kernel_path_matches_pallas_kernel_bf16():
    case = _case((5, 0, 17, 24), seed=1)
    got = _port(*case, 4, dtype=torch.bfloat16)
    want = _jax_kernel(*case, 4, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, **TOL["bfloat16"])


# the edges of the kernel's split into chunks of 64 tokens: rows ending
# one token into a chunk (65, 129), rows of exactly one or two chunks (64,
# 128), chunks spanning several blocks (block_t 8 and 16) and blocks
# spanning several chunks (block_t 128); the walk is the longest row's
# blocks rounded up to a power of two, as the engine's bucket. At head
# dim 256 in bf16 (8 query heads over one KV head) the tensor-core
# kernel's chunks of 32 tokens: rows ending one token into a chunk (33,
# 97), of exactly one chunk (32), a token short of one (31), and four
# 8-token blocks to a chunk
GQA4 = dict(h_kv=H_KV, hd=HD, h=H)
GQA8_HD256 = dict(h_kv=1, hd=256, h=8)


EDGE_CASES = [
    (8, (65, 64, 0, 1), torch.float32, GQA4),
    (8, (129, 128, 63, 7), torch.float32, GQA4),
    (16, (65, 64, 17, 129), torch.float32, GQA4),
    (16, (65, 1, 0, 64), torch.bfloat16, GQA4),
    (128, (65, 64, 0, 200), torch.float32, GQA4),
    (8, (33, 32, 0, 1), torch.bfloat16, GQA8_HD256),
    (8, (97, 31, 9, 64), torch.bfloat16, GQA8_HD256),
    (128, (33, 0, 129, 200), torch.bfloat16, GQA8_HD256),
]


@pytest.mark.parametrize(
    "block_t,lens,dtype,shape", EDGE_CASES,
    ids=[f"{c[0]}-lens{i}-dtype{i}" + ("-hd256" if c[3] is GQA8_HD256
                                        else "")
         for i, c in enumerate(EDGE_CASES)])
def test_split_edges_match_pallas_kernel(block_t, lens, dtype, shape):
    live = -(-max(lens) // block_t)
    n_live = 1 << (live - 1).bit_length()
    case = _case(lens, seed=block_t + len(lens), block_t=block_t,
                 max_blocks=n_live + 2,
                 n_blocks=sum(-(-n // block_t) for n in lens) + 1, **shape)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port(*case, n_live, dtype=dtype)
    want = _jax_kernel(*case, n_live, dtype=jdtype)
    tol = TOL[np.float32] if dtype == torch.float32 else TOL["bfloat16"]
    np.testing.assert_allclose(got, want, **tol)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any(), "a length-0 row gives 0"


# head dim 256 over one KV head (Gemma-class MQA), the kernel's widest
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_matches_pallas_kernel(dtype):
    lens = (0, 9, 40, 23)
    case = _case(lens, seed=7, max_blocks=8, h_kv=1, hd=256)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port(*case, 8, dtype=dtype)
    want = _jax_kernel(*case, 8, dtype=jdtype)
    tol = TOL[np.float32] if dtype == torch.float32 else TOL["bfloat16"]
    np.testing.assert_allclose(got, want, **tol)
    assert got.shape == (B, H, 1, 256) and not got[0].any()


def test_split_covers_the_walk_in_chunks():
    # CTAs per (sequence, KV head): chunks of 64 tokens over the walk
    assert tpa._n_split(8, 128) == 16          # the serving read
    assert tpa._n_split(1, 8) == 1             # one CTA writes the output
    assert tpa._n_split(8, 8) == 1
    assert tpa._n_split(9, 8) == 2
    assert tpa._n_split(5, 16) == 2
    assert tpa._n_split(1, 128) == 2           # two chunks share a block
    # bf16 takes the tensor-core kernel's chunks of 32, f32 the FMA
    # kernel's of 64: the serving reads (hd 128, and hd 256 over one KV
    # head) walk 8 blocks of 128 in 32 chunks
    assert tpa._chunk(torch.bfloat16) == tpa._MMA_CHUNK == 32
    assert tpa._chunk(torch.float32) == tpa._CHUNK
    assert tpa._n_split(8, 128, tpa._chunk(torch.bfloat16)) == 32
    assert tpa._n_split(1, 8, 32) == 1
    assert tpa._n_split(5, 8, 32) == 2
    # the wrapper's chunks are the kernel's
    src = (Path(tpa.__file__).parents[1] / "csrc" / "paged_attention.cu")
    assert f"constexpr int kChunk = {tpa._CHUNK};" in src.read_text()
    assert f"constexpr int kMmaChunk = {tpa._MMA_CHUNK};" in src.read_text()


def test_n_live_blocks_truncates_like_the_pallas_kernel():
    # the caller contract is max(lens) <= n_live_blocks * block_t; past it
    # both walk only n_live_blocks columns
    case = _case((20, 9, 3, 12), seed=2)
    np.testing.assert_allclose(_port(*case, 2), _jax_kernel(*case, 2),
                               **TOL[np.float32])


def test_reference_oracle_matches_jax_oracle_including_empty_rows():
    q, pk, pv, table, lens = _case((0, 8, 13, 21), seed=3, garbage=False)
    want = jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lens))
    got = tpa.paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[np.float32])
    # the oracle's length-0 row is softmax's uniform mean, not 0; every
    # other row agrees with the kernel path
    assert got[0].abs().sum() > 0
    kern = _port(q, pk, pv, table, lens, MAX_BLOCKS)
    np.testing.assert_allclose(kern[1:], got.numpy()[1:], **TOL[np.float32])


def test_pool_append_matches_reference():
    rng = np.random.default_rng(4)
    pk, pv = (rng.standard_normal((N_BLOCKS, H_KV, BLOCK_T, HD)).astype(
        np.float32) for _ in range(2))
    table = np.zeros((B, MAX_BLOCKS), np.int32)
    table[0, :2] = [3, 7]
    table[1, :3] = [2, 9, 4]
    table[3, :1] = [11]                   # row 2 inactive: null block
    lens = np.array([8, 17, 0, 5], np.int32)
    k, v = (rng.standard_normal((B, H_KV, HD)).astype(np.float32)
            for _ in range(2))
    jk, jv = jpa.pool_append(jnp.asarray(pk), jnp.asarray(pv),
                             jnp.asarray(table), jnp.asarray(lens),
                             jnp.asarray(k), jnp.asarray(v))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tpa.pool_append(tk, tv, torch.from_numpy(table),
                          torch.from_numpy(lens), torch.from_numpy(k),
                          torch.from_numpy(v))
    assert out[0] is tk and out[1] is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_init_pool_and_argument_checks():
    pk, pv = tpa.init_pool(5, 8, 2, 16, torch.float32, device="cpu")
    assert pk.shape == (5, 2, 8, 16) and not pk.any() and not pv.any()
    q, pk_, pv_, table, lens = (torch.from_numpy(a)
                                for a in _case((3, 4, 5, 6)))
    with pytest.raises(ValueError, match="n_live_blocks"):
        tpa.paged_decode_attention(q, pk_, pv_, table, lens, n_live_blocks=7)
    with pytest.raises(ValueError, match="g=1"):
        tpa.paged_decode_attention(q.expand(B, H, 2, HD), pk_, pv_, table,
                                   lens)
    # neither CPU nor CUDA: the wrapper raises rather than picking a path
    meta = [t.to("meta") for t in (q, pk_, pv_, table, lens)]
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_decode_attention(*meta)
