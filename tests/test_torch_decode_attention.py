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
