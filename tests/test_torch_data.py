"""The port's input pipeline (``workloads/data.py``) against the
reference, on the CPU.

``packed_lm_batches`` and ``byte_corpus`` are NumPy on both sides and
must agree exactly, batch for batch and document for document: random
documents from a seed list for the packer, and a tree this test writes
(binary files, skipped directories, empty files, byte caps, the fallback
holdout) for the corpus. ``prefetch_to_device`` keeps the reference's
contract (order, abandonment, exceptions at the failed batch, a custom
``put`` owning placement) with ``device="cpu"``; a port train step fed
through it gives the reference's losses on the same packed batches.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra_driver.workloads import data as jd
from tpu_dra_driver.workloads.models import transformer as jt
from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads import data as td
from tpu_dra_driver_torch.workloads.models import transformer as tt

# fp32 losses, port against reference on the same batches: summation
# order only, through a few AdamW steps
TOL_LOSS_REL = 1e-5


def _random_docs(seed, n=None):
    rng = np.random.RandomState(seed)
    n = n if n is not None else rng.randint(0, 40)
    return [rng.randint(1, 500, size=rng.randint(0, 60)) for _ in range(n)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gt, gy), (wt, wy) in zip(got, want):
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gy, wy)


# ------------------------------------------------------ the reference's
# scenarios of tests/test_data.py that need no mesh

def test_packing_concatenates_with_separator_and_shifts_targets():
    docs = [np.array([1, 2, 3]), np.array([4, 5]), np.array([6, 7, 8, 9])]
    batches = list(td.packed_lm_batches(docs, batch=2, seq=2, sep_token=0))
    stream = [1, 2, 3, 0, 4, 5, 0, 6, 7, 8, 9, 0]
    toks, tgts = batches[0]
    assert toks.shape == (2, 2) and tgts.shape == (2, 2)
    np.testing.assert_array_equal(toks, [[1, 2], [0, 4]])
    np.testing.assert_array_equal(tgts, [[2, 3], [4, 5]])
    toks2, tgts2 = batches[1]
    np.testing.assert_array_equal(toks2, [[0, 6], [8, 9]])
    np.testing.assert_array_equal(tgts2, [[6, 7], [9, 0]])
    assert len(batches) == len(stream) // 6


def test_packing_no_remainder_fill():
    docs = [np.arange(1, 10)]
    dropped = list(td.packed_lm_batches(docs, batch=2, seq=2))
    filled = list(td.packed_lm_batches(docs, batch=2, seq=2,
                                       drop_remainder=False))
    assert len(filled) == len(dropped) + 1
    toks, tgts = filled[-1]
    assert toks.shape == (2, 2)


@pytest.mark.parametrize("batch,seq", [(0, 2), (2, 0), (-1, 4)])
def test_packing_rejects_degenerate_shapes(batch, seq):
    with pytest.raises(ValueError):
        next(td.packed_lm_batches([np.arange(4)], batch=batch, seq=seq))


def test_packing_tiny_tail_still_fills():
    out = list(td.packed_lm_batches([np.array([1, 2])], batch=1, seq=4,
                                    drop_remainder=False))
    assert len(out) == 1
    toks, tgts = out[0]
    np.testing.assert_array_equal(toks, [[1, 2, 0, 1]])
    np.testing.assert_array_equal(tgts, [[2, 0, 1, 2]])


def _producers():
    return [t for t in threading.enumerate()
            if t.name == td.PRODUCER_THREAD and t.is_alive()]


def _wait_for_no_producer(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not _producers()


@pytest.mark.parametrize("leave", ["close", "break"])
def test_prefetch_abandonment_releases_producer(leave):
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield np.full((2, 2), i)

    it = td.prefetch_to_device(src(), size=2, device="cpu")
    if leave == "close":
        next(it)
        it.close()                              # GeneratorExit path
    else:
        for i, x in enumerate(it):
            if i == 1:
                break
        del it
    assert _wait_for_no_producer()
    assert len(produced) < 100                  # the producer stopped early


def test_prefetch_close_waits_for_the_producers_last_put():
    """Leaving the loop returns only after the producer finished the
    batch it was placing: no put runs after it (on the card a copy from
    the producer during a later CUDA graph capture would break it)."""
    events = []

    def slow_put(b):
        events.append(("start", b))
        time.sleep(0.2)
        events.append(("end", b))
        return b

    it = td.prefetch_to_device(iter(range(100)), size=1, put=slow_put)
    next(it)
    it.close()
    after = list(events)
    assert not _producers()
    time.sleep(0.3)
    assert events == after
    assert after[-1][0] == "end"


def test_prefetch_rejects_device_with_custom_put():
    with pytest.raises(ValueError, match="not both"):
        next(td.prefetch_to_device(iter([1]), device="cpu",
                                   put=lambda b: b))


def test_prefetch_rejects_size_below_one():
    with pytest.raises(ValueError, match="size"):
        next(td.prefetch_to_device(iter([1]), size=0, device="cpu"))


def test_prefetch_custom_put_owns_placement():
    """A custom put is applied as it is, with the default device, and
    needs no CUDA."""
    out = list(td.prefetch_to_device(iter(range(5)), size=2,
                                     put=lambda b: ("placed", b)))
    assert out == [("placed", i) for i in range(5)]


def test_prefetch_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(td.prefetch_to_device(iter([np.zeros(2)])))


def test_prefetch_preserves_order_and_moves_to_device():
    src = [(np.full((2, 4), i, np.int32), np.full((2, 4), i + 100))
           for i in range(7)]
    nested = [{"x": a, "y": [b]} for a, b in src]
    out = list(td.prefetch_to_device(iter(src), size=3, device="cpu"))
    assert len(out) == 7
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), src[i][0])
        np.testing.assert_array_equal(b.numpy(), src[i][1])
    for i, item in enumerate(td.prefetch_to_device(iter(nested), size=1,
                                                   device="cpu")):
        assert set(item) == {"x", "y"} and isinstance(item["y"], list)
        np.testing.assert_array_equal(item["y"][0].numpy(), src[i][1])


def test_prefetch_propagates_source_exception():
    def bad():
        yield np.zeros((2, 2))
        raise RuntimeError("source broke")

    it = td.prefetch_to_device(bad(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="source broke"):
        list(it)


def test_prefetch_propagates_put_exception_at_the_failed_batch():
    def put(b):
        if b == 3:
            raise KeyError("put broke")
        return b

    got = []
    with pytest.raises(KeyError, match="put broke"):
        for x in td.prefetch_to_device(iter(range(6)), size=2, put=put):
            got.append(x)
    assert got == [0, 1, 2]
    assert _wait_for_no_producer()


def test_prefetch_slow_consumer_sees_every_batch_once():
    """More batches than the buffer holds, a consumer slower than the
    producer: every batch arrives once, in order."""
    n = 50
    seen = []
    for x in td.prefetch_to_device((np.full(3, i) for i in range(n)),
                                   size=2, device="cpu"):
        time.sleep(0.001)
        seen.append(int(x[0]))
    assert seen == list(range(n))


# ------------------------------------------------ exact reference parity

@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("seed", range(10))
def test_packed_lm_batches_equal_the_reference(seed, drop_remainder):
    rng = np.random.RandomState(1000 + seed)
    batch, seq = int(rng.randint(1, 5)), int(rng.randint(1, 24))
    sep = int(rng.randint(0, 3))
    docs = _random_docs(seed)
    got = list(td.packed_lm_batches(docs, batch, seq, sep_token=sep,
                                    drop_remainder=drop_remainder))
    want = list(jd.packed_lm_batches(docs, batch, seq, sep_token=sep,
                                     drop_remainder=drop_remainder))
    _same_batches(got, want)


def test_packed_lm_batches_of_nothing_and_of_empty_documents():
    for docs in ([], [np.array([], np.int32)], [np.array([7])]):
        for drop in (True, False):
            _same_batches(
                list(td.packed_lm_batches(docs, 2, 3, drop_remainder=drop)),
                list(jd.packed_lm_batches(docs, 2, 3, drop_remainder=drop)))


def _write_tree(root):
    """A source tree with every case byte_corpus distinguishes."""
    rng = np.random.RandomState(0)
    files = {}
    for d in ("a", "a/deep", "b", "test", "tests", "b/tests", "__pycache__",
              "site-packages", "idle_test", "c"):
        for i in range(int(rng.randint(2, 6))):
            ext = rng.choice([".py", ".md", ".txt", ".json", ".bin", ".c",
                              ".pyc", ".rst"])
            n = int(rng.randint(50, 3000))
            files[f"{d}/f{i}{ext}"] = bytes(rng.randint(1, 256, n)
                                            .astype(np.uint8))
    files["a/nul.py"] = b"text\x00binary"
    files["a/empty.py"] = b""
    files["b/big.txt"] = b"x" * 9000
    files["top.py"] = b"print('top')\n" * 40
    for rel, raw in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(raw)
    return [str(root / "c"), str(root)]


@pytest.mark.parametrize("kwargs", [
    {},
    {"holdout_every": 3},
    {"max_total_bytes": 5000},
    {"max_total_bytes": 20000, "max_file_bytes": 700},
    {"holdout_every": 0},                     # the fallback holdout
    {"holdout_every": 1000, "max_total_bytes": 4000},
    {"exts": (".txt",)},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_byte_corpus_equals_the_reference(tmp_path, kwargs):
    roots = _write_tree(tmp_path)
    got_train, got_hold = td.byte_corpus(roots=roots, **kwargs)
    want_train, want_hold = jd.byte_corpus(roots=roots, **kwargs)
    for got, want in ((got_train, want_train), (got_hold, want_hold)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_byte_corpus_too_few_files_raises_as_the_reference(tmp_path):
    (tmp_path / "one.py").write_bytes(b"only one file")
    for fn in (td.byte_corpus, jd.byte_corpus):
        with pytest.raises(RuntimeError, match="too few"):
            fn(roots=[str(tmp_path)])
        with pytest.raises(RuntimeError, match="too few"):
            fn(roots=[str(tmp_path / "nowhere")])


def test_byte_corpus_walk_split_and_binary_skip(tmp_path):
    root = tmp_path / "src"
    root.mkdir()
    for i in range(8):
        (root / f"f{i}.py").write_text(f"def f{i}():\n    return {i}\n" * 20)
    (root / "blob.py").write_bytes(b"\x00\x01binary")
    (root / "skip.bin").write_bytes(b"not a text ext")
    tr1, ho1 = td.byte_corpus(roots=[str(root)], holdout_every=3)
    tr2, ho2 = td.byte_corpus(roots=[str(root)], holdout_every=3)
    assert len(tr1) + len(ho1) == 8
    assert len(ho1) == 8 // 3
    assert all((a == b).all() for a, b in zip(tr1, tr2))
    assert all((a == b).all() for a, b in zip(ho1, ho2))
    assert all(d.dtype == np.int32 and (d >= 0).all() and (d < 256).all()
               for d in tr1 + ho1)
    assert not any((d == 0).any() for d in tr1 + ho1)


def test_byte_corpus_respects_byte_caps(tmp_path):
    root = tmp_path / "src"
    root.mkdir()
    for i in range(30):
        (root / f"f{i:02d}.txt").write_text("x" * 1000)
    tr, ho = td.byte_corpus(roots=[str(root)], max_total_bytes=5000,
                            max_file_bytes=400, holdout_every=2)
    assert all(len(d) <= 400 for d in tr + ho)
    assert sum(len(d) for d in tr) <= 5000 + 400


def test_byte_corpus_default_roots_find_real_text():
    """The default root (this interpreter's stdlib) yields real text."""
    tr, ho = td.byte_corpus(max_total_bytes=1 << 20)
    assert sum(len(d) for d in tr + ho) >= 1 << 20
    assert len(ho) >= 1


# -------------------------------------------- a train step fed by it

def test_prefetch_feeds_the_port_train_step_as_the_reference_is_fed():
    """Packed batches through the prefetcher into the port's train step
    give the reference's losses on the same batches (fp32, AdamW), and
    the loss falls over the stream."""
    fields = dict(vocab=64, d_model=64, n_heads=4, n_layers=1, d_ff=64,
                  max_seq=16)
    jcfg = jt.ModelConfig(dtype=jnp.float32, **fields)
    tcfg = tt.ModelConfig(dtype=torch.float32, **fields)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jstep, jinit = jt.make_train_step(jcfg)
    jstep = jax.jit(jstep)
    jopt = jinit(jp)
    tstep, tinit = tt.make_train_step(tcfg)
    topt = tinit(tp)

    rng = np.random.RandomState(0)
    docs = [rng.randint(1, 64, size=rng.randint(5, 40)) for _ in range(120)]
    want = []
    for toks, tgts in jd.packed_lm_batches(docs, batch=8, seq=16):
        jp, jopt, loss = jstep(jp, jopt, (jnp.asarray(toks),
                                          jnp.asarray(tgts)))
        want.append(float(loss))
    got = []
    for toks, tgts in td.prefetch_to_device(
            td.packed_lm_batches(docs, batch=8, seq=16), size=2,
            device="cpu"):
        tp, topt, loss = tstep(tp, topt, (toks, tgts))
        got.append(float(loss))
    assert len(got) == len(want) > 5
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS_REL)
    assert np.mean(got[-3:]) < np.mean(got[:3])
