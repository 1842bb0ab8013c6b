"""Input pipeline: host-side batch packing and asynchronous device
prefetch.

Port of :mod:`tpu_dra_driver.workloads.data`, with the same names,
arguments and results:

- ``packed_lm_batches``: streams documents into fixed-shape [b, t]
  next-token batches by packing (documents joined with a separator and
  sliced into contiguous windows: no padding, static shapes). NumPy in,
  NumPy out, batch for batch the reference's.
- ``byte_corpus``: a byte-level text corpus (vocab 256) from local
  source trees, by default the running interpreter's stdlib, with a
  held-out split.
- ``prefetch_to_device``: a daemon thread keeps up to ``size`` batches
  on the card ahead of the consumer. Each host leaf is copied into
  pinned memory and sent by a ``non_blocking`` copy on a CUDA stream of
  the producer's own, so the copy overlaps the consumer's kernels; the
  consumer's stream waits on an event recorded after the copy before it
  touches the batch. Where the reference takes ``sharding`` for one
  device, the port takes ``device``; with ``sharding`` (a
  ``parallel.mesh.NamedSharding``) each leaf lands as
  ``mesh.device_put`` places it: this rank's slice, on this rank's
  device.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpu_dra_driver_torch.workloads import resolve_device


def packed_lm_batches(documents: Iterable[np.ndarray], batch: int, seq: int,
                      sep_token: int = 0,
                      drop_remainder: bool = True
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Pack variable-length token documents into (tokens, targets)
    next-token-prediction batches of static shape [batch, seq].

    Documents are joined with ``sep_token`` into one contiguous stream;
    each row is a ``seq + 1`` window (inputs = w[:-1], targets = w[1:]).
    The remainder that does not fill a final batch is dropped unless
    ``drop_remainder=False``: then the last batch repeats the stream's
    tail to fill, still of static shape.
    """
    if batch < 1 or seq < 1:
        raise ValueError(f"batch ({batch}) and seq ({seq}) must be >= 1")
    need = batch * (seq + 1)
    sep = np.array([sep_token], np.int32)
    # accumulate chunks and concatenate only when a batch's worth is
    # ready: O(total tokens), not O(n_docs * batch * seq)
    chunks, total = [], 0
    for doc in documents:
        doc = np.asarray(doc, dtype=np.int32).ravel()
        chunks += [doc, sep]
        total += len(doc) + 1
        if total < need:
            continue
        buf = np.concatenate(chunks)
        while len(buf) >= need:
            rows = buf[:need].reshape(batch, seq + 1)
            buf = buf[need:]
            yield rows[:, :-1].copy(), rows[:, 1:].copy()
        chunks, total = [buf], len(buf)
    if not drop_remainder and total >= 2:
        buf = np.concatenate(chunks)
        reps = -(-need // len(buf))
        rows = np.tile(buf, reps)[:need].reshape(batch, seq + 1)
        yield rows[:, :-1].copy(), rows[:, 1:].copy()


#: file extensions treated as text when building a byte-level corpus
_TEXT_EXTS = (".py", ".md", ".txt", ".sh", ".yaml", ".yml", ".json",
              ".toml", ".cfg", ".rst", ".c", ".cc", ".h", ".proto")


def byte_corpus(roots: Optional[Iterable[str]] = None,
                max_total_bytes: int = 8 << 20,
                max_file_bytes: int = 256 << 10,
                holdout_every: int = 17,
                exts: Tuple[str, ...] = _TEXT_EXTS,
                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """A byte-level text corpus from local source trees.

    Returns ``(train_docs, holdout_docs)``: lists of int32 arrays of
    UTF-8 bytes (vocab 256), one per file. Every ``holdout_every``-th
    file goes to the holdout split, so evaluation prompts are never
    trained on. Files holding a NUL byte (binary) are skipped, which
    keeps byte 0 free as the packer's separator. Test trees, caches and
    ``site-packages`` are not walked. The default root is the running
    interpreter's stdlib. Files walk in sorted order, so the same roots
    give the same corpus and split on every run.
    """
    if roots is None:
        import sysconfig
        roots = [sysconfig.get_paths()["stdlib"]]
    train, holdout, total, idx = [], [], 0, 0
    for root in roots:
        if total >= max_total_bytes:
            break
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames
                           if d not in ("test", "tests", "__pycache__",
                                        "site-packages", "idle_test")]
            for name in sorted(filenames):
                if not name.endswith(exts):
                    continue
                try:
                    with open(os.path.join(dirpath, name), "rb") as f:
                        raw = f.read(max_file_bytes)
                except OSError:
                    continue
                if not raw or b"\x00" in raw:
                    continue
                doc = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
                idx += 1
                if holdout_every and idx % holdout_every == 0:
                    holdout.append(doc)
                else:
                    train.append(doc)
                    total += len(doc)
                if total >= max_total_bytes:
                    break
            if total >= max_total_bytes:
                break
    if not holdout and len(train) >= 2:
        # the byte cap came before the first every-N holdout pick: split
        # off the newest train doc (deterministic, disjoint from training)
        holdout.append(train.pop())
    if not train or not holdout:
        raise RuntimeError(
            f"byte_corpus found too few text files under {list(roots)} "
            f"(train={len(train)}, holdout={len(holdout)})")
    return train, holdout


def _tree_map(fn, node):
    """``fn`` over the leaves of a dict/list/tuple tree."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, v) for v in node)
    return fn(node)


def _tensors(node) -> Iterator[torch.Tensor]:
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif isinstance(node, torch.Tensor):
        yield node


class _Staged:
    """A batch whose copies to ``device`` were issued on the producer's
    stream, and the event recorded after them."""

    def __init__(self, batch, event: torch.cuda.Event,
                 device: torch.device):
        self.batch, self.event, self.device = batch, event, device

    def ready(self):
        """The batch, safe to use on the calling thread's current
        stream: that stream waits for the copies, and each tensor is
        marked as used there, so the caching allocator does not hand
        its memory to a later copy while the consumer's kernels may
        still read it."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in _tensors(self.batch):
            t.record_stream(stream)
        return self.batch


class _SideStreamPut:
    """The default ``put`` on the card: each host leaf is copied into
    pinned memory, then sent by a ``non_blocking`` copy on a stream this
    object creates in the producer thread (the current device and stream
    are per thread, so the producer sets both itself). ``select``, where
    given, takes each leaf's part first (a sharding's slice)."""

    def __init__(self, device: torch.device,
                 select: Callable[[torch.Tensor], torch.Tensor] = None):
        self.device = device
        self.select = select
        self.stream: Optional[torch.cuda.Stream] = None

    def __call__(self, batch) -> _Staged:
        if self.stream is None:
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(self.device)

        def leaf(x):
            x = torch.as_tensor(x)
            if self.select is not None:
                x = self.select(x)
            if x.device.type == "cpu":
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            out = _tree_map(leaf, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Staged(out, event, self.device)


#: the name of every prefetch producer thread
PRODUCER_THREAD = "prefetch_to_device"


def _shard_put(sharding) -> Callable[[Any], Any]:
    """The ``put`` of a ``sharding``: each leaf's slice on this rank, a
    fresh contiguous copy (``parallel.mesh.device_put``), on the mesh's
    device (the current card, by the producer's stream, or the CPU)."""
    from tpu_dra_driver_torch.workloads.parallel.mesh import device_put

    def select(x):
        return device_put(x, sharding)

    if sharding.mesh.device_type == "cuda":
        return _SideStreamPut(torch.device("cuda",
                                           torch.cuda.current_device()),
                              select)
    return lambda b: _tree_map(lambda x: select(torch.as_tensor(x)), b)


def prefetch_to_device(batches: Iterable[Any], size: int = 2,
                       device="cuda",
                       put: Optional[Callable[[Any], Any]] = None,
                       sharding=None) -> Iterator[Any]:
    """Iterate ``batches`` with up to ``size`` of them already on
    ``device``.

    A daemon thread (named :data:`PRODUCER_THREAD`) pulls host batches
    (trees of NumPy arrays or tensors) and places each leaf. On the card
    the copies run on the producer's own stream from pinned memory, and
    the consumer's current stream waits for them when the batch is
    handed over; with ``device="cpu"`` each leaf becomes a CPU tensor.
    With ``sharding`` (a ``parallel.mesh.NamedSharding``; every rank
    iterates the same host batches) each leaf lands as ``device_put``
    places it: this rank's slice, copied the same way onto the mesh's
    device (``device`` is not read). A custom ``put`` owns placement and
    is applied as it is; passing one together with ``sharding``, or with
    a ``device`` other than the default, raises. An exception in the
    source (or in ``put``) reaches the consumer at the batch that
    failed. A consumer that leaves the loop (break, ``close()``,
    ``GeneratorExit``) releases the producer and the buffered batches,
    and waits until the producer has finished the batch it was placing
    (one step of the source and one ``put``): no copy of the loop runs
    after it.
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if put is not None and sharding is not None:
        raise ValueError("pass either sharding or a custom put, not both "
                         "(a custom put owns placement)")
    if put is not None and torch.device(device) != torch.device("cuda"):
        raise ValueError("pass either device or a custom put, not both "
                         "(a custom put owns placement)")
    if sharding is not None:
        put = _shard_put(sharding)
    elif put is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index is None:
                # the producer thread sets its device itself: name the
                # consumer's current one
                dev = torch.device("cuda", torch.cuda.current_device())
            put = _SideStreamPut(dev)
        else:
            def put(b):
                return _tree_map(lambda x: torch.as_tensor(x, device=dev), b)

    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()

    def send(item) -> bool:
        """Blocking put that gives up when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if stop.is_set() or not send(put(b)):
                    return
        except BaseException as e:          # handed to the consumer
            send((_END, e))
            return
        send((_END, None))

    t = threading.Thread(target=producer, name=PRODUCER_THREAD, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _END):
                if item[1] is not None:
                    raise item[1]
                return
            yield item.ready() if isinstance(item, _Staged) else item
    finally:
        # the consumer left the loop: release the producer and the
        # buffered batches, and wait for the producer to finish the batch
        # it holds, so that no copy of this loop's runs later (a CUDA
        # graph captured after the loop would fail on a pinned
        # allocation or a copy issued from another thread)
        stop.set()
        _drain(q)
        t.join()
        _drain(q)


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
