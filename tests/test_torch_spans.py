"""The port's spans and counters on the CPU: ``utils/profiling.py``
``annotate`` (its off path, nesting, bound and clock), the spans of
``ServingEngine`` and of ``make_train_step``'s step under a CPU-only
``torch.profiler`` profile, and the engine's class counters against the
run that moved them."""

import collections
import functools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.utils import profiling

CFG = tt.ModelConfig(vocab=64, d_model=32, n_heads=2, n_kv_heads=1,
                     n_layers=2, d_ff=64, max_seq=128, dtype=torch.float32,
                     use_rope=True)
# (prompt length, max new tokens): remainders that give chunks of
# several lengths, and a fourth request admitted once a row frees
REQUESTS = ((5, 9), (17, 4), (3, 20), (12, 6))
COUNTERS = ("chunks", "decode_steps", "row_steps")
ADMIT = ("serve.admit.prefill", "serve.admit.pool_write",
         "serve.admit.first_token")
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def fresh_buffer(monkeypatch):
    monkeypatch.setattr(profiling, "_spans",
                        collections.deque(maxlen=profiling.MAX_SPANS))


def _names(got):
    return [name for name, *_ in got]


def _inside(got, parent):
    """The spans that lie within ``parent``'s extent, itself left out."""
    _, lo, hi, _ = parent
    return [s for s in got if s is not parent and lo <= s[1]
            and s[2] <= hi]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


class _CountedEvent:
    made = 0

    def __init__(self, *args, **kw):
        _CountedEvent.made += 1

    def record(self, *args):
        pass


# ------------------------------------------------------------ off path

@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_records_and_makes_events_only_under_a_profile(
        profiled, monkeypatch):
    """Off: nothing recorded, no event made, the one shared no-op
    returned. On (the same spans, CUDA reported in use): two events a
    ``device`` span and a record each."""
    made = _CountedEvent.made
    prof = _profiled() if profiled else None
    if prof is not None:
        prof.start()
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "Event", _CountedEvent)
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            first = profiling.annotate("probe", device=True)
            with first:
                with profiling.annotate("probe.child", device=True):
                    pass
            same = profiling.annotate("probe.other") is first
    finally:
        if prof is not None:
            prof.stop()
    got = profiling.spans()
    if profiled:
        assert _names(got) == ["probe.child", "probe"]
        assert _CountedEvent.made - made == 4
        assert not same
    else:
        assert got == [] and _CountedEvent.made == made
        assert same


def test_off_spans_are_cheap():
    n = 100_000
    t = time.perf_counter()
    for _ in range(n):
        with profiling.annotate("serve.admit"):
            pass
    per_span = (time.perf_counter() - t) / n
    assert per_span < 10e-6, per_span
    assert profiling.spans() == []


# ------------------------------------------------------------ recorder

def test_nested_spans_lie_inside_their_parents():
    with _profiled():
        with profiling.annotate("outer"):
            with profiling.annotate("outer.a"):
                with profiling.annotate("outer.a.x"):
                    torch.ones(8) * 2
            with profiling.annotate("outer.b"):
                pass
    with profiling.annotate("after"):       # the profile has stopped
        pass
    got = profiling.spans()
    assert _names(got) == ["outer.a.x", "outer.a", "outer.b", "outer"]
    by = {s[0]: s for s in got}
    assert _names(_inside(got, by["outer"])) == ["outer.a.x", "outer.a",
                                                 "outer.b"]
    assert _names(_inside(got, by["outer.a"])) == ["outer.a.x"]
    assert by["outer.a"][2] <= by["outer.b"][1]
    assert all(start <= end and events is None
               for _, start, end, events in got)


def test_a_span_that_raises_is_not_recorded():
    with _profiled():
        with pytest.raises(ZeroDivisionError):
            with profiling.annotate("doomed"):
                1 / 0
        with profiling.annotate("after"):
            pass
    assert _names(profiling.spans()) == ["after"]


def test_buffer_keeps_the_newest_spans_up_to_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=8))
    with _profiled():
        for i in range(20):
            with profiling.annotate(f"s{i}"):
                pass
    assert _names(profiling.spans()) == [f"s{i}" for i in range(12, 20)]


@pytest.mark.parametrize("which", ["clock.inner", "clock.probe"])
def test_a_span_is_on_the_profilers_clock(which):
    """The span holds the profiler's range of a ``record_function``
    inside it, and its own range, each edge within 1 ms."""
    with _profiled() as prof:
        with profiling.annotate("clock.warm"):      # first-use costs
            with record_function("clock.warm_inner"):
                pass
        with profiling.annotate("clock.probe"):
            with record_function("clock.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    _, lo, hi, _ = next(s for s in profiling.spans()
                        if s[0] == "clock.probe")
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == which)
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert lo <= start and end <= hi
    assert start - lo < 1_000_000
    assert hi - end < 1_000_000


# ------------------------------------------------------------ engine

@functools.lru_cache(maxsize=None)
def _served():
    """The tiny engine under a CPU profile: three requests admitted, the
    fourth once a row frees, every row decoded to its end. Returns
    (spans, counters' growth, (k, active rows) of each chunk)."""
    params = tt.init_params(CFG, 0, device="cpu")
    eng = ts.ServingEngine(params, CFG, n_blocks=1 + 3 * 8, block_t=8,
                           max_batch=3, max_blocks_per_seq=8, device="cpu")
    before = {c: getattr(ts.ServingEngine, c) for c in COUNTERS}
    buffer = collections.deque(maxlen=profiling.MAX_SPANS)
    saved, profiling._spans = profiling._spans, buffer
    chunks = []
    try:
        with _profiled():
            rids = [eng.add(list(range(1, n + 1)), m)
                    for n, m in REQUESTS[:3]]
            while any(r is not None for r in eng.rows):
                out = eng.step_chunk(32)
                ks = {len(toks) for toks in out.values()}
                assert len(ks) == 1
                chunks.append((ks.pop(), len(out)))
                if len(rids) < len(REQUESTS) and None in eng.rows:
                    n, m = REQUESTS[len(rids)]
                    rids.append(eng.add(list(range(1, n + 1)), m))
    finally:
        profiling._spans = saved
    grew = {c: getattr(ts.ServingEngine, c) - before[c] for c in COUNTERS}
    assert sorted(eng.finished) == rids
    return list(buffer), grew, chunks


def test_engine_records_an_admission_span_a_request():
    got, _, _ = _served()
    assert _names(got).count("serve.admit") == len(REQUESTS)
    assert set(_names(got)) == {"serve.admit", *ADMIT}


@pytest.mark.parametrize("child", ADMIT)
def test_engine_spans_each_with_its_children(child):
    got, _, _ = _served()
    for top in (s for s in got if s[0] == "serve.admit"):
        inside = _names(_inside(got, top))
        assert inside == list(ADMIT)
        assert inside.count(child) == 1


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_agree_with_the_run(counter):
    _, grew, chunks = _served()
    assert all(k in (1,) + ts.ServingEngine.CHUNK_SIZES for k, _ in chunks)
    want = {
        "chunks": len(chunks),
        "decode_steps": sum(k for k, _ in chunks),
        # every token after a request's first is one row's step
        "row_steps": sum(m - 1 for _, m in REQUESTS),
    }[counter]
    assert grew[counter] == want
    if counter == "row_steps":
        assert want == sum(k * rows for k, rows in chunks)


# ------------------------------------------------------------ training

def _train(accum_steps, monkeypatch, cuda_in_use=False):
    """Two steps of a tiny ``make_train_step`` under a CPU profile; with
    ``cuda_in_use`` the spans are told CUDA is in use and make counted
    events. Returns the spans."""
    cfg = tt.ModelConfig(vocab=64, d_model=32, n_heads=2, n_kv_heads=1,
                         n_layers=2, d_ff=64, max_seq=16,
                         dtype=torch.float32, use_rope=True)
    params = tt.init_params(cfg, 0, device="cpu")
    step, init = tt.make_train_step(
        cfg, optimizer=tt.AdamW(1e-3, clip_norm=1.0),
        accum_steps=accum_steps)
    state = init(params)
    tokens = torch.randint(0, cfg.vocab, (4, 17),
                           generator=torch.Generator().manual_seed(0))
    with monkeypatch.context() as m:
        if cuda_in_use:
            m.setattr(torch.cuda, "Event", _CountedEvent)
            m.setattr(torch.cuda, "is_initialized", lambda: True)
        with _profiled():
            for _ in range(2):
                step(params, state, (tokens[:, :-1], tokens[:, 1:]))
    return profiling.spans()


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_spans_by_phase(accum_steps, monkeypatch):
    got = _train(accum_steps, monkeypatch)
    steps = [s for s in got if s[0] == "train.step"]
    assert len(steps) == 2
    for top in steps:
        assert _names(_inside(got, top)) == \
            ["train.forward", "train.backward"] * accum_steps \
            + ["train.optimizer"]
    assert len(got) == 2 * (2 + 2 * accum_steps)
    assert all(events is None for *_, events in got)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_only_the_train_phases_carry_device_events(accum_steps,
                                                   monkeypatch):
    made = _CountedEvent.made
    got = _train(accum_steps, monkeypatch, cuda_in_use=True)
    timed = [name for name, *_, events in got if events is not None]
    assert set(timed) == set(PHASES)
    assert "train.step" in _names(got)
    assert _CountedEvent.made - made == 2 * len(timed) \
        == 2 * 2 * (1 + 2 * accum_steps)
