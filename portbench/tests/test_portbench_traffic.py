"""The traffic generator: the same seed gives the same requests, and
every seed the same sizes in another order."""

import numpy as np
import pytest
import torch

from portbench import harness, traffic

SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_backlog_is_the_seeds(seed):
    mix = traffic.load("decode")
    a = traffic.backlog(mix, seed, 49152)
    b = traffic.backlog(mix, seed, 49152)
    assert len(a) == mix["requests"]
    for x, y in zip(a, b):
        assert x.max_new == y.max_new and x.carried == y.carried
        assert np.array_equal(x.prompt, y.prompt)


def test_backlog_sizes_do_not_depend_on_the_seed():
    mix = traffic.load("decode")
    k = mix["stratum"]
    runs = [traffic.backlog(mix, s, 49152) for s in SEEDS[:2]]
    for lo in range(mix["first_wave"], mix["requests"], k):
        for size in (lambda r: len(r.prompt), lambda r: r.max_new):
            got = [sorted(map(size, reqs[lo:lo + k])) for reqs in runs]
            assert got[0] == got[1]
    first = [r.prompt for r in runs[0][:4]], [r.prompt for r in runs[1][:4]]
    assert not all(np.array_equal(x, y) for x, y in zip(*first))


def test_backlog_keeps_to_its_ranges():
    mix = traffic.load("decode")
    for r in traffic.backlog(mix, 3, 49152):
        full = len(r.prompt) + r.max_new
        assert r.max_new >= 1 and full <= mix["max_context"]
        assert mix["prompt"][0] <= len(r.prompt) - r.carried \
            <= mix["prompt"][1]
        assert mix["output"][0] <= r.max_new + r.carried <= mix["output"][1]


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_and_batch_are_the_seeds(seed):
    mix = dict(traffic.load("pack4k"), rows=2, seq=64)
    a = traffic.packed_batch(mix, seed, 5, 1000, "cpu")
    assert a.shape == (2, 65)
    assert torch.equal(a, traffic.packed_batch(mix, seed, 5, 1000, "cpu"))
    assert not torch.equal(a, traffic.packed_batch(mix, seed, 6, 1000,
                                                   "cpu"))
    mix = traffic.load("batch384")
    p = traffic.batch_prompts(mix, seed, 1, 49152)
    assert p.shape == (384, 512)
    assert np.array_equal(p, traffic.batch_prompts(mix, seed, 1, 49152))


@pytest.mark.parametrize("name", sorted(
    w["name"] for w in harness.benchmark()["workloads"]))
def test_every_cell_names_files_that_exist(name):
    cell = harness.load_cell(name)
    bench = {w["name"]: w for w in harness.benchmark()["workloads"]}[name]
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == bench[key]
    harness.load_config(cell["config"])
    traffic.load(cell["traffic"])
    assert (harness.HERE / "entries" / f"{cell['entry']}.py").exists()
