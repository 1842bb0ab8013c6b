"""pytest settings of the benchmark's own tests (``portbench/tests``)."""

import pytest

# the cells' overrides that make each cell tiny enough for the CPU
TINY_CONFIG = {"hidden_size": 64, "intermediate_size": 128,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "num_hidden_layers": 2, "vocab_size": 256}
TINY = {
    "train.sc2-7b.pack4k": ({"rows": 2, "seq": 128}, {}),
    "train.sc2-7b.win16k": ({"rows": 2, "seq": 256},
                            {"window": 64}),
    "serve.sc2-3b.decode": ({"prompt": [8, 24], "output": [16, 48],
                             "stratum": 4, "requests": 32, "first_wave": 4,
                             "max_context": 128},
                            {"block_t": 16, "max_blocks_per_seq": 8,
                             "max_batch": 4, "check_requests": 3}),
    "gen.sc2-3b.batch384": ({"rows": 4, "prompt": 16, "output": 24},
                           {"check_rows": 3}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one "
        "(run: python3 -m pytest portbench/tests -m card)")


@pytest.fixture
def tiny():
    """run_cell's keyword arguments that run ``cell`` tiny on the CPU."""
    from portbench import harness

    def kw(cell, **extra_params):
        mix, params = TINY[cell]
        merged = dict(harness.load_cell(cell)["params"], **params,
                      **extra_params)
        return {"config_override": TINY_CONFIG, "mix_override": mix,
                "cell_override": {"params": merged},
                "log": lambda s: None}
    return kw
