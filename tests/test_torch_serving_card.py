"""The serving engine's admission graphs on the card: six requests over
two admission buckets, each bucket warmed up by its first admission,
captured by its second and replayed by its third. Every admission's
first token and pool blocks are held to an eager ``_admit_prefill`` on
the card from the same pools into the same blocks, bit for bit (the
same kernels on the same inputs).

Skips without a card. The module imports no JAX, so it runs on a card
machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):
``python3 -m pytest --noconftest -m card tests/test_torch_serving_card.py``
"""

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads.models import serving as ts
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph

CFG = tt.ModelConfig(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=256, use_rope=True,
                     dtype=torch.float32)
BLOCK_T = 32
# buckets (32, 1) and (64, 2), interleaved: 5, 17, 32 and 33, 60, 40
LENS = (5, 33, 17, 60, 32, 40)


@pytest.mark.card
def test_admissions_replay_one_graph_per_bucket():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    params = tt.init_params(CFG, 0, device="cuda")
    eng = ts.ServingEngine(params, CFG, n_blocks=16, block_t=BLOCK_T,
                           max_batch=len(LENS), max_blocks_per_seq=4,
                           device="cuda")
    rng = np.random.RandomState(0)
    captures, replays, admits = (StepGraph.captures,
                                 ts.ServingEngine.admit_replays,
                                 ts.ServingEngine.admits)
    seen = {}
    for t0 in LENS:
        prompt = [int(t) for t in rng.randint(0, CFG.vocab, t0)]
        t_bucket = max(32, 1 << (t0 - 1).bit_length())
        n_prompt = -(-t0 // BLOCK_T)
        nb_bucket = 1 << (n_prompt - 1).bit_length()
        ks = [p.clone() for p in eng.pool_ks]
        vs = [p.clone() for p in eng.pool_vs]
        rid = eng.add(prompt, 4)
        seen[(t_bucket, nb_bucket)] = seen.get((t_bucket, nb_bucket), 0) + 1
        # a bucket's third admission is its first replay
        assert ts.ServingEngine.admit_replays - replays == sum(
            max(0, n - 2) for n in seen.values())
        row = next(r.row for r in eng.rows if r is not None and r.rid == rid)
        blocks = [int(b) for b in eng.tables[row, :n_prompt]]
        toks = torch.tensor([prompt + [0] * (t_bucket - t0)],
                            dtype=torch.int32)
        logits, ks, vs = ts._admit_prefill(
            params, toks, ks, vs,
            torch.tensor(blocks + [0] * (nb_bucket - n_prompt),
                         dtype=torch.int32),
            CFG, BLOCK_T, true_len=t0)
        assert eng.rows[row].tokens == [int(torch.argmax(logits))], t0
        for li in range(CFG.n_layers):
            for got, want in ((eng.pool_ks[li], ks[li]),
                              (eng.pool_vs[li], vs[li])):
                assert torch.equal(got[1:], want[1:]), (t0, li)
    assert seen == {(32, 1): 3, (64, 2): 3}
    assert StepGraph.captures - captures == 2
    assert ts.ServingEngine.admit_replays - replays == 2
    assert ts.ServingEngine.admits - admits == len(LENS)
    assert all(isinstance(a.run, StepGraph) and a.run.graph is not None
               for a in eng._admits.values())
