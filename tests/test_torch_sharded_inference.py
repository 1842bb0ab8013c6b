"""The sharded inference callers across gloo processes: int8
``generate`` under a (dp, tp) mesh, the ``ServingEngine`` with
tp-sharded params and kv-head-sharded pools, and the sharded seq2seq
loss, at tp 2 (2 ranks), tp 4 and (dp 2, tp 2) (4 ranks).

One spawned group per world size (``launch.run_group``, a ``FileStore``
in ``tmp_path``) runs every mesh of that size; the reference's params
come from JAX (``convert.params_from_jax``) and its results are made in
the parent, in fp32:

- int8 ``generate`` (RoPE with GQA, and learned positions) on each
  rank's ``dp`` rows gives the reference's tokens, and the
  teacher-forced logits of ``block_prefill`` and each ``decode_step``
  under the mesh match the port's unsharded ones within 1e-4 relative
  and 1e-5 absolute (the ``tp`` partial sums add in another order);
- the kv-head-sharded engine (pools of ``n_kv / tp`` heads) is
  token-identical to the solo port engine and to the reference's
  engine (its paged kernel in interpret mode), with the next step's
  logits compared before every dispatch: the tiny random model repeats
  one token, so tokens alone would hide a wrong head;
- the sharded seq2seq loss (placed by ``seq2seq_param_shardings``;
  ``wo_x`` drawn nonzero so that the cross path carries the source)
  within 1e-5 of the reference's unsharded loss, with the oracle and
  with ``flash_attention``'s plain version.

In the parent: ``seq2seq_param_shardings`` against the reference's
specs leaf by leaf, and its refusal of stacked decoder layers.
"""

import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_dra_driver_torch.workloads import convert
from tpu_dra_driver_torch.workloads.models import quantize as tq
from tpu_dra_driver_torch.workloads.models import seq2seq as ts2
from tpu_dra_driver_torch.workloads.models import serving as tsv
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.ops.attention import flash_attention
from tpu_dra_driver_torch.workloads.parallel import launch
from tpu_dra_driver_torch.workloads.parallel import mesh as tm
from tpu_dra_driver_torch.workloads.parallel import spmd as tsp

# the module, not the ``generate`` function the package exports
tgen = importlib.import_module(
    "tpu_dra_driver_torch.workloads.models.generate")

TIMEOUT = 240
TOL = dict(rtol=1e-4, atol=1e-5)
S2S_TOL = 1e-5
MESHES = {"tp2": (2, 1, 2), "tp4": (4, 1, 4), "dp2-tp2": (4, 2, 2)}
GEN = dict(vocab=128, d_model=128, n_heads=8, n_layers=2, d_ff=128,
           max_seq=32)
GEN_MODELS = {"rope-gqa": dict(n_kv_heads=4, use_rope=True),
              "learned": dict(use_rope=False)}
PROMPT = (4, 8)
STEPS = 6
ENGINE = dict(vocab=128, d_model=128, n_heads=8, n_kv_heads=4, n_layers=2,
              d_ff=128, max_seq=64, use_rope=True)
ENGINE_KW = dict(n_blocks=16, block_t=8, max_batch=2)
ENGINE_LENS = (4, 3, 9)
NEW_TOKENS = 5
S2S = dict(vocab=64, d_model=64, n_heads=4, n_enc_layers=1,
           n_dec_layers=1, d_ff=64, max_src=16, max_tgt=16)
S2S_MODELS = {"rope-oracle": (dict(), None),
              "learned-flash": (dict(use_rope=False), "flash")}
S2S_BATCH = (4, 8)


def _prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(0, ENGINE["vocab"], n)]
            for n in ENGINE_LENS]


def _drive(eng, probe):
    """Admit the prompts as rows free up and step the engine one token a
    dispatch to the end, the next step's logits probed before each
    dispatch; returns (tokens by request, probes)."""
    pending, probes = _prompts(), []
    while pending or any(r is not None for r in eng.rows):
        while pending and any(r is None for r in eng.rows):
            eng.add(pending.pop(0), NEW_TOKENS)
        if any(r is not None for r in eng.rows):
            probes.append(probe(eng))
            eng.step()
    return [eng.finished[k] for k in sorted(eng.finished)], probes


def _pending(eng):
    tokens = np.zeros((len(eng.rows),), np.int32)
    for r in eng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    return tokens, [r.row for r in eng.rows if r is not None]


# ------------------------------------------------------------- the parent

def _jax_gen_cfg(model):
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import transformer as jt
    return jt.ModelConfig(dtype=jnp.float32, **GEN, **GEN_MODELS[model])


def _plain(node):
    """A numpy tree with each quantized leaf as a ``SimpleNamespace(q, s,
    axis)`` (``convert.params_from_jax`` reads those attributes): it
    pickles without the reference's classes, which the ranks must not
    import."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    if hasattr(node, "q") and hasattr(node, "s"):
        return SimpleNamespace(q=np.asarray(node.q), s=np.asarray(node.s),
                               axis=int(node.axis))
    return np.asarray(node)


def _reference_generate(model):
    """The reference's int8 params (numpy), prompt and tokens."""
    import jax
    from tpu_dra_driver.workloads.models import transformer as jt
    jg = importlib.import_module("tpu_dra_driver.workloads.models.generate")
    jq = importlib.import_module("tpu_dra_driver.workloads.models.quantize")
    cfg = _jax_gen_cfg(model)
    key = jax.random.PRNGKey(5)
    params = jq.quantize_params(jt.init_params(cfg, key))
    prompt = jax.random.randint(key, PROMPT, 0, cfg.vocab)
    out = jg.generate(params, cfg, prompt, steps=STEPS)
    return _plain(params), np.asarray(prompt), np.asarray(out)


def _reference_engine():
    """The reference's params (numpy), and its engine's tokens and
    probes."""
    import jax
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import serving as js
    from tpu_dra_driver.workloads.models import transformer as jt
    cfg = jt.ModelConfig(dtype=jnp.float32, **ENGINE)
    params = jt.init_params(cfg, jax.random.PRNGKey(7))

    @functools.partial(jax.jit, static_argnames=("n_live_blocks",))
    def step_logits(pool_ks, pool_vs, tables, lens, tokens, n_live_blocks):
        logits, _, _ = js._decode_core(params, cfg, pool_ks, pool_vs,
                                       tables, lens, tokens, interpret=True,
                                       n_live_blocks=n_live_blocks)
        return logits

    def probe(eng):
        tokens, active = _pending(eng)
        got = step_logits(eng.pool_ks, eng.pool_vs, jnp.asarray(eng.tables),
                          jnp.asarray(eng.lens), jnp.asarray(tokens),
                          n_live_blocks=eng._live_blocks_bucket(1))
        return np.asarray(got)[active]

    eng = js.ServingEngine(params, cfg, interpret=True, **ENGINE_KW)
    return (jax.tree.map(np.asarray, params),) + _drive(eng, probe)


def _reference_s2s(model):
    """The reference's seq2seq params (``wo_x`` drawn nonzero), batch
    and unsharded loss."""
    import jax
    import jax.numpy as jnp
    from tpu_dra_driver.workloads.models import seq2seq as js2
    cfg = js2.Seq2SeqConfig(dtype=jnp.float32, **S2S,
                            **S2S_MODELS[model][0])
    key = jax.random.PRNGKey(11)
    params = js2.init_seq2seq_params(cfg, key)
    for i, layer in enumerate(params["decoder"]["layers"]):
        layer["wo_x"] = 0.02 * jax.random.normal(
            jax.random.PRNGKey(20 + i), layer["wo_x"].shape, jnp.float32)
    src = jax.random.randint(key, S2S_BATCH, 1, cfg.vocab)
    tgt = src[:, ::-1]
    loss = js2.seq2seq_loss_fn(params, (src, tgt), cfg)
    return (jax.tree.map(np.asarray, params), np.asarray(src),
            np.ascontiguousarray(np.asarray(tgt)), float(loss))


# -------------------------------------------------------------- the ranks

def _mesh(dp, tp):
    return tm.build_mesh(dp=dp, tp=tp, device_type="cpu")


def _rows(mesh, x):
    return tm.device_put(torch.from_numpy(np.ascontiguousarray(x)),
                         tm.NamedSharding(mesh, ("dp", None)))


def _teacher_forced(params, cfg, tokens, mesh):
    """Logits of ``block_prefill`` over the prompt and of each
    ``decode_step`` over the generated tokens."""
    t0 = PROMPT[1]
    cache = tgen.init_kv_cache(cfg, tokens.shape[0], t0 + STEPS,
                               device="cpu", mesh=mesh)
    logits, cache, _ = tgen.block_prefill(params, cfg, cache, tokens[:, :t0],
                                          mesh=mesh)
    out = [logits]
    for pos in range(t0, t0 + STEPS - 1):
        logits, cache = tgen.decode_step(params, cfg, cache, pos,
                                         tokens[:, pos], mesh=mesh)
        out.append(logits)
    return torch.stack(out, 1)


def _gen_cfg(model):
    return tt.ModelConfig(dtype=torch.float32, **GEN, **GEN_MODELS[model])


def _solo_generate(model, params, prompt):
    """The port's unsharded int8 generate on the whole prompt, and its
    teacher-forced logits over its tokens."""
    cfg = _gen_cfg(model)
    full = convert.params_from_jax(params, device="cpu")
    tokens = tgen.generate(full, cfg, torch.from_numpy(prompt), steps=STEPS)
    return {"tokens": tokens,
            "logits": _teacher_forced(full, cfg, tokens, None)}


def _generate(mesh, model, params, prompt):
    cfg = _gen_cfg(model)
    full = convert.params_from_jax(params, device="cpu")
    local = tm.device_put(full, tm.param_shardings(mesh, full))
    sharded = tgen.generate(local, cfg, _rows(mesh, prompt), steps=STEPS,
                            mesh=mesh)
    read = tgen.local_params(local, cfg, mesh)
    return {"tokens": sharded,
            "logits": _teacher_forced(read, cfg, sharded, mesh)}


def _engine_probe(eng):
    tokens, active = _pending(eng)
    got, _, _ = tsv.paged_decode_step(
        eng._local, eng.cfg, [p.clone() for p in eng.pool_ks],
        [p.clone() for p in eng.pool_vs], torch.from_numpy(eng.tables),
        torch.from_numpy(eng.lens), torch.from_numpy(tokens),
        n_live_blocks=eng._live_blocks_bucket(1))
    return got.numpy()[active]


def _solo_engine(params):
    cfg = tt.ModelConfig(dtype=torch.float32, **ENGINE)
    full = convert.params_from_jax(params, device="cpu")
    return _drive(tsv.ServingEngine(full, cfg, device="cpu", **ENGINE_KW),
                  _engine_probe)


def _engine(mesh, params):
    cfg = tt.ModelConfig(dtype=torch.float32, **ENGINE)
    full = convert.params_from_jax(params, device="cpu")
    local = tm.device_put(full, tm.param_shardings(mesh, full))
    sharded = tsv.ServingEngine(local, cfg, device="cpu", mesh=mesh,
                                **ENGINE_KW)
    pool_shape = tuple(sharded.pool_ks[0].shape)
    return {"sharded": _drive(sharded, _engine_probe),
            "pool_shape": pool_shape}


def _s2s(mesh, model, params, src, tgt):
    cfg = ts2.Seq2SeqConfig(dtype=torch.float32, **S2S,
                            **S2S_MODELS[model][0])
    full = convert.params_from_jax(params, device="cpu")
    local = tm.device_put(full, ts2.seq2seq_param_shardings(mesh, full))
    attn = flash_attention if S2S_MODELS[model][1] == "flash" else None
    return float(ts2.seq2seq_loss_fn(
        local, (_rows(mesh, src), _rows(mesh, tgt)), cfg, attn_fn=attn,
        mesh=mesh))


def _child(rank, meshes, gen_refs, engine_params, s2s_refs):
    import torch.distributed as dist
    world = dist.get_world_size()
    out = {("solo", model, world): _solo_generate(model, params, prompt)
           for model, (params, prompt) in gen_refs.items()}
    out[("solo engine", world)] = _solo_engine(engine_params)
    for name in meshes:
        _, dp, tp = MESHES[name]
        mesh = _mesh(dp, tp)
        for model, (params, prompt) in gen_refs.items():
            out[("generate", name, model)] = dict(
                _generate(mesh, model, params, prompt),
                dp=tsp.axis_index(mesh, "dp"))
        out[("engine", name)] = _engine(mesh, engine_params)
        for model, (params, src, tgt) in s2s_refs.items():
            out[("s2s", name, model)] = _s2s(mesh, model, params, src, tgt)
    return out


# -------------------------------------------------------------- the tests

@pytest.fixture(scope="module")
def refs():
    return {"generate": {m: _reference_generate(m) for m in GEN_MODELS},
            "engine": _reference_engine(),
            "s2s": {m: _reference_s2s(m) for m in S2S_MODELS}}


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    gen_refs = {m: r[:2] for m, r in refs["generate"].items()}
    s2s_refs = {m: r[:3] for m, r in refs["s2s"].items()}
    out = {}
    for world in (2, 4):
        meshes = [n for n, (w, _, _) in MESHES.items() if w == world]
        results = launch.run_group(
            _child, world, meshes, gen_refs, refs["engine"][0], s2s_refs,
            store_dir=str(tmp_path_factory.mktemp(f"inf{world}")),
            timeout=TIMEOUT)
        for key in results[0]:
            out[key] = [r[key] for r in results]
    return out


GEN_CASES = [(n, m) for n in MESHES for m in GEN_MODELS]


@pytest.mark.parametrize("name,model", GEN_CASES,
                         ids=[f"{n}-{m}" for n, m in GEN_CASES])
def test_int8_generate_under_the_mesh_gives_the_reference_tokens(
        runs, refs, name, model):
    want = refs["generate"][model][2]
    dp = MESHES[name][1]
    b = PROMPT[0] // dp
    for r, solo in zip(runs[("generate", name, model)],
                       runs[("solo", model, MESHES[name][0])]):
        rows = slice(r["dp"] * b, (r["dp"] + 1) * b)
        np.testing.assert_array_equal(r["tokens"].numpy(), want[rows])
        assert torch.equal(r["tokens"], solo["tokens"][rows])


@pytest.mark.parametrize("name,model", GEN_CASES,
                         ids=[f"{n}-{m}" for n, m in GEN_CASES])
def test_int8_generate_logits_match_the_unsharded_port(runs, name, model):
    b = PROMPT[0] // MESHES[name][1]
    for r, solo in zip(runs[("generate", name, model)],
                       runs[("solo", model, MESHES[name][0])]):
        assert r["logits"].shape == (b, STEPS, GEN["vocab"])
        rows = slice(r["dp"] * b, (r["dp"] + 1) * b)
        np.testing.assert_allclose(r["logits"].numpy(),
                                   solo["logits"].numpy()[rows], **TOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_kv_head_sharded_engine_is_token_identical(runs, refs, name):
    _, want_tokens, want_probes = refs["engine"]
    tp = MESHES[name][2]
    world = MESHES[name][0]
    for r, (solo_tokens, solo_probes) in zip(
            runs[("engine", name)], runs[("solo engine", world)]):
        assert r["pool_shape"] == (ENGINE_KW["n_blocks"],
                                   ENGINE["n_kv_heads"] // tp,
                                   ENGINE_KW["block_t"],
                                   ENGINE["d_model"] // ENGINE["n_heads"])
        tokens, probes = r["sharded"]
        assert tokens == solo_tokens == want_tokens
        assert len(probes) == len(want_probes) == len(solo_probes)
        for got, solo, want in zip(probes, solo_probes, want_probes):
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(got, solo, **TOL)


S2S_CASES = [(n, m) for n in MESHES for m in S2S_MODELS]


@pytest.mark.parametrize("name,model", S2S_CASES,
                         ids=[f"{n}-{m}" for n, m in S2S_CASES])
def test_sharded_seq2seq_loss_matches_the_reference(runs, refs, name, model):
    want = refs["s2s"][model][3]
    for got in runs[("s2s", name, model)]:
        assert abs(got - want) < S2S_TOL, (got, want)


def _port_specs(tree):
    return {path: tuple(sh.spec) for path, sh in tm._tree_paths(tree)}


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_seq2seq_param_shardings_match_the_reference_by_leaf_path(refs):
    import jax
    from jax.sharding import Mesh
    from tpu_dra_driver.workloads.models import seq2seq as js2
    params = refs["s2s"]["learned-flash"][0]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(
        js2.seq2seq_param_shardings(jmesh, params),
        is_leaf=lambda x: hasattr(x, "spec"))[0]
    for kp, sh in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                        for k in kp)
        want[path] = _strip(sh.spec)
    mesh = SimpleNamespace(mesh_dim_names=("dp", "tp"), shape=(2, 2))
    full = convert.params_from_jax(params, device="cpu")
    got = {p: _strip(s) for p, s in _port_specs(
        ts2.seq2seq_param_shardings(mesh, full)).items()}
    assert got == want
    assert got["decoder/layers/0/wq_x"] == (None, "tp")
    assert got["decoder/layers/0/wo_x"] == ("tp",)


def test_seq2seq_param_shardings_refuses_stacked_decoder_layers(refs):
    import jax
    from jax.sharding import Mesh
    from tpu_dra_driver.workloads.models import seq2seq as js2
    from tpu_dra_driver.workloads.models import transformer as jt
    params = refs["s2s"]["rope-oracle"][0]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    text = "expects the per-layer list layout"
    stacked = dict(params, decoder=jt.stack_layer_params(params["decoder"]))
    with pytest.raises(ValueError, match=text):
        js2.seq2seq_param_shardings(jmesh, stacked)
    full = convert.params_from_jax(params, device="cpu")
    full["decoder"] = tt.stack_layer_params(full["decoder"])
    mesh = SimpleNamespace(mesh_dim_names=("dp", "tp"), shape=(2, 2))
    with pytest.raises(ValueError, match=text):
        ts2.seq2seq_param_shardings(mesh, full)


def test_block_scales_narrow_only_off_the_quantized_axis():
    """A column block of codes takes its columns' scales; a row block
    (the quantized axis) keeps every scale."""
    w = tq.quantize(torch.randn(8, 6, generator=torch.Generator()
                                .manual_seed(0)))
    cols = tq.block_scales(tq.QTensor(q=w.q[:, 3:], s=w.s, axis=w.axis),
                           1, 1, 2)
    assert torch.equal(cols.s, w.s[3:])
    rows = tq.block_scales(tq.QTensor(q=w.q[4:], s=w.s, axis=w.axis),
                           0, 1, 2)
    assert torch.equal(rows.s, w.s)
