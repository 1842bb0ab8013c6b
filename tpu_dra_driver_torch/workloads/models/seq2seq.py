"""Encoder-decoder (seq2seq) model family: T5-recipe cross-attention.

Port of :mod:`tpu_dra_driver.workloads.models.seq2seq`: a bidirectional
encoder over the source (the decoder-only stack's ``forward`` under an
all-prefix config, stopped before the LM head) and a causal decoder
whose blocks carry a third sublayer, cross-attention over the encoder
output. The decoder shares the encoder's embedding and tied head.

``attn_fn`` is the plug point that ``forward`` and ``make_train_step``
have: ``None`` is the reference's math (``attention_reference`` for the
encoder's and the decoder's self-attention, the einsum pair of
:func:`_cross_attention`); a given ``attn_fn`` (``flash_attention``:
kernels B1-B3 on the card) takes all three, the cross-attention with
``causal=False``, so no ``[b, h, t_tgt, t_src]`` score tensor is made.
Both compute the same function.

``greedy_decode`` runs the whole decoder over a fixed ``[b, steps + 1]``
buffer at every step, as the reference does (no KV cache), eagerly.

Under a (dp, tp) mesh (``mesh=``, where the reference reads the mesh off
its arrays' shardings) the params are this rank's shards as
:func:`seq2seq_param_shardings` places them and the batch its ``dp``
rows: each stack runs its ``tp`` share of the heads (the cross
attention's too: ``wq_x`` and ``wkv_x`` column-parallel, ``wo_x``
row-parallel, summed over ``tp``), the embedding is vocab-parallel, and
the loss is the global mean over the ranks' rows, as the sharded
``transformer.loss_fn`` takes it. Every collective over an axis of size
1 is skipped.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.quantize import (
    embed_lookup, lm_head, mm,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    AdamW,
    Adafactor,
    ModelConfig,
    Params,
    _attention,
    _ffn,
    _rmsnorm,
    forward,
    init_params,
    nll_from_logits,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.ops.attention import attention_reference


@dataclass(frozen=True)
class Seq2SeqConfig:
    """Two stacks with a shared vocab and width, separate depths and
    lengths. ``bos`` starts every decoder input row. ``dtype`` is a torch
    dtype."""

    vocab: int
    d_model: int
    n_heads: int
    n_enc_layers: int
    n_dec_layers: int
    d_ff: int
    max_src: int
    max_tgt: int
    n_kv_heads: int = 0
    use_rope: bool = True
    bos: int = 0
    dtype: torch.dtype = torch.bfloat16

    def encoder_cfg(self) -> ModelConfig:
        """The encoder: the shared stack with the whole source in the
        bidirectional prefix (``prefix = max_src``)."""
        return ModelConfig(
            vocab=self.vocab, d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, n_layers=self.n_enc_layers,
            d_ff=self.d_ff, max_seq=self.max_src, use_rope=self.use_rope,
            prefix=self.max_src, dtype=self.dtype)

    def decoder_cfg(self) -> ModelConfig:
        return ModelConfig(
            vocab=self.vocab, d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, n_layers=self.n_dec_layers,
            d_ff=self.d_ff, max_seq=self.max_tgt, use_rope=self.use_rope,
            dtype=self.dtype)


def init_seq2seq_params(cfg: Seq2SeqConfig,
                        key: Union[int, torch.Generator],
                        device="cuda") -> Params:
    """``{"encoder": <transformer params>, "decoder": <transformer params
    without "embed", plus per-layer cross-attention weights>}`` with the
    reference's keys and shapes. ``key`` is a seed or a CPU
    :class:`torch.Generator`, drawn from in order (encoder, decoder,
    cross weights) on the CPU in fp32. Each decoder layer gains
    ``lnx`` (unit gain), ``wq_x`` and ``wkv_x`` (N(0, 0.02)) and a zero
    ``wo_x``, so every decoder block starts as the plain LM block."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) \
        else torch.Generator().manual_seed(int(key))
    enc = init_params(cfg.encoder_cfg(), gen, device=dev)
    dec = init_params(cfg.decoder_cfg(), gen, device=dev)
    del dec["embed"]                        # shared with the encoder
    n_kv = cfg.n_kv_heads or cfg.n_heads
    kv_d = cfg.d_model * n_kv // cfg.n_heads

    def mat(shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (0.02 * w).to(device=dev, dtype=cfg.dtype)

    for layer in dec["layers"]:
        layer["lnx"] = {"g": torch.ones((cfg.d_model,), dtype=torch.float32,
                                        device=dev)}
        layer["wq_x"] = mat((cfg.d_model, cfg.d_model))
        layer["wkv_x"] = mat((cfg.d_model, 2 * kv_d))
        layer["wo_x"] = torch.zeros((cfg.d_model, cfg.d_model),
                                    dtype=cfg.dtype, device=dev)
    return {"encoder": enc, "decoder": dec}


class _OnMesh:
    """``attn_fn`` (the oracle when None) carrying the mesh layout
    ``spmd``, as the sharded attentions of ``parallel`` carry theirs, so
    that ``transformer.forward`` runs a stack on this rank's shards."""

    def __init__(self, attn_fn, spmd):
        self.fn = attn_fn or attention_reference
        self.spmd = spmd

    def __call__(self, q, k, v, *args, **kwargs):
        return self.fn(q, k, v, *args, **kwargs)


def _spmd(mesh):
    if mesh is None:
        return None
    from tpu_dra_driver_torch.workloads.parallel.spmd import Spmd
    return Spmd(mesh)


def _cross_attention(x: torch.Tensor, enc_out: torch.Tensor, layer: Params,
                     n_heads: int, n_kv_heads: int = 0,
                     attn_fn=None, spmd=None) -> torch.Tensor:
    """Unmasked attention of the decoder positions x [b, tq, d] over the
    encoder output [b, ts, d]; grouped KV heads fold into the query
    heads as in self-attention's GQA; no rotary embedding. ``attn_fn``
    None: the reference's einsum pair (scores / sqrt(hd) in x's dtype,
    softmax in f32 cast to x's dtype, then the value product); otherwise
    ``attn_fn(q, k, v, causal=False)`` on [b, h, t, hd] tensors.
    Sharded (``spmd``), this rank's ``tp`` share of the heads: its block
    of ``wq_x``'s columns, its heads' columns of the fused ``wkv_x``
    (gathered), and ``wo_x``'s partial sums summed over ``tp``."""
    b, tq, d = x.shape
    ts = enc_out.shape[1]
    n_kv = n_kv_heads or n_heads
    hd = d // n_heads
    group = n_heads // n_kv
    wkv = layer["wkv_x"]
    if spmd is not None:
        wkv = spmd.head_columns(wkv, (hd * n_kv, hd * n_kv))
        n_heads, n_kv = spmd.local_heads(n_heads, n_kv)
    q = mm(x, layer["wq_x"]).reshape(b, tq, n_heads, hd)
    k, v = mm(enc_out, wkv).chunk(2, dim=-1)
    k = k.reshape(b, ts, n_kv, hd)
    v = v.reshape(b, ts, n_kv, hd)
    if attn_fn is not None:
        out = attn_fn(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=False)
        out = out.transpose(1, 2).reshape(b, tq, hd * n_heads)
    else:
        qg = q.reshape(b, tq, n_kv, group, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", w, v).reshape(
            b, tq, hd * n_heads)
    out = mm(out, layer["wo_x"])
    return out if spmd is None else spmd.psum(out, ("tp",))


def encode(params: Params, src: torch.Tensor, cfg: Seq2SeqConfig,
           attn_fn=None, mesh=None) -> torch.Tensor:
    """src [b, ts] → the encoder's final-normed hidden states [b, ts, d]:
    ``forward`` under the all-prefix config with ``return_hidden``. A
    source longer than ``max_src`` raises (past it the prefix mask would
    turn the tail causal); a shorter one is bidirectional throughout.
    ``mesh``: see the module's docstring."""
    if src.shape[1] > cfg.max_src:
        raise ValueError(f"source length {src.shape[1]} exceeds "
                         f"max_src ({cfg.max_src})")
    if mesh is not None:
        attn_fn = _OnMesh(attn_fn, _spmd(mesh))
    return forward(params["encoder"], src, cfg.encoder_cfg(), attn_fn,
                   return_hidden=True)


def _decoder_hidden(params: Params, src: torch.Tensor, tgt_in: torch.Tensor,
                    cfg: Seq2SeqConfig, enc_out, attn_fn, mesh
                    ) -> torch.Tensor:
    """The decoder's final-normed hidden states [b, tt, d]."""
    dcfg = cfg.decoder_cfg()
    if tgt_in.shape[1] > cfg.max_tgt:
        raise ValueError(f"target length {tgt_in.shape[1]} exceeds "
                         f"max_tgt ({cfg.max_tgt})")
    if enc_out is None:
        enc_out = encode(params, src, cfg, attn_fn, mesh)
    spmd = _spmd(mesh)
    dec = params["decoder"]
    t = tgt_in.shape[1]
    if spmd is None:
        x = embed_lookup(params["encoder"]["embed"], tgt_in, dcfg.dtype)
        if not dcfg.use_rope:
            x = x + dec["pos_embed"][:t]
    else:
        x = spmd.embed(params["encoder"]["embed"], tgt_in, dcfg.dtype)
        if not dcfg.use_rope:
            x = x + spmd.pos_rows(dec["pos_embed"], t)
    for layer in unstack_layer_params(dec)["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1"]["g"]), layer,
                           dcfg.n_heads, dcfg.n_kv_heads, attn_fn,
                           use_rope=dcfg.use_rope, spmd=spmd)
        x = x + _cross_attention(_rmsnorm(x, layer["lnx"]["g"]), enc_out,
                                 layer, dcfg.n_heads, dcfg.n_kv_heads,
                                 attn_fn, spmd)
        x = x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, dcfg, spmd)
    return _rmsnorm(x, dec["final_norm"]["g"])


def decode_forward(params: Params, src: torch.Tensor, tgt_in: torch.Tensor,
                   cfg: Seq2SeqConfig,
                   enc_out: Optional[torch.Tensor] = None,
                   attn_fn=None, mesh=None) -> torch.Tensor:
    """Teacher-forced decoder: (src [b, ts], tgt_in [b, tt]) → logits
    [b, tt, vocab] f32. ``enc_out`` reuses a precomputed encoding;
    without it the encoder runs inline (training). A target longer than
    ``max_tgt`` raises. Under ``mesh`` the logits of this rank's rows
    over the whole vocabulary (joined over ``tp``)."""
    x = _decoder_hidden(params, src, tgt_in, cfg, enc_out, attn_fn, mesh)
    logits = lm_head(x, params["encoder"]["embed"])
    return logits if mesh is None else _spmd(mesh).vocab_logits(logits)


def seq2seq_loss_fn(params: Params,
                    batch: Tuple[torch.Tensor, torch.Tensor],
                    cfg: Seq2SeqConfig, attn_fn=None,
                    mesh=None) -> torch.Tensor:
    """Teacher-forced NLL: the decoder sees BOS + tgt[:, :-1] and
    predicts tgt. Under a mesh of more than one rank, the global mean
    (every rank gets the same) from this rank's vocab shard of the
    logits (see the module's docstring)."""
    src, tgt = batch
    bos = torch.full((tgt.shape[0], 1), cfg.bos, dtype=tgt.dtype,
                     device=tgt.device)
    tgt_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    spmd = _spmd(mesh)
    x = _decoder_hidden(params, src, tgt_in, cfg, None, attn_fn, mesh)
    logits = lm_head(x, params["encoder"]["embed"])
    if spmd is None or spmd.world == 1:
        return nll_from_logits(logits, tgt)
    return spmd.mean_nll(spmd.token_nll(logits, tgt), None)


def make_seq2seq_train_step(cfg: Seq2SeqConfig,
                            optimizer: Optional[Union[AdamW,
                                                      Adafactor]] = None,
                            attn_fn=None):
    """(train_step, init_opt_state), as ``make_train_step``:
    ``train_step(params, opt_state, (src, tgt))`` updates the params IN
    PLACE and returns ``(params, opt_state, loss)`` with the loss
    detached. The default optimizer is ``optax.adamw(1e-3)``:
    ``AdamW(1e-3)``."""
    opt = optimizer or AdamW(1e-3)

    def train_step(params, opt_state, batch):
        loss = seq2seq_loss_fn(params, batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, opt_state.leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
        opt_state.apply(grads)
        return params, opt_state, loss.detach()

    return train_step, opt.init


@torch.no_grad()
def greedy_decode(params: Params, src: torch.Tensor, cfg: Seq2SeqConfig,
                  steps: int, attn_fn=None) -> torch.Tensor:
    """Greedy generation: src [b, ts] → target tokens [b, steps] int32.
    The encoder runs once; a ``[b, steps + 1]`` buffer (BOS first) is
    filled one position a step, each step running the whole decoder over
    the buffer (causality keeps the written positions' logits fixed).
    ``steps`` past ``max_tgt - 1`` raises."""
    if steps > cfg.max_tgt - 1:
        raise ValueError(f"steps {steps} exceeds max_tgt-1 "
                         f"({cfg.max_tgt - 1})")
    enc_out = encode(params, src, cfg, attn_fn)
    buf = torch.full((src.shape[0], steps + 1), cfg.bos, dtype=torch.int32,
                     device=src.device)
    for i in range(steps):
        logits = decode_forward(params, src, buf, cfg, enc_out=enc_out,
                                attn_fn=attn_fn)
        buf[:, i + 1] = torch.argmax(logits[:, i], dim=-1).to(torch.int32)
    return buf[:, 1:]


def seq2seq_param_shardings(mesh, params: Params) -> Dict:
    """NamedShardings for both stacks: the shared transformer leaf names
    shard by the Megatron rules (``parallel.param_shardings`` handles
    each stack), and the cross-attention projections follow their
    self-attention analogs (``wq_x``/``wkv_x`` column-parallel like
    ``wqkv``, ``wo_x`` row-parallel like ``wo``)."""
    from tpu_dra_driver_torch.workloads.parallel.mesh import (
        NamedSharding, param_shardings,
    )

    out = {
        "encoder": param_shardings(mesh, params["encoder"]),
        "decoder": param_shardings(mesh, params["decoder"]),
    }
    col = NamedSharding(mesh, (None, "tp"))
    row = NamedSharding(mesh, ("tp", None))
    dec_layers = out["decoder"]["layers"]
    if not isinstance(dec_layers, list):
        # stacked (scan_layers) decoders would need a leading [L] axis
        # on every spec; this family stores per-layer lists (see
        # init_seq2seq_params): refuse rather than shard a wrong axis
        raise ValueError("seq2seq_param_shardings expects the per-layer "
                         "list layout; got stacked decoder layers")
    for lay in dec_layers:
        if "wq_x" in lay:
            lay["wq_x"] = col
            lay["wkv_x"] = col
            lay["wo_x"] = row
    return out
