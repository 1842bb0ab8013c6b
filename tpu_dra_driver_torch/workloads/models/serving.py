"""Continuous-batching serving engine over the paged KV cache.

Port of :mod:`tpu_dra_driver.workloads.models.serving`. A fixed-capacity
batch of rows, each one in-flight request with its own block table into
shared per-layer K/V pools; requests join mid-flight (prefill into
freshly allocated blocks), decode steps run for all active rows at once,
and finished requests free their blocks.

- device: ``paged_decode_step(s)`` embed the pending tokens, project,
  apply RoPE at per-row positions, append one K/V vector per row to the
  pools and read them through ``paged_decode_attention`` (the CUDA
  kernel on the card);
- host (``ServingEngine``): block allocation, table/lens bookkeeping,
  admission, completion. Its decode steps are :meth:`_step_body`, one
  CUDA graph per ``n_live_blocks`` bucket replayed once per step on the
  card (the reference scans ``paged_decode_steps`` in one dispatch), the
  body itself on the CPU: tables, lens, tokens and the chunk's output
  live in static device buffers, copied in once and out once per chunk.
  Its admissions are :meth:`_admit_body` likewise, one CUDA graph per
  ``(t_bucket, nb_bucket)`` (the reference jits one per bucket shape):
  the padded prompt, its blocks and its length in static device
  buffers, the prefill, the pool writes and the first token's argmax in
  one replay.

Under a (dp, tp) mesh (``mesh=``) the params are this rank's ``tp``
shards as ``parallel.param_shardings`` places them and the pools hold
its ``n_kv / tp`` KV heads (``[n_blocks, n_kv / tp, block_t, hd]``, as
``P(None, "tp", None, None)`` places the reference's); kernel B4 reads
those heads, the row-parallel products and the embedding are summed
over ``tp`` and the logits joined before the argmax, so every rank
runs the same requests and picks the same tokens as one device.

Spans (``utils/profiling.py`` ``annotate``, recorded while a profile
runs): ``serve.admit`` around ``add``, with children
``serve.admit.prefill`` (the copies to the bucket's buffers and the
admission body's launch: a replay, or on a bucket's first use the eager
body with its batch-1 ``block_prefill`` and 2 x n_layers block writes),
``serve.admit.pool_write`` (the host's part of the block writes: the
row's table and length) and
``serve.admit.first_token`` (the host's read of the first token, which
waits for the card). Counters, over every engine of the process and
always on, as ``StepGraph.captures``: ``chunks``, ``decode_steps`` (the
sum of the chunks' k), ``row_steps`` (the sum of k x active rows),
``admits`` (admissions that reached the device) and ``admit_replays``
(of them, those a captured graph's replay served).

The pools are updated in place (the reference donates them to each jit
call instead), so a call that fails part-way leaves them in an unknown
state: any exception raised by the device work of ``add``, ``step`` or
``step_chunk`` poisons the engine and later calls raise.
``serving_throughput`` times the engine against per-request
``generate()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_dra_driver_torch.workloads import resolve_device
from tpu_dra_driver_torch.workloads.models.generate import (
    _embed, _heads, _logits, _tp_sum, block_prefill, generate,
    init_kv_cache, local_params,
)
from tpu_dra_driver_torch.workloads.models.quantize import mm
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig,
    Params,
    _ffn,
    _rmsnorm,
    apply_rope,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.ops.paged_attention import (
    init_pool,
    paged_decode_attention,
    pool_append,
)
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph
from tpu_dra_driver_torch.workloads.utils.profiling import annotate
from tpu_dra_driver_torch.workloads.utils.timing import (
    device_seconds_total,
    time_fn,
)


def _decode_core(params, cfg: ModelConfig, pool_ks, pool_vs,
                 tables, lens, tokens, n_live_blocks=None, mesh=None):
    """One decode step for every row: tokens [B] at per-row positions
    ``lens`` → (logits [B, vocab] fp32, pool_ks, pool_vs), the pools
    appended in place. Rows whose table row is 0 (inactive) write into
    the null block and their logits are garbage the host ignores.
    ``params`` may be a ``generate.Local``; ``mesh``: see the module's
    docstring."""
    b = tokens.shape[0]
    local = local_params(params, cfg, mesh)
    params, spmd = local.params, local.spmd
    n_heads, n_kv, hd = _heads(cfg, spmd)
    kv_d = hd * n_kv

    x = _embed(params, tokens, cfg, spmd)[:, None]                 # [B,1,d]
    if not cfg.use_rope:
        # caller contract: lens < max_seq; an index past the table raises
        # rather than reusing a clamped row
        x = x + params["pos_embed"][lens.long()][:, None]

    params = unstack_layer_params(params)
    for li, layer in enumerate(params["layers"]):
        xn = _rmsnorm(x, layer["ln1"]["g"])
        qkv = mm(xn, layer["wqkv"])
        q, k, v = qkv.split([hd * n_heads, kv_d, kv_d], dim=-1)
        q = q.reshape(b, 1, n_heads, hd).transpose(1, 2)
        k = k.reshape(b, 1, n_kv, hd).transpose(1, 2)
        v = v.reshape(b, 1, n_kv, hd).transpose(1, 2)
        if cfg.use_rope:
            q = apply_rope(q, pos0=lens)
            k = apply_rope(k, pos0=lens)
        pool_append(pool_ks[li], pool_vs[li], tables, lens,
                    k[:, :, 0], v[:, :, 0])
        att = paged_decode_attention(q.contiguous(), pool_ks[li],
                                     pool_vs[li], tables, lens + 1,
                                     n_live_blocks=n_live_blocks)
        att = att.transpose(1, 2).reshape(b, 1, hd * n_heads)
        x = x + _tp_sum(mm(att, layer["wo"]), spmd)
        x = x + _ffn(_rmsnorm(x, layer["ln2"]["g"]), layer, cfg, spmd)

    x = _rmsnorm(x, params["final_norm"]["g"])
    logits = _logits(x, params["embed"], spmd)[:, 0]
    return logits, pool_ks, pool_vs


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, pool_ks, pool_vs,
                      tables, lens, tokens, n_live_blocks=None, mesh=None):
    """Single-step entry point (pools appended in place)."""
    return _decode_core(params, cfg, pool_ks, pool_vs, tables, lens,
                        tokens, n_live_blocks=n_live_blocks, mesh=mesh)


@torch.no_grad()
def paged_decode_steps(params, cfg: ModelConfig, pool_ks, pool_vs,
                       tables, lens, tokens, n_steps: int,
                       n_live_blocks=None, mesh=None):
    """``n_steps`` greedy decode steps: each step's argmax is fed back as
    the next token without leaving the device. Returns (tokens [B,
    n_steps] int32 on the device, pool_ks, pool_vs); the caller copies
    the tokens to the host once per chunk. Callers bound ``n_steps`` so
    no active row appends past its block allocation."""
    out = []
    toks = tokens
    params = local_params(params, cfg, mesh)
    for _ in range(n_steps):
        logits, pool_ks, pool_vs = _decode_core(
            params, cfg, pool_ks, pool_vs, tables, lens, toks,
            n_live_blocks=n_live_blocks)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
        lens = lens + 1
    return torch.stack(out, dim=1), pool_ks, pool_vs


@torch.no_grad()
def _admit_prefill(params, tokens, pool_ks, pool_vs, blocks,
                   cfg: ModelConfig, block_t: int, true_len=None,
                   mesh=None):
    """Admission: dense prompt prefill through ``block_prefill``, then
    each layer's K/V written into the allocated pool blocks (in place).
    Returns (last_logits [1, vocab], pool_ks, pool_vs).

    ``tokens`` [1, t_bucket] and ``blocks`` [nb_bucket] are padded to
    buckets by the engine, and are copied to the pools' device first
    where they are not there; ``true_len`` (an int, or a 0-d integer
    tensor on that device, the reference's traced length, never read on
    the host) puts the logits on the real last token (causality shields
    it from the right-padding). The padded tail's K/V land past the
    written blocks, in slots that lens hides and the next appends
    overwrite, or in the null block (padded table entries are 0), which
    nothing reads.
    ``params`` may be a ``generate.Local``; ``mesh``: see the module's
    docstring."""
    t0 = tokens.shape[1]
    nb = blocks.shape[0]
    params = local_params(params, cfg, mesh)
    device = pool_ks[0].device
    tokens, blocks = tokens.to(device), blocks.to(device).long()
    cache = init_kv_cache(
        cfg, 1, t0, device=device,
        mesh=None if params.spmd is None else params.spmd.mesh)
    last_logits, cache, _ = block_prefill(
        params, cfg, cache, tokens,
        last_index=None if true_len is None else true_len - 1)
    for li in range(cfg.n_layers):
        for pool, kv in ((pool_ks[li], cache["k"][li][0]),
                         (pool_vs[li], cache["v"][li][0])):
            h_kv, length, hd = kv.shape            # [h_kv, Lpad, hd]
            pad = nb * block_t - length
            if pad > 0:
                kv = torch.nn.functional.pad(kv, (0, 0, 0, pad))
            tiles = kv[:, :nb * block_t].reshape(h_kv, nb, block_t, hd)
            pool[blocks] = tiles.transpose(0, 1).to(pool.dtype)
    return last_logits, pool_ks, pool_vs


@dataclass
class _Admission:
    """One admission bucket of an engine: the pinned host buffers, their
    static device copies that the body reads (``tokens`` [1, t_bucket]
    int32, ``blocks`` [nb_bucket] int64, ``true_len`` 0-d int64), the
    body's output (the first token, 0-d int64 on the device) and the
    :class:`StepGraph` that runs the body."""
    host: Dict[str, torch.Tensor]
    dev: Dict[str, torch.Tensor]
    first: torch.Tensor
    run: StepGraph


@dataclass
class _Request:
    rid: int
    row: int
    remaining: int
    tokens: List[int] = field(default_factory=list)   # generated so far
    pending: int = 0                                  # next token to feed


class ServingEngine:
    """Fixed-capacity continuous-batching decoder on ``device``. Not
    thread-safe; the caller owns the step loop (``run`` is the
    batteries-included version)."""

    # chunk sizes of the multi-step path, as in the reference
    CHUNK_SIZES = (32, 16, 8, 4, 2)

    # counters of every engine in the process (the module's docstring)
    chunks = 0
    decode_steps = 0
    row_steps = 0
    admits = 0
    admit_replays = 0

    def __init__(self, params: Params, cfg: ModelConfig, n_blocks: int,
                 block_t: int = 128, max_batch: int = 8,
                 max_blocks_per_seq: int = 32, device="cuda", mesh=None):
        if cfg.window > 0 or cfg.prefix > 0:
            raise ValueError("ServingEngine supports causal full-cache "
                             "models (window == 0, prefix == 0)")
        if cfg.kv_int8:
            raise ValueError("ServingEngine pools are not quantized; "
                             "cfg.kv_int8 would silently diverge from "
                             "generate() — use int8 weights instead")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        # what the steps read: under a mesh, the rank's heads' columns
        # gathered once here
        self._local = local_params(params, cfg, mesh)
        self.block_t = block_t
        _, n_kv, hd = _heads(cfg, self._local.spmd)
        self.pool_ks, self.pool_vs = [], []
        for _ in range(cfg.n_layers):
            pk, pv = init_pool(n_blocks, block_t, n_kv, hd, cfg.dtype,
                               device=self.device)
            self.pool_ks.append(pk)
            self.pool_vs.append(pv)
        self.free = list(range(n_blocks - 1, 0, -1))   # block 0 = null
        # the host's tables, lens and pending tokens, in pinned memory on
        # a card so that a chunk's copies to the device do not wait, and
        # their static device copies, which the step graphs read
        cuda = self.device.type == "cuda"
        self._host = {
            "tables": torch.zeros((max_batch, max_blocks_per_seq),
                                  dtype=torch.int32, pin_memory=cuda),
            "lens": torch.zeros((max_batch,), dtype=torch.int32,
                                pin_memory=cuda),
            "tokens": torch.zeros((max_batch,), dtype=torch.int32,
                                  pin_memory=cuda)}
        self.tables = self._host["tables"].numpy()
        self.lens = self._host["lens"].numpy()
        self._dev = {k: torch.zeros_like(v, device=self.device)
                     for k, v in self._host.items()}
        self._out = torch.zeros((max_batch, max(self.CHUNK_SIZES)),
                                dtype=torch.int32, device=self.device)
        self._col = torch.zeros((), dtype=torch.int64, device=self.device)
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._steps: Dict[int, StepGraph] = {}
        self._admits: Dict[Tuple[int, int], _Admission] = {}
        self.rows: List[Optional[_Request]] = [None] * max_batch
        self._next_rid = 0
        self.finished: Dict[int, List[int]] = {}
        self._poisoned: Optional[str] = None

    def _check_alive(self) -> None:
        if self._poisoned:
            raise RuntimeError(f"ServingEngine poisoned: {self._poisoned}")

    def _live_blocks_bucket(self, extra_tokens: int) -> int:
        """Bound on the paged-attention block walk: enough blocks to cover
        every active row's length after ``extra_tokens`` more appends,
        bucketed to a power of two and capped at the table width."""
        max_len = int(max((int(self.lens[r.row]) for r in self.rows
                           if r is not None), default=0))
        need = max(1, -(-(max_len + extra_tokens) // self.block_t))
        bucket = 1 << (need - 1).bit_length()
        return min(bucket, self.tables.shape[1])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- admission -------------------------------------------------------
    def add(self, prompt: List[int], max_new_tokens: int) -> int:
        """Prefill + admit one request; returns its request id. Raises
        RuntimeError when no row or not enough blocks are free."""
        self._check_alive()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        t0 = len(prompt)
        if t0 == 0:
            raise ValueError("prompt must be non-empty")
        if not self.cfg.use_rope and t0 + max_new_tokens > self.cfg.max_seq:
            raise ValueError(f"t0+max_new_tokens ({t0 + max_new_tokens}) "
                             f"exceeds max_seq {self.cfg.max_seq}")
        need = -(-(t0 + max_new_tokens) // self.block_t)
        if need > self.tables.shape[1]:
            raise RuntimeError(f"request needs {need} blocks > "
                               f"max_blocks_per_seq {self.tables.shape[1]}")
        row = next((i for i, r in enumerate(self.rows) if r is None), None)
        if row is None:
            raise RuntimeError("batch full")
        if len(self.free) < need:
            raise RuntimeError("pool exhausted")

        # admission shapes are bucketed as in the reference (prompt length
        # to max(32, pow2), prompt blocks to pow2); padded table entries
        # are 0 = the null block
        n_prompt = -(-t0 // self.block_t)
        t_bucket = max(32, 1 << (t0 - 1).bit_length())
        if not self.cfg.use_rope:
            t_bucket = min(t_bucket, self.cfg.max_seq)
        nb_bucket = max(1, 1 << (n_prompt - 1).bit_length())
        with annotate("serve.admit"):
            blocks = [self.free.pop() for _ in range(need)]
            try:
                adm = self._admission(t_bucket, nb_bucket)
                with annotate("serve.admit.prefill"):
                    toks = adm.host["tokens"].numpy()
                    toks[0, :t0] = prompt
                    toks[0, t0:] = 0
                    adm.host["blocks"].numpy()[:] = \
                        blocks[:n_prompt] + [0] * (nb_bucket - n_prompt)
                    adm.host["true_len"].fill_(t0)
                    for name, buf in adm.dev.items():
                        buf.copy_(adm.host[name], non_blocking=True)
                    replay = adm.run.graph is not None
                    adm.run()
                with annotate("serve.admit.pool_write"):
                    self.tables[row, :need] = blocks
                    self.tables[row, need:] = 0
                    self.lens[row] = t0
                with annotate("serve.admit.first_token"):
                    first = int(adm.first)
            except BaseException:
                self.free.extend(reversed(blocks))
                self.tables[row] = 0
                self.lens[row] = 0
                self._poisoned = ("admission failed while writing the "
                                  "pools; engine state is unrecoverable")
                raise
            ServingEngine.admits += 1
            ServingEngine.admit_replays += replay

            req = _Request(rid=self._next_rid, row=row,
                           remaining=max_new_tokens)
            self._next_rid += 1
            req.tokens.append(first)
            req.remaining -= 1
            req.pending = first
            self.rows[row] = req
            if req.remaining == 0:
                self._finish(req)
        return req.rid

    def _admission(self, t_bucket: int, nb_bucket: int) -> _Admission:
        """The admission bucket ``(t_bucket, nb_bucket)``, made at its
        first use. Its body runs under a :class:`StepGraph` in the
        decode steps' graph pool (an admission and a decode step never
        run at once, and the first token is read before anything else
        replays): on a card the bucket's first admission warms it up,
        its second captures it, later ones replay."""
        adm = self._admits.get((t_bucket, nb_bucket))
        if adm is None:
            cuda = self.device.type == "cuda"
            host = {"tokens": torch.zeros((1, t_bucket), dtype=torch.int32,
                                          pin_memory=cuda),
                    "blocks": torch.zeros((nb_bucket,), dtype=torch.int64,
                                          pin_memory=cuda),
                    "true_len": torch.zeros((), dtype=torch.int64,
                                            pin_memory=cuda)}
            dev = {k: torch.zeros_like(v, device=self.device)
                   for k, v in host.items()}
            first = torch.zeros((), dtype=torch.int64, device=self.device)
            body = self._admit_body(dev, first)
            adm = self._admits[(t_bucket, nb_bucket)] = _Admission(
                host, dev, first,
                StepGraph(body, self.device, pool=self._graph_pool))
        return adm

    def _admit_body(self, dev: Dict[str, torch.Tensor], first: torch.Tensor):
        """One admission as a function of no arguments, for
        :class:`StepGraph`: the prefill of ``dev["tokens"]``, its K/V
        written to the pool blocks ``dev["blocks"]``, and the argmax of
        the logits at ``dev["true_len"] - 1`` written to ``first``, all
        on the device."""
        # the engine's tensors, not the engine (see _step_body)
        params, cfg, pool_ks, pool_vs, block_t = (
            self._local, self.cfg, self.pool_ks, self.pool_vs, self.block_t)

        def body():
            logits, _, _ = _admit_prefill(
                params, dev["tokens"], pool_ks, pool_vs, dev["blocks"], cfg,
                block_t, true_len=dev["true_len"])
            first.copy_(torch.argmax(logits))

        return body

    # -- stepping --------------------------------------------------------
    def _step_body(self, n_live_blocks: int):
        """One decode step of every row as a function of no arguments,
        for :class:`StepGraph`: it reads the tables, lens and tokens from
        their device buffers, appends to the pools, writes the argmax to
        column ``_col`` of ``_out`` and feeds it back, and advances lens
        and ``_col`` by one, all in place."""
        # the body holds the engine's tensors, not the engine: a graph
        # kept in the engine must not keep the engine alive in a cycle
        params, cfg, pool_ks, pool_vs = (self._local, self.cfg,
                                         self.pool_ks, self.pool_vs)
        d, out, col = self._dev, self._out, self._col

        def body():
            logits, _, _ = _decode_core(
                params, cfg, pool_ks, pool_vs, d["tables"], d["lens"],
                d["tokens"], n_live_blocks=n_live_blocks)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out.index_copy_(1, col.view(1), nxt[:, None])
            d["tokens"].copy_(nxt)
            d["lens"].add_(1)
            col.add_(1)

        return body

    def _decode(self, active: List[_Request], k: int) -> np.ndarray:
        """``k`` greedy decode steps of every row: the host arrays copied
        to the device once, the step of the ``n_live_blocks`` bucket run
        k times, the [max_batch, k] tokens copied back once. Any
        exception poisons the engine."""
        try:
            self._host["tokens"].numpy()[:] = self._pending_tokens(active)
            for name, buf in self._dev.items():
                buf.copy_(self._host[name], non_blocking=True)
            self._col.zero_()
            n_live = self._live_blocks_bucket(k)
            step = self._steps.get(n_live)
            if step is None:
                step = self._steps[n_live] = StepGraph(
                    self._step_body(n_live), self.device,
                    pool=self._graph_pool)
            for _ in range(k):
                step()
            return self._out[:, :k].cpu().numpy()
        except BaseException:
            self._poisoned = ("decode failed while appending to the pools; "
                              "engine state is unrecoverable")
            raise

    def _pending_tokens(self, active: List[_Request]) -> np.ndarray:
        tokens = np.zeros((len(self.rows),), np.int32)
        for r in active:
            tokens[r.row] = r.pending
        return tokens

    def step(self) -> Dict[int, int]:
        """One batched decode step (``step_chunk``'s k = 1 case); returns
        {rid: new_token} for rows that produced one. No-op on an idle
        engine."""
        return {rid: toks[0] for rid, toks in self.step_chunk(1).items()}

    def step_chunk(self, max_steps: int = 32) -> Dict[int, List[int]]:
        """Up to ``max_steps`` decode steps with the argmax fed back on the
        device. The chunk length is the largest of CHUNK_SIZES <=
        min(max_steps, min remaining over active rows), so no row appends
        past its allocation or finishes mid-chunk; a bound below 2 takes
        one step. Returns {rid: new tokens}."""
        self._check_alive()
        active = [r for r in self.rows if r is not None]
        if not active:
            return {}
        bound = min(max_steps, min(r.remaining for r in active))
        k = next((c for c in self.CHUNK_SIZES if c <= bound), 1)
        toks = self._decode(active, k)
        out: Dict[int, List[int]] = {}
        for r in active:
            got = [int(t) for t in toks[r.row]]
            self.lens[r.row] += k
            r.tokens.extend(got)
            r.pending = got[-1]
            r.remaining -= k
            out[r.rid] = got
            if r.remaining == 0:
                self._finish(r)
        ServingEngine.chunks += 1
        ServingEngine.decode_steps += k
        ServingEngine.row_steps += k * len(active)
        return out

    def _finish(self, req: _Request) -> None:
        used = {int(b) for b in self.tables[req.row] if b != 0}
        self.free.extend(sorted(used, reverse=True))
        self.tables[req.row] = 0
        self.lens[req.row] = 0
        self.rows[req.row] = None
        self.finished[req.rid] = req.tokens

    # -- convenience -----------------------------------------------------
    def run(self, prompts: List[List[int]],
            max_new_tokens: int,
            max_steps_per_dispatch: int = 32) -> Dict[int, List[int]]:
        """Admit as many prompts as fit, decode to completion, admit the
        rest as rows free up; returns {rid: generated tokens}.
        ``max_steps_per_dispatch=1`` forces single-step decoding."""
        pending = list(prompts)
        rids = []
        while pending or any(r is not None for r in self.rows):
            admitted = False
            while pending:
                try:
                    rids.append(self.add(pending[0], max_new_tokens))
                    pending.pop(0)
                    admitted = True
                except RuntimeError as e:
                    self._check_alive()
                    if not any(r is not None for r in self.rows):
                        raise RuntimeError(
                            f"request cannot be admitted even on an idle "
                            f"engine: {e}") from e
                    break
            if (not self.step_chunk(max_steps=max_steps_per_dispatch)
                    and not admitted and pending):
                raise RuntimeError("engine stalled with pending requests")
        return {rid: self.finished[rid] for rid in rids}


def serving_throughput(params: Params, cfg: ModelConfig,
                       prompts: List[List[int]], max_new_tokens: int,
                       n_blocks: int, block_t: int = 128,
                       max_batch: int = 8, max_blocks_per_seq: int = 32,
                       device="cuda") -> Dict:
    """Continuous-batching throughput of :class:`ServingEngine` against
    per-request greedy ``generate()`` on the same params (on
    ``device``), decomposed as in the reference:

    - ``speedup_batching``: device-busy time of the sequential run over
      the engine's (host dispatch excluded on both sides), what batching
      itself buys; ``engine_device_tokens_per_sec`` is the headline;
    - ``speedup_dispatch``: engine wall time at single-step dispatch over
      multi-step (32) dispatch, what device-side stepping buys;
    - ``speedup``: the end-to-end wall ratio, sequential over engine.

    Wall times are the best of two timed runs after one warm-up. The
    device keys are None without a card. ``outputs`` and
    ``sequential_outputs`` map each prompt's index to its generated
    tokens on the two paths."""
    dev = resolve_device(device)
    total = len(prompts) * max_new_tokens
    captured: Dict[int, List[int]] = {}
    sequential: Dict[int, List[int]] = {}

    def run_engine(max_steps: int = 32):
        eng = ServingEngine(params, cfg, n_blocks=n_blocks,
                            block_t=block_t, max_batch=max_batch,
                            max_blocks_per_seq=max_blocks_per_seq,
                            device=dev)
        got = eng.run(prompts, max_new_tokens,
                      max_steps_per_dispatch=max_steps)
        captured.update({i: got[rid]
                         for i, rid in enumerate(sorted(got))})
        return got

    def run_sequential():
        outs = [generate(params, cfg,
                         torch.tensor([p], dtype=torch.int32, device=dev),
                         steps=max_new_tokens)[0, len(p):]
                for p in prompts]
        sequential.update({i: o.tolist() for i, o in enumerate(outs)})
        return outs

    t_eng = time_fn(run_engine, warmup=1, iters=2).best_s
    t_seq = time_fn(run_sequential, warmup=1, iters=2).best_s
    # single-step dispatch: same engine, same batching, one host round
    # trip per token
    t_eng_1 = time_fn(lambda: run_engine(max_steps=1),
                      warmup=1, iters=2).best_s
    d_eng = device_seconds_total(run_engine)
    d_seq = device_seconds_total(run_sequential)
    out = {"engine_tokens_per_sec": total / t_eng,
           "sequential_tokens_per_sec": total / t_seq,
           "speedup": t_seq / t_eng,
           "speedup_dispatch": t_eng_1 / t_eng,
           "outputs": captured,
           "sequential_outputs": sequential}
    if d_eng and d_seq:
        out["engine_device_tokens_per_sec"] = total / d_eng
        out["sequential_device_tokens_per_sec"] = total / d_seq
        out["speedup_batching"] = d_seq / d_eng
    else:
        out["engine_device_tokens_per_sec"] = None
        out["sequential_device_tokens_per_sec"] = None
        out["speedup_batching"] = None
    return out
