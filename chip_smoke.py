#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_dra_driver_torch``).

Drives the port's serving, generation and training paths, the
mixture-of-experts, Adafactor, LoRA, masked-LM encoder, encoder-decoder,
beam-search and speculative-decoding paths, the input pipeline,
checkpoints, profiling, the single-device benchmarks, the sharded
training tier, the GPipe pipeline and the sharded inference and state
callers (at world size 1), and the paths at head dim 256, on one CUDA
card and checks them; imports no JAX. Phases, each of which fails the
run when it fails:

1. card: the card's name and power limit from nvidia-smi;
2. build: the CUDA kernels from the sources in the checkout, one nvcc
   per source, all started together (sm_90a); ptxas's report read per
   entry function: no B1 instantiation may spill or carry a wgmma note
   (a ``warpgroup.arrive`` injected between its products, C7519, an
   injected wait or serialised products), and the notes are printed for
   every sm90 flash kernel;
3. paged kernel: the paged-attention decode kernel (B4) against its
   plain PyTorch version at the full-width serving shapes and at the
   edges of its split (rows ending one token into a 64-token chunk, rows
   of one chunk, 16-token blocks), in f32 and in bf16, the bf16 results
   row by row against an f32 reference with a 64-slot sub-tile left out
   shown to break that allowance (timed, with its bound and a library
   call as yardstick; its two launches are timed apart at the end);
4. flash kernels: the flash-attention forward (B1), dq (B2) and dk/dv
   (B3) kernels against their plain versions over every mask form in
   f32, over every mask form in bf16 (ragged tiles, GQA, head dims 16 to
   128) and at the full-width training shapes in bf16, the bf16 results
   row by row against an f32 reference (timed likewise); B1's persistent
   schedule at fewer work items than SMs, at many more with ragged t and
   tkv, and with whole items whose rows see no column, each with a tile
   left out shown to break the allowance; B1 at the training shape run
   twice, bit-identical, and replayed from a CUDA graph, equal to the
   eager call;
5. flash-decode kernel: B5 against its plain version at the full-width
   generation shapes (q [8, 16, 1, 128], cache [8, 4, 3200, 128]) in
   bf16 and int8 row by row against an f32 reference, with a 64-slot
   sub-tile left out shown to break that allowance, in f32 at the first,
   a middle and the last slot, on a wrapped ring, and with one KV head
   (MQA); every read also with its position on the device, launched
   under sync-debug mode and bit-identical to the int position; NaN in
   the slots (and scales) past pos leaving the output unchanged; one
   CUDA graph of B5 replayed at five positions, each equal to the eager
   call (timed likewise, then its split and merge kernels and SDPA under
   ``torch.profiler``);
6. engine parity: the ``ServingTraffic`` configuration in fp32 through
   the engine on the card and on the CPU, same weights and prompts;
7. serving: the full-width serving configuration (vocab 8192, d_model
   1024, 8 heads over 4 KV heads, 6 layers, RoPE, bf16; six prompts of
   256-512 tokens, 96 new tokens each) through ``ServingEngine.run``,
   whose decode steps replay one CUDA graph per block bucket: B4's
   launches counted per replay over that run, its tokens equal to the
   warm-up run's, the wall rate with the capture time apart; a decode
   chunk of replays against ``paged_decode_step`` run eagerly from
   identical pools; then ``serving_throughput`` (the engine against
   per-request ``generate()``, same outputs up to near-ties), then the
   run once more under ``torch.profiler`` for B4's share of its device
   time;
8. generation parity: a small GQA/RoPE config in fp32, greedy
   ``generate`` (replays of its captured step, under sync-debug mode)
   and teacher-forced ``decode_step`` on the card and on the CPU
   (full-length cache, int8 cache, a wrapped ring, chunked prefill),
   with B5's launches counted on the card; sampling on the card with
   the caller's generator registered with the graph (top_k = 1 is
   greedy, a seed repeats its draws);
9. generation: the full-width decode configuration (vocab 8192, d_model
   2048, 16 heads over 4 KV heads, 8 layers, d_ff 8192, RoPE, bf16; batch
   8, prompt 2048, chains of 32 and 1056 tokens) through
   ``decode_tokens_per_sec`` in bf16, with int8 weights and an int8
   cache, and with int8 weights alone: the wall ms per step (marginal
   between the chains, each a ``generate`` call that replays its
   captured step under sync-debug mode), the device ms per step, the
   idle share and the capture time, beside the eager loop's figures;
   B5's launches counted per replay over one long-chain call; the long
   chain by replays against the same chain by the eager step, in bf16
   over all its steps and with int8 over its first EAGER_CHECK_STEPS
   (tokens equal, or parting at a near-tie); then 32 decode steps under
   ``torch.profiler``, eager and as replays, whose device-busy times
   must agree with each other and with the long chain's;
10. training parity: a small GQA/RoPE config in fp32, three
   ``make_train_step`` steps on the card and on the CPU from one seed,
   and the loss of ``entry()`` on both;
11. training: the flagship training configuration (vocab 8192, d_model
   2048, 16 heads over 4 KV heads, 8 layers, d_ff 8192, RoPE, bf16,
   ``remat`` with the ``"dots"`` policy, ``scan_layers``; batch 8 x 2048;
   ``default_optimizer()``; flash attention) for one untimed and three
   timed steps, with B1-B3's launches counted over the timed steps, one
   more step under ``torch.profiler`` for its device time by kernel, and
   one of its blocks at b=1 on the card against the CPU;
12. MoE, Adafactor, LoRA and MLM parity: in fp32 on the card and on the
   CPU from one seed, the loss and gradients of a top-2 and a dense
   mixture of experts and of the MLM encoder (given one corruption),
   three Adafactor steps of the top-2 model and three AdamW steps of
   LoRA adapters (the base left bit-identical); two MLM steps on the
   card drawing their corruption from a CUDA generator; the MoE engine
   and MoE ``generate`` (float and int8 expert banks, replays under
   sync-debug mode) giving the CPU's greedy tokens;
13. MLM: B1-B3 at the bidirectional full-width shape (prefix = t, every
   pair visible), held row by row against an f32 reference with a tile
   left out shown to break that allowance, timed against their plain
   versions and SDPA without a causal mask; then three timed MLM steps
   of the encoder (the training configuration with prefix = max_seq),
   B1-B3's launches counted;
14. LoRA: rank-16 adapters on the training configuration's attention
   projections, three timed AdamW steps, the base bit-identical after;
15. MoE generation: the generation configuration with 8 experts, top-2
   (Mixtral 8x7B's routing), bf16; the 32- and 1056-step chains as
   replays (wall rate, idle share, capture time, B5 launches), the long
   chain's device time, and the long chain's first EAGER_CHECK_STEPS
   steps by the eager step (tokens equal, or parting at a near-tie);
16. MoE training: the training configuration with the same routing and
   capacity factor 1.25, Adafactor, from the generation phase's params;
   one untimed and three timed steps (B1-B3 launches counted, model
   TFLOP/s over the active parameters), then one more step under
   ``torch.profiler`` split into flash, cuBLAS, the MoE's products, its
   routing and the optimizer;
17. seq2seq, beam and speculative parity: in fp32 on the card and on the
   CPU from one seed, at the CPU tests' sizes: the seq2seq loss,
   gradients and three AdamW steps with ``attn_fn=flash_attention`` (a
   source shorter than ``max_src``; B1-B3's launches counted) and its
   greedy tokens; ``beam_search(return_all=True)`` under sync-debug mode
   (sequences equal, scores within 1e-5, each score its sequence's
   ``sequence_logprob`` within 1e-4, B5's launches counted over two
   alternating graphs); ``speculative_generate`` with a random and an
   int8 self-draft, each round's replay under sync-debug mode, equal to
   the card's own ``generate`` and to the CPU's rounds and acceptance,
   ``wide_step`` with g = 4 at a device position against the CPU, and
   ``speculative_sample`` with draft = target accepting everything;
18. seq2seq: B1-B3 at the cross-attention shape (q [8, 16, 512, 128],
   k/v [8, 4, 2048, 128], no mask), held row by row against an f32
   reference with a tile left out shown to break that allowance, timed
   against their plain versions and SDPA; then the full-width
   encoder-decoder (the training configuration's widths and depth in
   both stacks, 805M parameters; batch 8 x (2048 source, 512 target),
   AdamW(1e-3), flash attention): one untimed and three timed steps
   (24 launches each of B1-B3 a step asserted), one step under
   ``torch.profiler``, and ``greedy_decode`` for 64 steps (B1 launches
   asserted);
19. beam search: the generation configuration, batch 8, prompt 2048,
   beam 4, 128 steps (32 cache rows of 2176 slots) under sync-debug
   mode: B5's launches and the captures counted, wall and device ms per
   step (marginal against 32 steps), the idle share, the cache
   reorder's and B5's share of the step by the profiler, and the best
   row's score against ``sequence_logprob`` in bf16;
20. speculative decoding: the reference bench's own calls,
   ``speculative_decode_tokens_per_sec`` and
   ``early_exit_decode_tokens_per_sec`` (b 1, gamma 8, 256 tokens; the
   early-exit output exact or a near-tie), with the host reads per call;
   ``speculative_sample`` with draft = target at the generation widths,
   in f32 (every proposal accepted, asserted) and in bf16;
21. data, checkpoint and profiling: ``prefetch_to_device`` on the card
   (48 batches, each read after slow products on the consumer's stream,
   every device sum equal to the host's; the copies on a stream other
   than the consumer's, by ``trace_to``'s trace; an abandoned loop
   leaves no producer thread), then the full-width training state
   (369.1M parameters, AdamW) saved with ``save_train_state`` and
   restored onto the card and onto the CPU, both bit-equal, one step
   from the restored state equal to the continuation's loss and
   parameters bit for bit, and ``trace_to`` around one training step
   (its ``annotate`` span and B1-B3 in the trace);
22. attention benchmarks: B1-B3 at the flash benchmarks' causal MHA
   shape (b 4, h 8, t 2048, d 128) as in phase 4, and at the
   long-context window shape (b 1, h 8, t 16384, window 2048, d 128):
   B1 row by row against the oracle in f32 in row blocks at the start,
   middle and end (a tile of the band left out shown to break the
   allowance), all three against their plain versions over the whole
   shape, timed with SDPA (an explicit band mask, its backend printed);
   the gradients held in full at t 8192; then
   ``flash_attention_tflops``, ``flash_attention_train_tflops`` and the
   two long-context benchmarks (3 runs) at their reference defaults,
   launches counted, and ``matmul_tflops_steady(m=8192)`` against
   ``device_peak_tflops()``;
23. real-data speculative decoding: the reference bench's
   ``early_exit_real_data_tokens_per_sec(b=1, gamma=8, gen=256,
   train_steps=600)`` on the card's stdlib, its near-tie rule raising on
   any other divergence;
24. paged kernel per launch: B4's split and merge kernels timed apart
   under ``torch.profiler`` at phase 3's serving read. Every use of the
   profiler follows the wall-clock readings of its phase;
25. collectives: an NCCL group of one rank (the machine has one card),
   ``build_mesh`` and ``build_mesh_spmd`` over it (every axis 1), each
   collective's output its input, and the five collective benchmarks at
   their defaults (algorithm bandwidth positive, bus factor 0 at n = 1,
   the ppermute ring's data home), their RESULT lines printed;
26. the ring's hops at full width: every rank's hops of a causal ring,
   driven in this one process through the port's own ring loops
   (``ring_attention_all_ranks``: B1 each hop, B2 and B3 each hop of
   the backward against the merged lse), at q [8, 16, 2048, 128],
   k/v [8, 4, 2048, 128] over 4 ranks and at [1, 8, 16384, 128] with
   window 2048 over 8 (one windowed hop, row_offset 2048): the output
   and the gradients of (out ** 2).sum() row by row against the f32
   reference, the same ring through the plain versions of B1-B3 the
   allowance's plain version (the whole sequence's ``flash_attention``
   read beside it), a tile left out shown to break it; B1-B3's launches
   counted; one hop of each held alone and timed as in phase 4, and ms
   per hop by ``torch.profiler``;
27. the sharded step at world size 1: the training cell (dense,
   ``default_optimizer()``) and its MoE top-2 cell (Adafactor) through
   ``build_mesh_spmd``, ``param_shardings``, ``zero1_opt_shardings`` and
   ``make_ring_attention``, against ``make_train_step`` with
   ``flash_attention`` on the same weights: losses within 1e-5
   relative, params within one bf16 ulp after four steps, ms per step
   of both;
28. the GPipe train step at world size 1: ``make_pp_train_step`` over
   a pp axis of one rank on the training cell's widths with learned
   positions and no remat (``PP_FULL``: the reference's pipeline adds
   ``pos_embed`` and applies no RoPE), batch 8 x 2048, flash attention,
   against ``make_train_step`` on the same weights: with one microbatch
   losses within 1e-5 relative and params within one bf16 ulp after
   four steps, with four the losses within TOL_PP_MICRO_LOSS_REL and
   the params' update within TOL_PP_MICRO_UPDATE_REL of its size; ms per
   step, peak memory and B1-B3's launches (8 x microbatches a step);
29. int8 ``generate`` under the (dp, tp) mesh of one rank at the
   generation cell (batch 8, prompt 2048, 32 steps) against the
   unsharded int8 ``generate``: tokens equal, every step's
   teacher-forced logits bit-equal, B5's launches equal; device ms per
   decode step of both, timed in both orders;
30. the engine with kv-head-sharded pools and tp-sharded params at the
   serving cell against the solo engine: tokens identical, 570 B4
   launches each; device tokens/s;
31. the sharded seq2seq loss at the seq2seq cell bit-equal to the
   unsharded one; phase 27's dense state saved from the mesh and
   restored onto the mesh and onto the card alone (bit-equal, the
   resumed step bit-identical; GB and seconds); ``prefetch_to_device``
   with ``sharding``; ``dryrun_multichip(1)`` over NCCL;
32. head dim 256 (``HD256``: Gemma-2B's attention, 8 query heads over 1
   KV head of 256, at the training cell's widths): B1-B3's ``<256>``
   kernels over the mask forms in f32 and bf16 (and at head dims 160
   and 192), then at q [8, 8, 2048, 256], k/v [8, 1, 2048, 256] causal
   as in phase 4 (a tile left out shown to break the allowance); B5 (its
   FMA kernel) in bf16, int8 and f32 at cache [8, 1, 3200, 256], pos
   2048, and B4 at phase 3's serving lens with h_kv 1, hd 256, each
   against its plain version, timed with its bound and SDPA; d = 272
   refused with ``ValueError`` by all five wrappers; three HD256 train
   steps (48/24/24 B1-B3 launches, finite falling losses, the step split
   by kernel group); ``generate`` at b 8, prompt 2048, 32 new tokens by
   replays against the eager loop, B5 launches and device ms per step;
   the serving run of phase 7 on HD256 weights (its tokens, decode step
   against the CPU, chunk against the eager step), device tokens/s. The
   build phase asserts that the three ``<256>`` instantiations do not
   spill.

Phases 1-2 run in the script's own process, phases 3-20, 21-24, 25-27,
28-31 and 32 in five processes of the script that it starts one after
the other (see ``HALF``). It then prints one ``{"kernels": [...]}`` line, the card's
name and power limit and, last, the device line ``{"ok": true,
"device": {...}}``. Without a CUDA card it exits
non-zero and prints no result.

Run from the repo root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_driver_torch import entry
from tpu_dra_driver_torch.workloads import data
from tpu_dra_driver_torch.workloads.models import beam as bm
from tpu_dra_driver_torch.workloads.models import encoder as enc
from tpu_dra_driver_torch.workloads.models import lora
from tpu_dra_driver_torch.workloads.models import seq2seq as s2s
from tpu_dra_driver_torch.workloads.models import speculative as spec
from tpu_dra_driver_torch.workloads.models import transformer as tt
from tpu_dra_driver_torch.workloads.models.generate import (
    _step_body, block_prefill, chunked_prefill, decode_step,
    decode_tokens_per_sec, generate, init_kv_cache, local_params, wide_step,
)
from tpu_dra_driver_torch.workloads.models.quantize import quantize_params
from tpu_dra_driver_torch.workloads.models.serving import (
    ServingEngine, paged_decode_step, serving_throughput,
)
from tpu_dra_driver_torch.workloads.models.transformer import (
    ModelConfig, init_params,
)
from tpu_dra_driver_torch.workloads.ops import _build
from tpu_dra_driver_torch.workloads.ops import attention as fa
from tpu_dra_driver_torch.workloads.ops import collectives as co
from tpu_dra_driver_torch.workloads.ops import decode_attention as da
from tpu_dra_driver_torch.workloads.ops import paged_attention as pa
from tpu_dra_driver_torch.workloads.parallel import mesh as pm
from tpu_dra_driver_torch.workloads.parallel import pipeline as pp
from tpu_dra_driver_torch.workloads.parallel import ringattention as pr
from tpu_dra_driver_torch.workloads.utils import timing
from tpu_dra_driver_torch.workloads.utils.checkpoint import (
    abstract_like, on_one_device, restore_train_state, save_train_state,
)
from tpu_dra_driver_torch.workloads.utils.profiling import (
    annotate, latest_trace, trace_to,
)
from tpu_dra_driver_torch.workloads.utils.graphs import StepGraph

DEV = "cuda"
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# kernel vs plain tolerance in f32: summation order only, over at most
# 1024 terms; one token masked wrongly moves a row by ~1/len >= 1e-3.
# (bf16 results are held row by row against an f32 reference: below.)
TOL_F32 = 1e-5
# card vs CPU, fp32 engine: cuBLAS and the CPU BLAS sum in other orders
TOL_ENGINE_LOGITS = 1e-4
# card vs CPU, one full-width bf16 decode step from identical pools,
# relative to the largest logit: bf16 rounding (2^-8) through six layers
TOL_FULL_WIDTH_REL = 5e-2

FULL = ModelConfig(vocab=8192, d_model=1024, n_heads=8, n_kv_heads=4,
                   n_layers=6, d_ff=4096, max_seq=1664, use_rope=True)
FULL_PROMPT_LENS = (512, 256, 384, 256, 512, 384)
FULL_NEW_TOKENS = 96
FULL_ENGINE = dict(n_blocks=64, block_t=128, max_batch=8)
SMALL = ModelConfig(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                    n_layers=2, d_ff=128, max_seq=256, use_rope=True,
                    dtype=torch.float32)
SMALL_ENGINE = dict(n_blocks=24, block_t=8, max_batch=4,
                    max_blocks_per_seq=8)

KERNEL_SOURCES = ("paged_attention", "flash_attention", "decode_attention")

# bf16 against an f32 reference, row by row. Under a causal mask the
# outputs' scale falls off along the sequence (out[0] is v[0], dk and dv
# of the first columns sum over every row), so a bound relative to a
# tensor's largest value would pass a tile left out of a typical row.
# Each row (the last axis) of the kernel's output is instead held
# against the same row of an f32 reference computed from the same bf16
# inputs: its largest error may be TOL_BF16_VS_PLAIN times that of the
# bf16 plain version (or of the block on the CPU) in the same row, which
# is what rounding to bf16 costs there (rows whose value cancels, as dq
# of the first rows, cost more), plus TOL_BF16_ROW_ATOL (one bf16 ulp)
# of the row's largest reference value (at least 1e-3 of the tensor's).
TOL_BF16_VS_PLAIN = 2.0
TOL_BF16_ROW_ATOL = 2.0 ** -8
# the 64 x 64 tiles (first q row, first KV column) whose omission the
# full-width bf16 allowance must see in every output: the diagonal tile of
# the middle rows, and a tile of the middle columns seen from the last
# rows
FLASH_MUTANT_TILES = ((1024, 1024), (1984, 1024))
FLASH_MUTANT_TILE = 64
# flash-decode (B5) at the full-width generation read: (b, h, h_kv, L,
# hd), the cache round_up_kv(2048 + 1056) slots long; bf16 and int8 at
# these positions, f32 at the first, a middle and the last slot
DECODE_FULL = (8, 16, 4, 3200, 128)
DECODE_BF16_POS = (2048, 3103)
DECODE_INT8_POS = (2048,)
DECODE_F32_POS = (0, 1600, 3199)
# a ring of 256 slots read at position 1000 (wrapped: every slot visible)
DECODE_RING = (256, 1000)
# one KV head for the 16 query heads (MQA), bf16, at DECODE_BF16_POS[0]
DECODE_MQA = (8, 16, 1, 3200, 128)
# B5 captured once in a CUDA graph with its position on the device, then
# replayed at these positions (the first slot, a tile less one and a
# tile, the full-width read, the last slot)
DECODE_GRAPH_POS = (0, 63, 64, 2048, 3199)
# slots past these positions (and their scales) are filled with NaN: the
# output must not move (inside the first tile, the full-width read, two
# slots into a tile)
DECODE_NAN_POS = (63, 2048, 2050)
# the sub-tile (slots) whose omission from the middle of the live range
# the bf16 and int8 allowances must see in every row
DECODE_MUTANT_TILE = 64
# paged decode (B4) at the full-width serving read: a length-0 row, rows
# ending on a block edge (512, 1024), a 1-token row
PAGED_LENS = (0, 512, 1024, 1, 700, 129, 383, 960)
# ... at the edges of its split into chunks of 64 tokens (f32; bf16 runs
# chunks of 32: 65 and 193 end one token into one of those too) (rows
# ending one token into a chunk, rows of exactly one chunk or of whole
# chunks), with
# 128-token blocks (two chunks to a block) and with 16-token blocks (four
# blocks to a chunk): name -> (block_t, lens); the walk covers the
# longest row's blocks rounded up to a power of two, as the engine's
PAGED_EDGE_CASES = {
    "chunk_edges": (128, (65, 64, 0, 1, 128, 193, 575, 640)),
    "block_t_16": (16, (65, 64, 17, 0, 1, 16, 300, 513)),
}
# ... and at the edges of the tensor-core kernel's chunks of 32 tokens
# (h_kv 1, hd 256, bf16), with 8-token blocks (four to a chunk, so four
# bulk copies of K and of V)
PAGED_EDGE_CASES_HD256 = {
    "chunk_edges_32": (128, (33, 32, 0, 1, 31, 97, 575, 640)),
    "block_t_8": (8, (33, 32, 9, 0, 1, 8, 300, 513)),
}
# the sub-tile (slots) whose omission from the middle of the longest row
# the bf16 allowance must see in each of its query heads
PAGED_MUTANT_TILE = 64
# lse is f32 on both sides: summation order only
TOL_FLASH_LSE = 1e-4
# f32 mask cases: summation order only, relative to max(1, largest value)
TOL_FLASH_F32 = 1e-5
# (b, h, h_kv, t, d) of one attention call of the training configuration
FLASH_FULL = (8, 16, 4, 2048, 128)
# name -> ((b, h, h_kv, t, tkv, d), mask keywords), f32
FLASH_CASES = {
    "causal": ((2, 4, 2, 256, 256, 64), {}),
    "causal_gqa_4to1": ((1, 8, 2, 256, 256, 32), {}),
    "window": ((1, 4, 2, 256, 256, 64), dict(window=48)),
    "window_row_offset_empty_rows": ((1, 2, 1, 128, 128, 64),
                                     dict(window=32, row_offset=64)),
    "prefix": ((1, 4, 2, 256, 256, 32), dict(prefix=100)),
    "noncausal_tkv_ne_t": ((1, 4, 2, 128, 320, 32), dict(causal=False)),
    "causal_ragged_tiles": ((1, 2, 1, 80, 80, 128), {}),
}
# the same mask forms in bf16, the dtype of the training path (its B1 and
# B3 are the wgmma kernels; f32 runs 32-row FMA kernels), plus ragged
# tiles at t = 192, a chunk with t != tkv, and head dims 16, 96 whose
# columns past d the kernels zero-fill: each output row held against an
# f32 reference like the full-width check below
FLASH_BF16_CASES = {
    "causal_d64": ((2, 4, 2, 256, 256, 64), {}),
    "causal_gqa_4to1_d32": ((1, 8, 2, 256, 256, 32), {}),
    "window": ((1, 4, 2, 256, 256, 64), dict(window=48)),
    "window_row_offset_empty_rows": ((1, 2, 1, 128, 128, 64),
                                     dict(window=32, row_offset=64)),
    "row_offset_tkv_ne_t": ((1, 4, 2, 128, 256, 128), dict(row_offset=128)),
    "prefix": ((1, 4, 2, 256, 256, 32), dict(prefix=100)),
    "noncausal_tkv_ne_t": ((1, 4, 2, 128, 320, 32), dict(causal=False)),
    "causal_ragged_80": ((1, 2, 1, 80, 80, 128), {}),
    "causal_ragged_192": ((1, 4, 1, 192, 192, 128), {}),
    "causal_d16": ((1, 2, 2, 128, 128, 16), {}),
    "causal_d96": ((1, 4, 2, 256, 256, 96), {}),
    "row_offset_ragged_tkv": ((1, 4, 2, 96, 200, 64), dict(row_offset=104)),
}

# B1's persistent schedule (one CTA per SM walking the work items, a
# 128-row q tile of one head each): fewer items than SMs, many more with
# ragged t and tkv, and whole items whose rows see no column (t > tkv
# under a window and row_offset); name -> (shape, mask, the 64 x 64 tiles
# (first q row, first KV column) whose omission the allowance must see)
FLASH_SCHEDULE_CASES = {
    "one_item_t64": ((1, 1, 1, 64, 64, 128), {}, ((0, 0),)),
    "ragged_many_items": ((2, 32, 8, 1000, 1100, 128), dict(row_offset=100),
                          ((896, 960), (512, 256))),
    "empty_items": ((2, 16, 4, 640, 512, 128),
                    dict(window=32, row_offset=64), ((384, 416),)),
}

# B2's persistent schedule (as B1's) and B3's walk over the GQA group,
# each instantiation: fewer items than SMs, ragged t and tkv with many
# items, rows that see no column (whose dq must be 0), and groups of 8
# query heads a KV head (the HD256 cell's), at head dims 64 and 256 (B2
# stages its epilogue in dO there; B3's warpgroups trade P^T and dS^T);
# name -> (shape, mask, tiles left out), as FLASH_SCHEDULE_CASES
FLASH_BWD_SCHEDULE_CASES = {
    "one_item_t64_d256": ((1, 1, 1, 64, 64, 256), {}, ((0, 0),)),
    "ragged_many_items_d64": ((2, 32, 8, 1000, 1100, 64),
                              dict(row_offset=100), ((512, 256),)),
    "ragged_many_items_d256": ((2, 8, 1, 1000, 1100, 256),
                               dict(row_offset=100), ((896, 960),)),
    "empty_items_d256": ((2, 8, 1, 640, 512, 256),
                         dict(window=32, row_offset=64), ((384, 416),)),
    "gqa_group_8": ((2, 16, 2, 384, 384, 128), {}, ((320, 256),)),
    "gqa_group_8_d256": ((1, 8, 1, 384, 384, 256), {}, ((320, 256),)),
}

# training, card vs CPU in fp32: losses to cuBLAS-vs-CPU summation
# order; params after three AdamW steps to 1% of one step's largest
# move for all but 1% of elements, the rest within the largest move of
# three steps (Adam divides each gradient by its own RMS, so elements
# whose gradient is near zero move by up to lr either way)
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_PARAM = 3e-6
SMALL_TRAIN = ModelConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=256, max_seq=128, use_rope=True,
                          dtype=torch.float32)
SMALL_TRAIN_BATCH = (4, 128)
# the flagship training configuration (the default of the reference's
# train_tokens_per_sec), one step of batch 8 x 2048
FULL_TRAIN = ModelConfig(vocab=8192, d_model=2048, n_heads=16, n_kv_heads=4,
                         n_layers=8, d_ff=8192, max_seq=2048, use_rope=True,
                         remat=True, remat_policy="dots", scan_layers=True,
                         scan_unroll=8)
FULL_TRAIN_BATCH = (8, 2048)
TIMED_STEPS = 3
# generation, card against CPU in fp32: name -> (config, prompt length,
# steps, generate keywords); the ring of 128 slots wraps during prefill
# and decode, and every read but chunked prefill's goes through B5
SMALL_GEN = {
    "full_length": (SMALL, 16, 24, {}),
    "kv_int8": (replace(SMALL, kv_int8=True), 16, 24, {}),
    "ring_window_128": (replace(SMALL, window=128), 16, 140, {}),
    "prefill_chunk": (SMALL, 16, 24, {"prefill_chunk": 4}),
}
# serving_throughput in bf16: where the engine's tokens and generate()'s
# part, both tokens must be within this share of the largest |logit| of
# the f32 top logit at that position (the two paths' bf16 kernels and
# matrix shapes round differently, so a near-tie may break either way;
# the card's bf16 decode logits differ from the CPU's by about 1% of
# that scale in phase 7)
TOL_TIE_REL = 2.0 ** -4
# the full-width decode benchmark of the reference (bench.py:2214-2218)
GEN_FULL = ModelConfig(vocab=8192, d_model=2048, n_heads=16, n_kv_heads=4,
                       n_layers=8, d_ff=8192, max_seq=2048 + 1056,
                       use_rope=True)
GEN_FULL_RUN = dict(b=8, prompt_len=2048, gen_short=32, gen_long=1056,
                    iters=3)
# bf16 decode steps run once more under torch.profiler, eagerly and as
# replays of the captured step
PROFILED_DECODE_STEPS = 32
# the replayed steps' device-busy time over the eager steps': the same
# kernels on the same data, plus the step's position and token kernels
# (1.5-2% more); the long chain's rate also carries its prefill and reads
# up to 1055 more slots (10-11% more so far); a graph whose kernels the
# profiler missed would read near 0
DEVICE_STEP_RATIO = (0.9, 1.15)
# full-width bf16 generation by the eager decode loop, before the decode
# graphs (PERF.md section 5, H100 80GB HBM3 at 700 W): wall ms per step,
# device ms per step, idle share
EAGER_LOOP = "8.5-14.0 ms/step wall, 1.434-1.436 ms/step device, 83-90% idle"
# decode steps of the engine replayed against the eager step
ENGINE_GRAPH_STEPS = 8
# the replayed long chain is held against the eager loop over all its
# steps in bf16, and over its first EAGER_CHECK_STEPS steps for the int8
# variants and MoE generation: each eager step is issued from the host
# (12-19 ms), and the cut keeps the whole script within its time with
# phase 32 added
EAGER_CHECK_STEPS = 256
# name -> (kv_int8, int8 weights)
GEN_FULL_VARIANTS = {"bf16": (False, False),
                     "int8 weights + int8 KV": (True, True),
                     "int8 weights": (False, True)}
# random N(0, 0.02) weights, tied head: logits of variance ~ d * 0.02^2,
# so the first loss is about ln(8192) + 0.4 = 9.4
FIRST_LOSS_RANGE = (8.5, 10.5)
# MoE, Adafactor, LoRA and MLM on the card against the CPU in fp32: the
# small training configuration with four experts, two a token (its
# widths, 128 and 256, make Adafactor factor the projections and the
# expert banks), and the engine's configuration with the same routing
SMALL_MOE = replace(SMALL_TRAIN, n_experts=4, moe_top_k=2)
SMALL_MOE_GEN = replace(SMALL, n_experts=4, moe_top_k=2)
SMALL_LORA_RANK = 4
# card vs CPU gradients in fp32, relative to each leaf's largest: cuBLAS,
# the f32 flash kernels and the CPU's plain versions sum in other orders
TOL_GRAD_REL = 1e-4
# the full-width MoE configurations: the training and generation cells'
# widths with Mixtral 8x7B's routing, 8 experts and 2 a token (Jiang et
# al. 2024, arXiv:2401.04088), capacity factor 1.25 (C = 640 a row at
# t = 2048)
FULL_MOE_TRAIN = replace(FULL_TRAIN, n_experts=8, moe_top_k=2,
                         moe_capacity_factor=1.25)
FULL_MOE_GEN = replace(GEN_FULL, n_experts=8, moe_top_k=2,
                       moe_capacity_factor=1.25)
# LoRA at full width: rank 16 on the attention projections
LORA_RANK = 16
# seq2seq, beam search and speculative decoding on the card against the
# CPU in fp32, at the CPU tests' sizes: a source of 8 tokens against
# max_src 12 (bidirectional throughout), head dim 16
SMALL_S2S = s2s.Seq2SeqConfig(vocab=16, d_model=64, n_heads=4, n_kv_heads=2,
                              n_enc_layers=2, n_dec_layers=2, d_ff=128,
                              max_src=12, max_tgt=12, dtype=torch.float32)
SMALL_S2S_BATCH = (16, 8)
SMALL_BEAM = ModelConfig(vocab=128, d_model=64, n_heads=2, n_kv_heads=1,
                         n_layers=2, d_ff=128, max_seq=64, use_rope=True,
                         dtype=torch.float32)
SMALL_BEAM_STEPS = 10
SMALL_SPEC_TARGET = ModelConfig(vocab=256, d_model=128, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=256,
                                max_seq=128, use_rope=True,
                                dtype=torch.float32)
SMALL_SPEC_DRAFT = ModelConfig(vocab=256, d_model=64, n_heads=2, n_layers=1,
                               d_ff=128, max_seq=128, use_rope=True,
                               dtype=torch.float32)
# beam scores in fp32, card against CPU (summation order through ten
# log-softmaxes), and against the card's own teacher-forced re-scoring
# (another path to the same logits: the block forward and the oracle
# attention against the decode step and B5)
TOL_BEAM_SCORE_REL = 1e-5
TOL_BEAM_RESCORE_REL = 1e-4
# the full-width seq2seq configuration: both stacks at the training
# configuration's widths and depth; batch 8 x (2048 source, 512 target)
FULL_S2S = s2s.Seq2SeqConfig(vocab=8192, d_model=2048, n_heads=16,
                             n_kv_heads=4, n_enc_layers=8, n_dec_layers=8,
                             d_ff=8192, max_src=2048, max_tgt=512)
FULL_S2S_BATCH = (8, 2048, 512)
S2S_DECODE_STEPS = 64
# (b, h, h_kv, t, tkv, d) of one cross-attention call of that
# configuration, no mask, and the 64 x 64 tiles (first q row, first KV
# column) whose omission its bf16 allowance must see
FLASH_CROSS = (8, 16, 4, 512, 2048, 128)
FLASH_CROSS_TILES = ((256, 1024), (448, 1984))
# ... and of its decoder's causal self-attention (t = 512), with the
# diagonal tile of the middle rows and a middle tile seen from the last
# rows
FLASH_DEC_CAUSAL = (8, 16, 4, 512, 512, 128)
FLASH_DEC_CAUSAL_TILES = ((256, 256), (448, 256))
# full-width beam search on the generation configuration: T5's published
# summarization beam width (4); 32 cache rows of 2176 slots
BEAM_FULL = dict(b=8, prompt_len=2048, beam=4, steps=128)
BEAM_SHORT_STEPS = 32
# bf16 beam score against the bf16 teacher-forced re-scoring, relative to
# the score: bf16's unit roundoff, as each token's log-probability
# carries about that share of itself in either path; a step that gathers
# wrong cache rows moves the following tokens' log-probabilities by whole
# nats
TOL_BEAM_BF16_REL = 2.0 ** -8
BEAM_KERNEL_GROUPS = (
    ("flash decode (B5)", ("flash_decode_split", "flash_decode_merge")),
    # index_select's row gathers (the reorder's 16 a step; the embedding
    # lookup's one is 32 rows of 4 KB)
    ("cache reorder (row gathers)", ("indexselect", "vectorized_gather")),
    ("top-k (sort)", ("sort",)),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)
# B5 at the beam's read (32 rows of 2176 slots, bf16), at its first and
# last replayed step's positions
DECODE_BEAM = (32, 16, 4, 2176, 128)
DECODE_BEAM_POS = (2048, 2174)
# ... and at the speculative drafts' reads (b = 1): cache length -> bf16
# positions across the run; 512 slots for the int8 self-draft bench's 128
# + 256 + 8 + 2 tokens, 384 for the early exit's 64 + 256 + 8 + 2; f32
# (the f32 speculative_sample) at one position of the longer cache
DECODE_SPEC = {512: (128, 257, 393), 384: (200, 329)}
DECODE_SPEC_F32 = (512, 300)
# the reference bench's speculative calls (bench.py:2346, :2371), and the
# speculative calls each makes: one for its stats, one warm-up and three
# timed
SPEC_FULL = dict(b=1, gamma=8, gen=256)
SPEC_BENCH_CALLS = 5
# prefetch_to_device on the card: host batches of f32 integers (exact
# sums), and the matrix products of 4096^2 the consumer runs on its
# stream before it reads each batch (a read that a later copy could
# overtake if the batch's memory were handed back too early)
PREFETCH_BATCHES = 48
PREFETCH_SHAPE = (1024, 2048)
PREFETCH_SLOW_PRODUCTS = 8
# the long-context flash benchmarks' shape (bench.py:2177-2200, the
# reference's defaults): b 1, h 8 (MHA), t 16384, window 2048, d 128
FLASH_LONG = (1, 8, 8, 16384, 16384, 128)
FLASH_LONG_WINDOW = 2048
# B1 held against the f32 oracle in blocks of rows at the start, the
# middle and the end of the sequence
FLASH_LONG_BLOCK = 1024
FLASH_LONG_BLOCKS = (0, 7680, 15360)
# ... and every output of B1-B3 at the whole shape (the gradients' plain
# versions and f32 reference fit the card at t 16384: 44.8 GiB at the
# peak), with these 64 x 64 tiles of the band left out: the middle rows
# 1024 columns back, the last rows 1984 back
FLASH_LONG_TILES = ((8192, 7168), (16320, 14336))
# the flash benchmarks' causal shape (flash_attention_tflops and
# flash_attention_train_tflops defaults): b 4, h 8 (MHA), t 2048, d 128
FLASH_MHA = (4, 8, 8, 2048, 2048, 128)
# the reference bench's runs of the long-context benchmarks (bench.py:45)
LONG_CTX_RUNS = 3
MATMUL_M = 8192
# the ring's hops at full width, every rank's driven in one process:
# name -> ((b, h, h_kv, t, d), ranks, window); causal, bf16. The training
# shape over 4 ranks (t_local 512), and the long-context cell over 8
# (t_local 2048: one windowed hop, row_offset 2048)
RING_SHAPES = {"train": ((8, 16, 4, 2048, 128), 4, None),
               "long": ((1, 8, 8, 16384, 128), 8, 2048)}
# the 64 x 64 tiles left out of the whole sequence (inside its mask)
RING_TILES = {"train": FLASH_MUTANT_TILES, "long": FLASH_LONG_TILES}
# one hop of each ring held alone and timed (the kernels' ring rows):
# the training ring's chunk from the past (no mask) and the long ring's
# windowed hop; the tiles lie inside the hop's mask
RING_HOP_CASES = {
    "train": ((8, 16, 4, 512, 512, 128), {"causal": False},
              ((256, 0), (448, 448))),
    "long": ((1, 8, 8, 2048, 2048, 128),
             {"causal": True, "window": 2048, "row_offset": 2048},
             ((0, 1024), (960, 1984))),
}
# the sharded step on one rank against make_train_step: the same
# operations, so the losses agree to f32 rounding
TOL_SHARDED_LOSS_REL = 1e-5
# the reference bench's real-data early-exit call (bench.py:2433)
REAL_DATA_BENCH = dict(b=1, gamma=8, gen=256, train_steps=600)
# profiler ranges the MoE step's split attributes kernels by
MOE_RANGE, BLOCK_RANGE, OPT_RANGE = "smoke:moe", "smoke:block", "smoke:opt"
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "wgmma")


_T0 = time.perf_counter()


def phase(name: str) -> None:
    """Announces a phase, with the seconds since this process started."""
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


@contextlib.contextmanager
def no_device_waits():
    """Inside, any call that makes the host wait for the card (a
    synchronize, a copy to the host, a blocking copy from it) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def time_ms(fn, iters: int = 50,
            flush: Optional[torch.Tensor] = None) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around each
    call, after warm-up; ``flush`` is overwritten before each call so
    the call finds the L2 cache cold, as the engine's calls do."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def paged_inputs(dtype, gen, block_t=128, lens=PAGED_LENS, n_live=8,
                 h_kv=4, hd=128):
    """b=8, h=8 decode reads through a block table: by default the
    full-width serving shapes (h_kv 4, hd 128, block_t 128, 64 pool
    blocks, 32 table columns of which 8 are walked). Each row's live
    blocks sit at shuffled physical ids; table entries past a row's live
    range are not valid block ids."""
    b, h = 8, 8
    need = sum(-(-n // block_t) for n in lens) + 1
    n_blocks = max(64, need)
    max_blocks = max(32, n_live + 2)
    dev = DEV
    pool_k = torch.randn((n_blocks, h_kv, block_t, hd), generator=gen)
    pool_v = torch.randn((n_blocks, h_kv, block_t, hd), generator=gen)
    q = torch.randn((b, h, 1, hd), generator=gen)
    phys = (torch.randperm(n_blocks - 1, generator=gen) + 1).tolist()
    table = torch.full((b, max_blocks), -7, dtype=torch.int32)
    for i, n in enumerate(lens):
        live = -(-n // block_t)
        table[i, :live] = torch.tensor(phys[:live], dtype=torch.int32)
        phys = phys[live:]
        table[i, live:] = 1_000_000 + i
    return (q.to(dev, dtype), pool_k.to(dev, dtype), pool_v.to(dev, dtype),
            table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev),
            n_live)


def _paged_row_f32(q, pk, pv, table, lens, i, drop=None):
    """Row ``i`` of the paged read in f32, straight from its blocks, with
    the slots ``drop`` left out: [h, hd]."""
    h, hd = q.shape[1], q.shape[3]
    h_kv, block_t = pk.shape[1], pk.shape[2]
    n = int(lens[i])
    blocks = table[i, :-(-n // block_t)].long()

    def slots(pool):
        x = pool[blocks].float().transpose(0, 1).reshape(h_kv, -1, hd)
        keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
        keep[n:] = False
        if drop is not None:
            keep[drop] = False
        return x[:, keep]

    k, v = slots(pk), slots(pv)
    qg = q[i, :, 0].float().reshape(h_kv, h // h_kv, hd)
    p = torch.softmax(torch.einsum("krd,ktd->krt", qg, k) / math.sqrt(hd),
                      dim=-1)
    return torch.einsum("krt,ktd->krd", p, v).reshape(h, hd)


def _paged_check(label, inputs, mutant=False) -> float:
    """B4 against its plain version on ``inputs``, returning the largest
    |kernel - plain|: the launch without a host wait; length-0 rows
    exactly 0; f32 within TOL_F32; bf16
    row by row against an f32 reference within the allowance and, with
    ``mutant``, a 64-slot sub-tile of the middle of the longest row shown
    to break that allowance in each of the row's query heads."""
    q, pk, pv, table, lens, n_live = inputs
    with no_device_waits():         # the split is sized from host integers
        got = pa.paged_decode_attention(q, pk, pv, table, lens, n_live)
    plain = pa.paged_decode_attention_plain(q, pk, pv, table, lens, n_live)
    torch.cuda.synchronize()
    err = (got.float() - plain.float()).abs().max().item()
    empty = lens == 0
    zero_rows = got[empty].abs().max().item() if empty.any() else 0.0
    if zero_rows != 0.0:
        raise AssertionError(f"B4 {label}: a length-0 row is not 0")
    if q.dtype == torch.float32:
        print(f"  {label} f32: max |kernel - plain| {err:.3e} (tolerance "
              f"{TOL_F32:.0e}); length-0 rows 0")
        if not err <= TOL_F32:
            raise AssertionError(f"B4 disagrees with its plain version in "
                                 f"f32, {label}: {err} > {TOL_F32}")
        return err
    ref = pa.paged_decode_attention_plain(q.float(), pk.float(), pv.float(),
                                          table, lens, n_live)
    reading = _bf16_reading(got, plain, ref)
    note = ""
    if mutant:
        i = int(lens.argmax().item())
        n = int(lens[i])
        t0 = (n // 2) // PAGED_MUTANT_TILE * PAGED_MUTANT_TILE
        cut = slice(t0, t0 + PAGED_MUTANT_TILE)
        without = _paged_row_f32(q, pk, pv, table, lens, i, cut)
        seen = (_row_err(without, ref[i, :, 0])
                / _allowance(plain, ref)[i, :, 0])
        note = (f"; row {i} (len {n}) without slots {cut.start}-"
                f"{cut.stop - 1}: least {seen.min().item():.1f}, median "
                f"{seen.median().item():.1f} times the allowance")
        if not seen.min().item() > 1.0:
            raise AssertionError(f"the B4 allowance would not see a sub-tile "
                                 f"left out: {seen.min().item()}")
    print(f"  {label} bf16: max |kernel - plain| {err:.3e}; worst row vs f32 "
          f"{reading['kernel']:.3e} (plain {reading['plain']:.3e}); over "
          f"allowance {reading['over']:.3f}{note}")
    if not reading["over"] <= 1.0:
        raise AssertionError(f"B4 disagrees in bf16, {label}: "
                             f"{reading['over']} of its allowance")
    return err


def paged_launch_phase(gen) -> dict:
    """B4's two launches (split and merge) timed apart at phase 3's
    serving read by ``_paged_profile``. It runs last, after every
    wall-clock reading, as the parent's script first runs the profiler
    only after its serving phase."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    found = _paged_profile(gen, flush)["B4"]
    if len(found) != 2:
        raise AssertionError(f"the profiler saw B4's launches as {found}")
    return found


def kernel_phase(gen) -> dict:
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        result[str(dtype)] = _paged_check(
            "serving shapes", paged_inputs(dtype, gen),
            mutant=dtype == torch.bfloat16)
        for name, (block_t, lens) in PAGED_EDGE_CASES.items():
            n_live = 1 << (-(-max(lens) // block_t) - 1).bit_length()
            inputs = paged_inputs(dtype, gen, block_t, lens, n_live)
            err = _paged_check(f"{name} (block_t {block_t}, lens {lens}, "
                               f"{n_live} blocks walked)", inputs)
            result[str(dtype)] = max(result[str(dtype)], err)
    return {"max_abs_err": result[str(torch.bfloat16)],
            "max_abs_err_f32": result[str(torch.float32)],
            **_paged_readings(gen, flush)}


def _paged_readings(gen, flush, **shape) -> dict:
    """B4 timed at the serving dtype and shapes (``shape``: the KV heads
    and head dim of ``paged_inputs``) with a cold L2, against its plain
    version, SDPA over the gathered caches and its bound."""
    q, pk, pv, table, lens, n_live = paged_inputs(torch.bfloat16, gen,
                                                  **shape)
    b, h, _, hd = q.shape
    h_kv, block_t = pk.shape[1], pk.shape[2]
    got = pa.paged_decode_attention(q, pk, pv, table, lens, n_live)
    ms = time_ms(lambda: pa.paged_decode_attention(q, pk, pv, table, lens,
                                                   n_live), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
        q, pk, pv, table, lens, n_live), iters=20, flush=flush)
    # yardstick only (the port never calls it): SDPA over the gathered
    # caches of the rows with len >= 1
    keep, sdpa_args = _paged_sdpa_args(q, pk, pv, table, lens, n_live)
    lib_out = F.scaled_dot_product_attention(*sdpa_args)
    lib_err = (lib_out.float() - got[keep].float()).abs().max().item()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(*sdpa_args),
                         flush=flush)
    # bound: each input read once, each output written once; live K/V only
    lens_l = lens.long()
    n_slots = n_live * block_t
    live_tokens = lens_l.clamp_max(n_slots).sum().item()
    live_blocks = (-(-lens_l.clamp_max(n_slots) // block_t)).sum().item()
    esize = q.element_size()
    n_bytes = (2 * live_tokens * h_kv * hd * esize       # K and V
               + 2 * b * h * hd * esize                  # q and out
               + b * 4 + live_blocks * 4)                # lens, table
    n_flops = 4 * h * hd * live_tokens                   # QK and PV
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"bf16 kernel {ms:.4f} ms (both launches, "
          f"{pa._n_split(n_live, block_t, pa._chunk(q.dtype))} CTAs "
          f"per (sequence, KV head); "
          f"each launch is timed at the end), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms (max |SDPA - "
          f"kernel| {lib_err:.2e}); bound {bound_ms:.4f} ms ({n_bytes} "
          f"bytes, {n_flops} flops); kernel at {100 * bound_ms / ms:.1f}% "
          f"of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _paged_sdpa_args(q, pk, pv, table, lens, n_live):
    """(the rows with len >= 1, SDPA's arguments over their gathered
    caches, the GQA group repeated and the slots past len masked)."""
    b, h, _, hd = q.shape
    h_kv, block_t = pk.shape[1], pk.shape[2]
    lens_l = lens.long()
    keep = (lens_l > 0).nonzero().flatten()
    n_slots = n_live * block_t
    cols = torch.minimum(torch.arange(n_live, device=DEV),
                         ((lens_l - 1).clamp_min(0) // block_t)[:, None])
    blocks = table.long().gather(1, cols)[keep]

    def gathered(pool):
        g = pool[blocks].transpose(1, 2).reshape(len(keep), h_kv, n_slots, hd)
        return g.repeat_interleave(h // h_kv, dim=1)

    mask = (torch.arange(n_slots, device=DEV)[None, :]
            < lens_l[keep][:, None])[:, None, None, :]
    return keep, (q[keep], gathered(pk), gathered(pv), mask)


def _paged_profile(gen, flush, iters: int = 20, **shape) -> dict:
    """B4 at ``paged_inputs(bf16, **shape)`` and SDPA over the gathered
    caches on one clock: mean device ms per launch of each kernel in one
    ``torch.profiler`` session, each call after a flush of the L2.
    Returns {"B4": {kernel name: ms}, "SDPA": {kernel name: ms}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, pk, pv, table, lens, n_live = paged_inputs(torch.bfloat16, gen,
                                                  **shape)
    _, sdpa_args = _paged_sdpa_args(q, pk, pv, table, lens, n_live)
    calls = (lambda: pa.paged_decode_attention(q, pk, pv, table, lens,
                                               n_live),
             lambda: F.scaled_dot_product_attention(*sdpa_args))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in calls:
                flush.zero_()
                fn()
        torch.cuda.synchronize()
    found = {"B4": {}, "SDPA": {}}
    for e in prof.key_averages():
        low = e.key.lower()
        if e.device_type != DeviceType.CUDA or not e.count \
                or "zero" in low or "fill" in low:
            continue
        mean = e.self_device_time_total / 1e3 / e.count
        found["B4" if "paged_decode" in low else "SDPA"][e.key] = mean
    where = "".join(f", {k} {v}" for k, v in sorted(shape.items()))
    for key, kernels in found.items():
        print(f"{key} at phase 3's lens{where} by the profiler: "
              f"{sum(kernels.values()):.4f} ms = "
              + " + ".join(f"{name[:90]} {ms:.4f}"
                           for name, ms in kernels.items()))
    return found


def small_engine_phase() -> None:
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, SMALL.vocab, 6)]
               for _ in range(16)]
    engines = {dev: ServingEngine(init_params(SMALL, 0, device=dev), SMALL,
                                  device=dev, **SMALL_ENGINE)
               for dev in (DEV, "cpu")}
    logits, firsts = {}, {}
    for dev, eng in engines.items():
        for p in prompts[:4]:
            eng.add(p, 8)
        firsts[dev] = [r.pending for r in eng.rows]
        tokens = torch.tensor(firsts[dev], dtype=torch.int32)
        out, _, _ = paged_decode_step(
            eng.params, SMALL, [p.clone() for p in eng.pool_ks],
            [p.clone() for p in eng.pool_vs], eng._to_device(eng.tables),
            eng._to_device(eng.lens), tokens.to(dev),
            n_live_blocks=eng._live_blocks_bucket(1))
        logits[dev] = out.float().cpu()
    diff = (logits[DEV] - logits["cpu"]).abs().max().item()
    print(f"prefill first tokens equal: {firsts[DEV] == firsts['cpu']}; "
          f"decode-step logits max |card - cpu| {diff:.3e} "
          f"(tolerance {TOL_ENGINE_LOGITS:.0e})")
    if firsts[DEV] != firsts["cpu"] or not diff <= TOL_ENGINE_LOGITS:
        raise AssertionError("card and CPU engines disagree")
    outs = {dev: ServingEngine(init_params(SMALL, 0, device=dev), SMALL,
                               device=dev, **SMALL_ENGINE).run(prompts, 8)
            for dev in (DEV, "cpu")}
    print(f"16 requests x 8 tokens, card tokens == cpu tokens: "
          f"{outs[DEV] == outs['cpu']}")
    if outs[DEV] != outs["cpu"]:
        raise AssertionError(f"card and CPU tokens differ: {outs}")


def full_width_phase(card: str, cfg: ModelConfig = FULL) -> dict:
    """The serving cell's run through ``ServingEngine`` (by default at the
    serving configuration ``FULL``; phase 32 passes ``HD256_GEN``): B4's
    launches, its tokens against the warm-up run's, one decode step
    against the CPU and the replayed chunk against the eager step."""
    t0 = time.perf_counter()
    params = init_params(cfg, 3, device=DEV)
    n_params = tt.param_count(params)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab, n)]
               for n in FULL_PROMPT_LENS]
    print(f"{n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    warm = ServingEngine(params, cfg, device=DEV, **FULL_ENGINE).run(
        prompts, FULL_NEW_TOKENS)           # first-call set-up, untimed
    eng = ServingEngine(params, cfg, device=DEV, **FULL_ENGINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_decode_attention.launches = 0
    StepGraph.captures, StepGraph.capture_seconds = 0, 0.0
    t0 = time.perf_counter()
    got = eng.run(prompts, FULL_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    captures, capture_s = StepGraph.captures, StepGraph.capture_seconds
    peak = torch.cuda.max_memory_allocated()
    outs = [got[rid] for rid in sorted(got)]
    n_tok = sum(len(o) for o in outs)
    print(f"{card}: {n_tok} tokens in {wall:.3f} s wall = "
          f"{n_tok / wall:.1f} tok/s (prefill included), the decode steps "
          f"replayed from {captures} CUDA graph(s) captured in "
          f"{1e3 * capture_s:.1f} ms, {n_tok / (wall - capture_s):.1f} "
          f"tok/s without the capture; peak memory {peak / 2**20:.1f} MiB; "
          f"paged kernel launches {launches}, counted per replay; same "
          f"tokens as the warm-up run: {got == warm}")
    expect = (FULL_NEW_TOKENS - 1) * cfg.n_layers
    if len(outs) != len(prompts) or any(
            len(o) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab
                                                 for t in o) for o in outs):
        raise AssertionError("full-width run produced malformed outputs")
    if got != warm or captures < 1:
        raise AssertionError("full-width run: tokens differ from the "
                             "warm-up run's, or no graph was captured")
    if launches != expect:
        raise AssertionError(f"paged kernel launched {launches} times, "
                             f"expected {expect}")

    # one decode step on the card against the same step on the CPU from
    # identical pools (the CPU takes the kernel's plain version)
    eng = ServingEngine(params, cfg, device=DEV, **FULL_ENGINE)
    for p in prompts:
        eng.add(p, FULL_NEW_TOKENS)
    tokens = np.zeros((FULL_ENGINE["max_batch"],), np.int32)
    for r in eng.rows:
        if r is not None:
            tokens[r.row] = r.pending
    args = (eng.pool_ks, eng.pool_vs, torch.from_numpy(eng.tables),
            torch.from_numpy(eng.lens), torch.from_numpy(tokens))
    n_live = eng._live_blocks_bucket(1)
    card_logits, _, _ = paged_decode_step(
        params, cfg, [p.clone() for p in args[0]],
        [p.clone() for p in args[1]], *(a.to(DEV) for a in args[2:]),
        n_live_blocks=n_live)
    cpu_params = _on(params, "cpu")
    cpu_logits, _, _ = paged_decode_step(
        cpu_params, cfg, [p.cpu() for p in args[0]],
        [p.cpu() for p in args[1]], *args[2:], n_live_blocks=n_live)
    active = [r.row for r in eng.rows if r is not None]
    a, c = card_logits.float().cpu()[active], cpu_logits.float()[active]
    rel = ((a - c).abs().max() / c.abs().max()).item()
    finite = bool(torch.isfinite(a).all())
    print(f"full-width decode step: logits finite {finite}, max |card - "
          f"cpu| / max |cpu| {rel:.3e} (tolerance {TOL_FULL_WIDTH_REL:.0e})")
    if not finite or not rel <= TOL_FULL_WIDTH_REL:
        raise AssertionError("full-width card and CPU decode steps disagree")
    _engine_graph_check(eng, params, tokens, cfg)
    return {"launches": launches, "tokens_per_s_wall": n_tok / wall,
            "peak_mib": peak / 2**20, "wall_ms": 1e3 * wall}


def _engine_graph_check(eng, params, tokens, cfg) -> None:
    """The engine's decode chunk (an eager warm-up step, then replays of
    its captured step) against ``paged_decode_step`` run eagerly with
    the argmax fed back, from identical pools: the same tokens (or a
    parting at a near-tie of the eager logits), and then the same pools
    outside the null block (bf16 rounding through six layers at most, if
    cuBLAS took other paths under capture)."""
    k = ENGINE_GRAPH_STEPS
    pk = [p.clone() for p in eng.pool_ks]
    pv = [p.clone() for p in eng.pool_vs]
    tables = torch.tensor(eng.tables, device=DEV)        # copies
    lens = torch.tensor(eng.lens, device=DEV)
    n_live = eng._live_blocks_bucket(k)
    got = eng.step_chunk(max_steps=k)
    toks = torch.tensor(tokens, device=DEV)
    eager, logits = [], []
    for _ in range(k):
        lg, pk, pv = paged_decode_step(params, cfg, pk, pv, tables, lens,
                                       toks, n_live_blocks=n_live)
        toks = lg.argmax(-1).to(torch.int32)
        eager.append(toks)
        logits.append(lg)
        lens = lens + 1
    eager = torch.stack(eager, 1).cpu()
    active = sorted(got)
    rows = [r.row for r in eng.rows if r is not None]
    graph = torch.tensor([got[rid] for rid in active])
    parts = _partings(graph, eager[rows], torch.stack(logits), rows)
    # block 0 is the null block, where the idle rows' appends collide
    pools = [(a[1:], b[1:]) for a, b in zip(eng.pool_ks + eng.pool_vs,
                                            pk + pv)]
    same_pools = all(torch.equal(a, b) for a, b in pools)
    rel = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in pools)
    print(f"  {k} engine decode steps (a warm-up, then replays) against "
          f"eager paged_decode_step from identical pools: tokens equal "
          f"{not parts}, pools bit-identical {same_pools} (max |graph - "
          f"eager| / max |eager| {rel:.3e})"
          + "".join(f"; row {r} parts at step {j} ({sl:.2e} of the largest "
                    f"|logit| below the eager top)" for r, j, sl in parts))
    if any(sl > TOL_TIE_REL for _, _, sl in parts) or (
            not parts and not rel <= TOL_FULL_WIDTH_REL):
        raise AssertionError("the engine's replayed steps disagree with "
                             "the eager step")
    # the chunk's one wait is its copy of the tokens to the host; its
    # replays take none (this engine is not used after them)
    step = eng._steps[n_live]
    with no_device_waits():
        for _ in range(k):
            step()
    torch.cuda.synchronize()
    print(f"  {k} more replays of the engine's step under sync-debug mode: "
          f"no host wait")


def _partings(got, ref, logits, rows=None):
    """Rows where the token streams ``got`` and ``ref`` [n_rows, n]
    part: (row, step, how far ``got``'s token lies below the top of
    ``ref``'s logits at that step [n, b, vocab], as a share of their
    largest |logit|). ``rows`` maps stream rows to logits rows."""
    out = []
    for i in range(got.shape[0]):
        diff = torch.nonzero(got[i] != ref[i])
        if len(diff):
            j = int(diff[0])
            row = i if rows is None else rows[i]
            lg = logits[j, row].float()
            out.append((row, j, ((lg.max() - lg[int(got[i, j])])
                                 / lg.abs().max()).item()))
    return out


FLASH_KERNELS = (
    ("flash_forward", "tpu_dra_driver/workloads/ops/attention.py:105"),
    ("flash_backward_dq", "tpu_dra_driver/workloads/ops/attention.py:528"),
    ("flash_backward_dkv", "tpu_dra_driver/workloads/ops/attention.py:635"),
)


def _flash_wrappers():
    return {name: getattr(fa, name) for name, _ in FLASH_KERNELS}


def _flash_inputs(shape, dtype, gen):
    """(q, k, v, dO, g_lse) drawn on the CPU from ``gen``, on the card."""
    b, h, h_kv, t, tkv, d = shape

    def randn(*size):
        return torch.randn(size, generator=gen).to(DEV, dtype)

    return (randn(b, h, t, d), randn(b, h_kv, tkv, d), randn(b, h_kv, tkv, d),
            randn(b, h, t, d), randn(b, h, t).float())


def _flash_pairs(q, k, v, dout, g_lse, mask, grad_f32=False):
    """{output: (kernel's, plain version's)} for out, lse, dq, dk and dv
    on the same inputs, the gradients in f32 with ``grad_f32``; both
    backward versions take the kernel forward's out and lse."""
    out, lse = fa.flash_forward(q, k, v, **mask)
    want_out, want_lse = fa._flash_forward_plain(q, k, v, **mask)
    dd = (dout.float() * out.float()).sum(-1) - g_lse
    args = (q, k, v, dout, lse, dd)
    dq = fa.flash_backward_dq(*args, **mask, f32_out=grad_f32)
    dk, dv = fa.flash_backward_dkv(*args, **mask, f32_out=grad_f32)
    want_dq = fa._flash_backward_dq_plain(*args, **mask, f32_out=grad_f32)
    want_dk, want_dv = fa._flash_backward_dkv_plain(*args, **mask,
                                                    f32_out=grad_f32)
    torch.cuda.synchronize()
    return {"out": (out, want_out), "lse": (lse, want_lse),
            "dq": (dq, want_dq), "dk": (dk, want_dk), "dv": (dv, want_dv)}


def _errors(pairs):
    """{output: (max abs error, largest |plain value|)}"""
    return {name: ((a.float() - b.float()).abs().max().item(),
                   b.float().abs().max().item())
            for name, (a, b) in pairs.items()}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 with at least one axis: its rows are its last axis."""
    x = x.float()
    return x[None] if x.ndim == 0 else x


def _row_err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Largest |x - ref| of each row."""
    return (_rows(x) - _rows(ref)).abs().amax(-1)


def _row_scale(ref: torch.Tensor) -> torch.Tensor:
    """Largest |value| of each row of ``ref``, and at least 1e-3 of its
    largest value (a row whose value cancels to 0, as dq of the first
    row, keeps the rounding of the terms it sums)."""
    scale = _rows(ref).abs().amax(-1)
    return scale.clamp_min(1e-3 * scale.max().item())


def _allowance(plain: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """What each row of a bf16 result may be off ``ref``:
    ``TOL_BF16_VS_PLAIN`` times the bf16 ``plain`` result's error in that
    row, plus ``TOL_BF16_ROW_ATOL`` of the row's scale."""
    return (TOL_BF16_VS_PLAIN * _row_err(plain, ref)
            + TOL_BF16_ROW_ATOL * _row_scale(ref))


def _bf16_reading(got, plain, ref) -> dict:
    """The kernel's (``got``) and the plain version's worst row error
    relative to the row's scale, the position along the sequence (the
    second-last axis) of the kernel's worst row, and the kernel's worst
    error over its allowance."""
    scale = _row_scale(ref)
    err_k, err_p = _row_err(got, ref), _row_err(plain, ref)
    rel_k = (err_k / scale).reshape(-1, *err_k.shape[-1:])
    return {"kernel": rel_k.max().item(),
            "at": int(rel_k.argmax().item()) % rel_k.shape[-1],
            "plain": (err_p / scale).max().item(),
            "over": (err_k / _allowance(plain, ref)).max().item()}


def _flash_f32_reference(q, k, v, dout, g_lse, mask=None):
    """out, lse, dq, dk, dv of the plain versions in f32 on f32 copies
    of the (bf16) inputs, and the f32 operands the mutants need."""
    mask = mask or {}
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    out, lse = fa._flash_forward_plain(q32, k32, v32, **mask)
    dd = (do32 * out).sum(-1) - g_lse
    dq, dk, dv = fa._flash_backward_plain(q32, k32, v32, do32, lse, dd,
                                          **mask)
    ref = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    return ref, (q32, k32, v32, do32, lse, dd)


def _tile_omission(allow, operands, row0, col0, n, mask=None):
    """{output: the largest error over its allowance (``allow``, per
    row) in the rows that the n x n tile (q rows row0.., KV columns
    col0..) touches, with that tile left out of every sum}: what a
    kernel that skipped the tile would give, to first order."""
    q32, k32, v32, do32, lse, dd = operands
    h, h_kv, t, d = q32.shape[1], k32.shape[1], q32.shape[2], q32.shape[3]
    rows, cols = slice(row0, row0 + n), slice(col0, col0 + n)
    rep = h // h_kv
    kr = k32[:, :, cols].repeat_interleave(rep, dim=1)
    vr = v32[:, :, cols].repeat_interleave(rep, dim=1)
    qt, dot = q32[:, :, rows], do32[:, :, rows]
    mask = mask or {}
    vis = fa._visible(t, k32.shape[2], mask.get("causal", True),
                      mask.get("window"), mask.get("row_offset", 0),
                      mask.get("prefix"), q32.device)[rows][:, cols]
    s = torch.einsum("bhid,bhjd->bhij", qt, kr) / math.sqrt(d)
    p = torch.where(vis, torch.exp(s - lse[:, :, rows, None]), 0.0)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dot, vr)
              - dd[:, :, rows, None])
    b = q32.shape[0]

    def group_sum(x):
        return x.reshape(b, h_kv, rep, n, d).sum(2)

    missing = {
        "out": (torch.einsum("bhij,bhjd->bhid", p, vr), rows),
        "dq": (torch.einsum("bhij,bhjd->bhid", ds, kr) / math.sqrt(d), rows),
        "dk": (group_sum(torch.einsum("bhij,bhid->bhjd", ds, qt))
               / math.sqrt(d), cols),
        "dv": (group_sum(torch.einsum("bhij,bhid->bhjd", p, dot)), cols),
    }
    return {o: (c.abs().amax(-1) / allow[o][:, :, at]).max().item()
            for o, (c, at) in missing.items()}


def _empty_rows(shape, mask) -> torch.Tensor:
    """[t] bool: the q rows whose band is empty under ``mask``."""
    vis = fa._visible(shape[3], shape[4], mask.get("causal", True),
                      mask.get("window"), mask.get("row_offset", 0),
                      mask.get("prefix"), DEV)
    return ~vis.any(-1)


def _check_empty_rows(pairs, empty, label) -> None:
    """Rows with an empty band give out 0, dq 0 and the finite lse."""
    if not empty.any():
        return
    out, dq = pairs["out"][0], pairs["dq"][0]
    lse = pairs["lse"][0][:, :, empty]
    want = (fa.NEG_INF + math.log2(1e-30)) / fa.LOG2E
    print(f"  {int(empty.sum())} rows with an empty band: max |out| "
          f"{out[:, :, empty].abs().max().item()}, max |dq| "
          f"{dq[:, :, empty].abs().max().item()}, lse "
          f"{lse.min().item():.6e}..{lse.max().item():.6e}")
    if (out[:, :, empty] != 0).any() or (dq[:, :, empty] != 0).any() \
            or not torch.allclose(lse, torch.full_like(lse, want),
                                  rtol=1e-6):
        raise AssertionError(f"{label}: empty-band rows are not out 0, dq 0 "
                             f"and the finite empty lse")


def _flash_bf16_case(name, shape, mask, gen, tiles=()) -> None:
    """One bf16 mask case: out, dq, dk and dv row by row against the f32
    reference within the allowance, lse within TOL_FLASH_LSE of it on
    rows with a band, empty-band rows exact; a 64 x 64 tile at each of
    ``tiles`` left out shown to break the allowance of every output."""
    q, k, v, dout, g_lse = _flash_inputs(shape, torch.bfloat16, gen)
    pairs = _flash_pairs(q, k, v, dout, g_lse, mask)
    ref, operands = _flash_f32_reference(q, k, v, dout, g_lse, mask)
    empty = _empty_rows(shape, mask)
    lse_err = (pairs["lse"][0] - ref["lse"])[:, :, ~empty].abs().max().item()
    readings = {o: _bf16_reading(pairs[o][0], pairs[o][1], ref[o])
                for o in ("out", "dq", "dk", "dv")}
    print(f"bf16 {name} {shape} {mask}: lse {lse_err:.2e}; worst row over "
          f"its allowance " + ", ".join(
              f"{o} {r['over']:.3f}" for o, r in readings.items()))
    if tiles:
        allow = {o: _allowance(pairs[o][1], ref[o])
                 for o in ("out", "dq", "dk", "dv")}
        omitted = [_tile_omission(allow, operands, r0, c0,
                                  FLASH_MUTANT_TILE, mask)
                   for r0, c0 in tiles]
        print("  a tile left out, over the allowance: " + "; ".join(
            f"tile {r0},{c0}: " + ", ".join(f"{o} {m[o]:.1f}" for o in m)
            for m, (r0, c0) in zip(omitted, tiles)))
        for m in omitted:
            if not min(m.values()) > 1.0:
                raise AssertionError(f"the bf16 allowance in case {name} "
                                     f"would not see a tile left out ({m})")
    if not lse_err <= TOL_FLASH_LSE:
        raise AssertionError(f"flash lse disagrees in bf16 case {name}: "
                             f"{lse_err}")
    for o, r in readings.items():
        if not r["over"] <= 1.0:
            raise AssertionError(f"flash {o} disagrees in bf16 case {name}: "
                                 f"{r['over']} of its allowance")
    _check_empty_rows(pairs, empty, f"bf16 {name}")


def _flash_full_width(gen, mask: dict, shape=None,
                      tiles=FLASH_MUTANT_TILES, grad_f32=False) -> dict:
    """B1-B3 at a full-width shape (b, h, h_kv, t, tkv, d) in bf16 under
    ``mask`` (causal when empty, bidirectional with ``prefix`` = t, no
    mask with ``causal=False``, a band with ``window``, a ring's hop with
    ``row_offset``, whose rows with an empty band must come out as
    phase 4 checks them and are left out of the lse's error); the shape
    defaults to the training configuration's: every output row against
    the f32 reference within its allowance, a 64 x 64 tile at each of
    ``tiles`` left out shown to break that allowance, then each kernel
    timed with a cold L2 against its plain version, SDPA (causal or not,
    as the mask; with a window, an explicit band mask) and its bound
    from this run's visible pairs, returned by kernel name. With
    ``grad_f32`` B2 and B3 write their gradients in f32, as a ring's
    hops do."""
    if shape is None:
        b, h, h_kv, t, d = FLASH_FULL
        shape = (b, h, h_kv, t, t, d)
    b, h, h_kv, t, tkv, d = shape
    q, k, v, dout, g_lse = _flash_inputs(shape, torch.bfloat16, gen)
    g_lse.zero_()                     # flash_attention's backward: no lse
    pairs = _flash_pairs(q, k, v, dout, g_lse, mask, grad_f32)
    errs = _errors(pairs)
    empty = _empty_rows(shape, mask)
    if empty.any():
        _check_empty_rows(pairs, empty, f"bf16 {shape} {mask}")
        errs["lse"] = _errors({"lse": tuple(
            x[:, :, ~empty] for x in pairs["lse"])})["lse"]
    label = f"{mask or 'causal'}{', gradients in f32' if grad_f32 else ''}"
    print(f"bf16 {shape} {label}, kernel vs plain: " + ", ".join(
        f"{o} {e:.2e} (largest {top:.2e})" for o, (e, top) in errs.items()))
    if not errs["lse"][0] <= TOL_FLASH_LSE:
        raise AssertionError(f"flash lse disagrees in bf16 at full width: "
                             f"{errs['lse'][0]} > {TOL_FLASH_LSE}")
    ref, operands = _flash_f32_reference(q, k, v, dout, g_lse, mask)
    outputs = ("out", "dq", "dk", "dv")
    allow = {o: _allowance(pairs[o][1], ref[o]) for o in outputs}
    omitted = [_tile_omission(allow, operands, r0, c0, FLASH_MUTANT_TILE,
                              mask)
               for r0, c0 in tiles]
    del operands
    print("  worst row vs the f32 reference, relative to the row's largest "
          "value (kernel, bf16 plain); kernel's worst error over its "
          "allowance (<= 1 passes); a tile left out, over the allowance "
          "(> 1 is seen)")
    for o in outputs:
        got = _bf16_reading(pairs[o][0], pairs[o][1], ref[o])
        mutants = [m[o] for m in omitted]
        print(f"  {o}: {got['kernel']:.3e} (row {got['at']}), "
              f"{got['plain']:.3e}; {got['over']:.3f}; " + ", ".join(
                  f"tile {r0},{c0} {m:.1f}"
                  for m, (r0, c0) in zip(mutants, tiles)))
        if not got["over"] <= 1.0:
            raise AssertionError(f"flash {o} disagrees in bf16 at full "
                                 f"width: {got['over']} of its allowance")
        if not min(mutants) > 1.0:
            raise AssertionError(f"the bf16 allowance on {o} would not see "
                                 f"a tile left out ({mutants})")
    del ref, pairs, allow
    torch.cuda.empty_cache()

    # timings with a cold L2, bounds and library yardsticks
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    out, lse = fa.flash_forward(q, k, v, **mask)
    dd = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, dout, lse, dd)
    ms = {
        "flash_forward": time_ms(lambda: fa.flash_forward(q, k, v, **mask),
                                 flush=flush),
        "flash_backward_dq": time_ms(
            lambda: fa.flash_backward_dq(*args, **mask, f32_out=grad_f32),
            flush=flush),
        "flash_backward_dkv": time_ms(
            lambda: fa.flash_backward_dkv(*args, **mask, f32_out=grad_f32),
            flush=flush),
    }
    plain_ms = {
        "flash_forward": time_ms(
            lambda: fa._flash_forward_plain(q, k, v, **mask), iters=5,
            flush=flush),
        "flash_backward_dq": time_ms(
            lambda: fa._flash_backward_dq_plain(*args, **mask,
                                                f32_out=grad_f32),
            iters=5, flush=flush),
        "flash_backward_dkv": time_ms(
            lambda: fa._flash_backward_dkv_plain(*args, **mask,
                                                 f32_out=grad_f32),
            iters=5, flush=flush),
    }
    torch.cuda.empty_cache()
    # yardsticks only (the port never calls them): SDPA's forward, and
    # its backward, one time for dq, dk and dv together; causal, or over
    # every pair when the prefix covers the sequence or there is no mask
    # (the bound below counts the same visible pairs)
    vis = fa._visible(t, tkv, mask.get("causal", True), mask.get("window"),
                      mask.get("row_offset", 0), mask.get("prefix"), DEV)
    if "window" in mask:
        # SDPA has no band: an explicit [t, tkv] mask, over every pair
        sdpa = {"attn_mask": vis, "enable_gqa": True}
    else:
        sdpa = {"is_causal": mask.get("causal", True) and "prefix" not in mask,
                "enable_gqa": True}
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa), flush=flush)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, **sdpa)
    # over the rows with a band (SDPA gives NaN where the mask hides a
    # whole row)
    lib_err = (lib_out.float() - out.float())[:, :, ~empty].abs().max().item()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), dout, retain_graph=True), flush=flush)
    del lib_out
    library_ms = {"flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
                  "flash_backward_dkv": lib_bwd}
    if "window" in mask:
        print(f"SDPA with an explicit band mask ran "
              f"{_sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa))}"
              f" (a masked SDPA is not its flash kernel)")

    pairs = b * h * int(vis.sum().item())
    err = {"flash_forward": errs["out"][0],
           "flash_backward_dq": errs["dq"][0],
           "flash_backward_dkv": max(errs["dk"][0], errs["dv"][0])}
    result = _flash_rows(q, k, pairs, err, ms, plain_ms, library_ms,
                         grad_f32)
    print(f"SDPA backward is one time for dq, dk and dv together; "
          f"max |SDPA out - B1 out| {lib_err:.2e}")
    return result


def _flash_rows(q, k, pairs, err, ms, plain_ms, library_ms,
                grad_f32=False) -> dict:
    """{kernel: its reading} with the bound from this run's inputs (each
    input read once, each output written once, the gradients 4 bytes an
    element with ``grad_f32``; 4 d (B1), 6 d (B2), 8 d (B3) flops per
    visible pair), printed a line each."""
    b, h, t, d = q.shape
    qb, kvb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rowb = b * h * t * 4                              # lse or D, f32
    widen = 4 // q.element_size() if grad_f32 else 1  # dq, dk, dv written
    work = {
        "flash_forward": (2 * qb + 2 * kvb + rowb, 4 * d * pairs),
        "flash_backward_dq": ((2 + widen) * qb + 2 * kvb + 2 * rowb,
                              6 * d * pairs),
        "flash_backward_dkv": (2 * qb + (2 + 2 * widen) * kvb + 2 * rowb,
                               8 * d * pairs),
    }
    result = {}
    for name, _ in FLASH_KERNELS:
        n_bytes, n_flops = work[name]
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        result[name] = {
            "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "library_ms": library_ms[name],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        lib = "not measured" if library_ms[name] is None \
            else f"{library_ms[name]:.4f} ms"
        print(f"{name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms, SDPA {lib}; "
              f"bound {bound_ms:.4f} ms ({n_bytes} bytes, {n_flops} flops); "
              f"kernel at {100 * bound_ms / ms[name]:.1f}% of bound")
    return result


def _flash_f32_case(name, shape, mask, gen) -> None:
    """One f32 mask case: out, lse, dq, dk and dv within TOL_FLASH_F32 of
    the plain versions, empty-band rows exact."""
    q, k, v, dout, g_lse = _flash_inputs(shape, torch.float32, gen)
    pairs = _flash_pairs(q, k, v, dout, g_lse, mask)
    errs = _errors(pairs)
    print(f"f32 {name} {shape} {mask}: " + ", ".join(
        f"{o} {e:.2e}" for o, (e, _) in errs.items()))
    for o, (e, top) in errs.items():
        if not e <= TOL_FLASH_F32 * max(1.0, top):
            raise AssertionError(f"flash {o} disagrees in f32 case "
                                 f"{name}: {e} (largest {top})")
    _check_empty_rows(pairs, _empty_rows(shape, mask), f"f32 {name}")


def _flash_train_calls(q, k, v, dout):
    """B1, then B2 and B3 on its out and lse with D = rowsum(dO * O), as
    flash_attention's forward and backward call them: (out, lse, dq, dk,
    dv)."""
    out, lse = fa.flash_forward(q, k, v)
    dd = (dout.float() * out.float()).sum(-1)
    dq = fa.flash_backward_dq(q, k, v, dout, lse, dd)
    dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse, dd)
    return out, lse, dq, dk, dv


def _flash_rerun_and_graph(gen) -> None:
    """B1-B3 at the training shape: two eager calls of each bit for bit
    the same, and the three captured in one CUDA graph and replayed on
    new inputs copied into its own, equal bit for bit to the eager calls
    on those."""
    b, h, h_kv, t, d = FLASH_FULL
    shape = (b, h, h_kv, t, t, d)
    q, k, v, dout, _ = _flash_inputs(shape, torch.bfloat16, gen)
    first = _flash_train_calls(q, k, v, dout)
    second = _flash_train_calls(q, k, v, dout)
    rerun = all(torch.equal(x, y) for x, y in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # the warm-up a capture needs
        _flash_train_calls(q, k, v, dout)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _flash_train_calls(q, k, v, dout)
    fresh = _flash_inputs(shape, torch.bfloat16, gen)[:4]
    for into, x in zip((q, k, v, dout), fresh):
        into.copy_(x)
    graph.replay()
    eager = _flash_train_calls(*fresh)
    torch.cuda.synchronize()
    replayed = all(torch.equal(x, y) for x, y in zip(captured, eager))
    moved = all(not torch.equal(x, y) for x, y in zip(captured, first))
    print(f"B1-B3 {shape} causal: a second run bit-identical {rerun}; a "
          f"graph replay on new inputs equal to the eager calls {replayed} "
          f"(out, lse, dq, dk and dv moved with them: {moved})")
    if not (rerun and replayed and moved):
        raise AssertionError("B1-B3 are not the same from run to run, or "
                             "their graph replay is not the eager calls")
    del graph, captured
    torch.cuda.empty_cache()


def flash_phase(gen) -> dict:
    # every mask form, f32
    for name, (shape, mask) in FLASH_CASES.items():
        _flash_f32_case(name, shape, mask, gen)

    # every mask form, bf16
    for name, (shape, mask) in FLASH_BF16_CASES.items():
        _flash_bf16_case(name, shape, mask, gen)
    # B1's and B2's persistent schedule and B3's walk, drawn from a
    # generator of its own so that the checks after these draw from
    # ``gen`` what they drew before
    schedule = torch.Generator().manual_seed(15)
    for name, (shape, mask, tiles) in FLASH_SCHEDULE_CASES.items():
        _flash_bf16_case(name, shape, mask, schedule, tiles)
    for name, (shape, mask, tiles) in FLASH_BWD_SCHEDULE_CASES.items():
        _flash_bf16_case(name, shape, mask, schedule, tiles)
    _flash_rerun_and_graph(schedule)
    torch.cuda.empty_cache()

    # the training shapes, bf16
    return _flash_full_width(gen, {})


def _decode_inputs(shape, dtype, gen, int8=False):
    """(q, k, v, k_scale, v_scale) drawn on the CPU from ``gen``, on the
    card; an int8 cache holds codes in [-127, 127] with scales in [0.01,
    0.03), else the scales are None."""
    b, h, h_kv, L, hd = shape
    q = torch.randn((b, h, 1, hd), generator=gen).to(DEV, dtype)
    if not int8:
        k, v = (torch.randn((b, h_kv, L, hd), generator=gen).to(DEV, dtype)
                for _ in range(2))
        return q, k, v, None, None
    k, v = (torch.randint(-127, 128, (b, h_kv, L, hd), generator=gen,
                          dtype=torch.int8).to(DEV) for _ in range(2))
    ks, vs = ((torch.rand((b, h_kv, L), generator=gen) * 0.02 + 0.01).to(DEV)
              for _ in range(2))
    return q, k, v, ks, vs


def _decode_bytes_flops(q, k, pos, quantized):
    """(bytes, flops) one read needs: the live K and V rows (and their
    scales) and q read once, the output written once; QK and PV."""
    b, h, _, hd = q.shape
    h_kv, L = k.shape[1], k.shape[2]
    n = min(pos + 1, L)
    n_bytes = (2 * b * h_kv * n * hd * k.element_size()
               + (2 * b * h_kv * n * 4 if quantized else 0)
               + 2 * q.numel() * q.element_size())
    return n_bytes, 4 * b * h * hd * n


def _decode_check(label, q, k, v, ks, vs, pos) -> float:
    """One B5 reading against its plain version, returning the largest
    |kernel - plain|: f32 queries within TOL_F32; bf16 queries row by row
    against an f32 reference, with a sub-tile of the middle of the live
    range left out shown to break the allowance in every row."""
    got = da.flash_decode_attention(q, k, v, pos, ks, vs)
    # the same read with the position on the device, launched where any
    # host wait raises: one partition, so the same bits
    pos_dev = torch.tensor([pos], dtype=torch.int32, device=DEV)
    with no_device_waits():
        got_dev = da.flash_decode_attention(q, k, v, pos_dev, ks, vs)
    plain = da.flash_decode_attention_plain(q, k, v, pos, ks, vs)
    torch.cuda.synchronize()
    if not torch.equal(got, got_dev):
        raise AssertionError(f"B5 with a device pos differs from the int "
                             f"pos: {label} pos {pos}")
    err = (got.float() - plain.float()).abs().max().item()
    if q.dtype == torch.float32:
        print(f"  {label} pos {pos}: max |kernel - plain| {err:.3e} "
              f"(tolerance {TOL_F32:.0e}); device pos bit-identical")
        if not err <= TOL_F32:
            raise AssertionError(f"B5 disagrees with its plain version: "
                                 f"{label} pos {pos}, {err}")
        return err

    def f32(x):
        return x if x is None or x.dtype == torch.int8 else x.float()

    args32 = [f32(x) for x in (q, k, v, ks, vs)]
    ref = da.flash_decode_attention_plain(args32[0], args32[1], args32[2],
                                          pos, args32[3], args32[4])
    reading = _bf16_reading(got, plain, ref)
    n = min(pos + 1, k.shape[2])
    t0 = (n // 2) // DECODE_MUTANT_TILE * DECODE_MUTANT_TILE
    cut = slice(t0, t0 + DECODE_MUTANT_TILE)

    def without(x, axis):
        keep = [slice(None)] * x.ndim
        keep[axis] = slice(0, t0)
        rest = list(keep)
        rest[axis] = slice(cut.stop, None)
        return torch.cat([x[tuple(keep)], x[tuple(rest)]], dim=axis)

    mutant = da.flash_decode_attention_plain(
        args32[0], without(args32[1], 2), without(args32[2], 2),
        pos - DECODE_MUTANT_TILE,
        *(None if x is None else without(x, 2) for x in args32[3:]))
    seen = (_row_err(mutant, ref) / _allowance(plain, ref)).flatten()
    print(f"  {label} pos {pos}: device pos bit-identical; max |kernel - "
          f"plain| {err:.3e}; worst row "
          f"vs f32 {reading['kernel']:.3e} (plain {reading['plain']:.3e}); "
          f"over allowance {reading['over']:.3f}; slots {t0}-{cut.stop - 1} "
          f"left out: least {seen.min().item():.1f}, median "
          f"{seen.median().item():.1f} times the allowance")
    if not reading["over"] <= 1.0:
        raise AssertionError(f"B5 disagrees in {label} at pos {pos}: "
                             f"{reading['over']} of its allowance")
    if not seen.min().item() > 1.0:
        raise AssertionError(f"the {label} allowance would not see a "
                             f"sub-tile left out: {seen.min().item()}")
    return err


def _decode_nan_check(gen) -> None:
    """Slots past pos, and their scales, filled with NaN on the card must
    leave B5's output unchanged: they are excluded by select."""
    for int8 in (False, True):
        q, k, v, ks, vs = _decode_inputs(DECODE_FULL, torch.bfloat16, gen,
                                         int8=int8)
        for pos in DECODE_NAN_POS:
            want = da.flash_decode_attention(q, k, v, pos, ks, vs)
            if int8:
                ks2, vs2 = ks.clone(), vs.clone()
                ks2[:, :, pos + 1:] = float("nan")
                vs2[:, :, pos + 1:] = float("nan")
                got = da.flash_decode_attention(q, k, v, pos, ks2, vs2)
            else:
                k2, v2 = k.clone(), v.clone()
                k2[:, :, pos + 1:] = float("nan")
                v2[:, :, pos + 1:] = float("nan")
                got = da.flash_decode_attention(q, k2, v2, pos)
            if not torch.equal(got, want):
                raise AssertionError(f"NaN past pos {pos} moved B5's output "
                                     f"(int8 {int8})")
    print(f"  NaN in the slots past pos {DECODE_NAN_POS} (bf16 K/V; int8 "
          f"scales): outputs unchanged")


def _decode_graph_check(gen) -> None:
    """B5 with its position on the device, captured once in a CUDA graph
    and replayed after ``pos.fill_(p)``: each replay equals the eager
    call with the int position."""
    q, k, v, _, _ = _decode_inputs(DECODE_FULL, torch.bfloat16, gen)
    pos = torch.zeros((), dtype=torch.int32, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_attention(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.flash_decode_attention(q, k, v, pos)
    for p in DECODE_GRAPH_POS:
        pos.fill_(p)
        graph.replay()
        eager = da.flash_decode_attention(q, k, v, p)
        if not torch.equal(out, eager):
            raise AssertionError(f"B5's graph replay at pos {p} differs "
                                 f"from the eager call")
    print(f"  one CUDA graph, replayed at pos {DECODE_GRAPH_POS}: each "
          f"replay equal to the eager call")


def _decode_profile(gen, flush, pos, shape=DECODE_FULL,
                    iters: int = 20) -> dict:
    """B5's split and merge kernels (bf16 and int8 caches) and SDPA over
    the live slots at ``shape`` on one clock: mean device ms per launch
    of each kernel in one ``torch.profiler`` session, each call after a
    flush of the L2, after every event reading of the phase. A kernel
    the profiler recorded no time for is reported as not measured.
    Returns {"bf16 split", "int8 split", "merge": (kernel name, ms)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _, _ = _decode_inputs(shape, torch.bfloat16, gen)
    q8, k8, v8, ks, vs = _decode_inputs(shape, torch.bfloat16, gen,
                                        int8=True)
    kl, vl = k[:, :, :pos + 1], v[:, :, :pos + 1]
    calls = (lambda: da.flash_decode_attention(q, k, v, pos),
             lambda: da.flash_decode_attention(q8, k8, v8, pos, ks, vs),
             lambda: F.scaled_dot_product_attention(q, kl, vl,
                                                    enable_gqa=True))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in calls:
                flush.zero_()
                fn()
        torch.cuda.synchronize()
    ms, sdpa = {}, {}
    for e in prof.key_averages():
        low = e.key.lower()
        if e.device_type != DeviceType.CUDA or not e.count \
                or "zero" in low or "fill" in low:
            continue
        mean = e.self_device_time_total / 1e3 / e.count
        if "flash_decode_split" in low:
            ms["int8 split" if "signed char" in low else "bf16 split"] = (
                e.key, mean)
        elif "flash_decode_merge" in low:
            ms["merge"] = (e.key, mean)
        else:
            sdpa[e.key[:40]] = mean

    def show(key):
        return f"{ms[key][1]:.4f} ms" if key in ms else "not measured"

    merge = show("merge")
    for label in ("bf16", "int8"):
        split = ms.get(f"{label} split")
        total = (f" = {split[1] + ms['merge'][1]:.4f} ms"
                 if split is not None and "merge" in ms else "")
        print(f"B5 {label} at pos {pos} by the profiler: split "
              f"{show(f'{label} split')} + merge {merge}{total}")
    for key, (name, _) in sorted(ms.items()):
        print(f"  {key}: {name}")
    print("SDPA over the live slots by the profiler: "
          + (f"{sum(sdpa.values()):.4f} ms ("
             + ", ".join(f"{k} {v:.4f}" for k, v in sdpa.items()) + ")"
             if sdpa else "not measured"))
    return ms


def decode_kernel_phase(gen) -> dict:
    b, h, h_kv, L, hd = DECODE_FULL
    errs = []
    for pos in DECODE_BF16_POS:
        errs.append(_decode_check("bf16", *_decode_inputs(
            DECODE_FULL, torch.bfloat16, gen), pos))
    for pos in DECODE_INT8_POS:
        errs.append(_decode_check("int8 cache, bf16 q", *_decode_inputs(
            DECODE_FULL, torch.bfloat16, gen, int8=True), pos))
    f32 = _decode_inputs(DECODE_FULL, torch.float32, gen)
    for pos in DECODE_F32_POS:
        _decode_check("f32", *f32, pos)
    _decode_check("int8 cache, f32 q", *_decode_inputs(
        DECODE_FULL, torch.float32, gen, int8=True), DECODE_F32_POS[1])
    ring_len, ring_pos = DECODE_RING
    ring = (b, h, h_kv, ring_len, hd)
    _decode_check("ring f32", *_decode_inputs(ring, torch.float32, gen),
                  ring_pos)
    errs.append(_decode_check("ring bf16", *_decode_inputs(
        ring, torch.bfloat16, gen), ring_pos))
    errs.append(_decode_check("MQA bf16 (h_kv 1, rep 16)", *_decode_inputs(
        DECODE_MQA, torch.bfloat16, gen), DECODE_BF16_POS[0]))
    del f32
    torch.cuda.empty_cache()
    _decode_nan_check(gen)
    _decode_graph_check(gen)

    # timings with a cold L2 at pos 2048, bounds and the library yardstick
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    pos = DECODE_BF16_POS[0]
    out = _decode_readings(gen, flush, pos, DECODE_FULL)
    _decode_profile(gen, flush, pos)
    del flush
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), **out["bf16"]}


def _decode_readings(gen, flush, pos, shape) -> dict:
    """{"bf16", "int8": B5 at ``shape`` and ``pos`` timed with a cold L2
    against its plain version, SDPA over the live slots (bf16 only) and
    its bound}."""
    out = {}
    for label, int8 in (("bf16", False), ("int8", True)):
        q, k, v, ks, vs = _decode_inputs(shape, torch.bfloat16, gen,
                                         int8=int8)
        ms = time_ms(lambda: da.flash_decode_attention(q, k, v, pos, ks, vs),
                     flush=flush)
        plain_ms = time_ms(lambda: da.flash_decode_attention_plain(
            q, k, v, pos, ks, vs), iters=20, flush=flush)
        n_bytes, n_flops = _decode_bytes_flops(q, k, pos, int8)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        if int8:
            library_ms, lib_note = None, ("no single PyTorch call reads an "
                                          "int8 cache with per-slot scales")
        else:
            # yardstick only (the port never calls it)
            kl, vl = k[:, :, :pos + 1], v[:, :, :pos + 1]
            lib_out = F.scaled_dot_product_attention(q, kl, vl,
                                                     enable_gqa=True)
            got = da.flash_decode_attention(q, k, v, pos)
            lib_err = (lib_out.float() - got.float()).abs().max().item()
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, kl, vl, enable_gqa=True), flush=flush)
            lib_note = (f"SDPA over the live slots {library_ms:.4f} ms (max "
                        f"|SDPA - kernel| {lib_err:.2e})")
        print(f"{label} at pos {pos}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; {lib_note}; bound {bound_ms:.4f} ms "
              f"({n_bytes} bytes, {n_flops} flops); kernel at "
              f"{100 * bound_ms / ms:.1f}% of bound")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
    return out


def serving_throughput_phase(card: str, run_ms: float) -> None:
    params = init_params(FULL, 3, device=DEV)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, FULL.vocab, n)]
               for n in FULL_PROMPT_LENS]
    t0 = time.perf_counter()
    r = serving_throughput(params, FULL, prompts, FULL_NEW_TOKENS,
                           device=DEV, **FULL_ENGINE)
    dev = r["engine_device_tokens_per_sec"]
    seq = r["sequential_device_tokens_per_sec"]
    print(f"{card}: engine {r['engine_tokens_per_sec']:.1f} tokens/s wall, "
          f"sequential generate() {r['sequential_tokens_per_sec']:.1f}; "
          f"device time: engine {dev and round(dev, 1)} tokens/s, "
          f"sequential {seq and round(seq, 1)}; speedup wall "
          f"{r['speedup']:.3f}, dispatch {r['speedup_dispatch']:.3f}, "
          f"batching (device) {r['speedup_batching'] and round(r['speedup_batching'], 3)} "
          f"({time.perf_counter() - t0:.1f} s)")
    engine, sequential = r["outputs"], r["sequential_outputs"]
    if dev is None or sorted(engine) != sorted(sequential):
        raise AssertionError("serving_throughput: no device time, or not "
                             "one output per prompt on both paths")
    # where the paths part, both tokens must be near-ties of an f32
    # forward over the prompt and the common prefix
    params32 = tt._tree_map(lambda a: a.float(), params)
    cfg32 = replace(FULL, dtype=torch.float32)
    parts = []
    for i, p in enumerate(prompts):
        e, q = engine[i], sequential[i]
        j = next((k for k, (a, b) in enumerate(zip(e, q)) if a != b), None)
        if j is None:
            parts.append(f"{i}: equal")
            continue
        toks = torch.tensor([p + q[:j]], dtype=torch.int32, device=DEV)
        with torch.no_grad():
            logits = tt.forward(params32, toks, cfg32)[0, -1]
        scale = logits.abs().max().item()
        top = logits.max().item()
        off = max(top - logits[e[j]].item(), top - logits[q[j]].item())
        parts.append(f"{i}: equal to token {j}, then {e[j]} vs {q[j]}, "
                     f"{off / scale:.2e} of the largest |logit| below the "
                     f"f32 top")
        if not off <= TOL_TIE_REL * scale:
            raise AssertionError(f"serving_throughput: request {i} parts "
                                 f"at token {j} where no near-tie is: "
                                 f"{off / scale}")
    print(f"  engine vs sequential generate() ({FULL_NEW_TOKENS} tokens "
          f"each; tolerance {TOL_TIE_REL:.3g}): " + "; ".join(parts))
    # B4's share of the full-width serving run's device time: the run once
    # more under the profiler, after the wall-clock readings above
    eng = ServingEngine(params, FULL, device=DEV, **FULL_ENGINE)
    _profile_step(lambda: eng.run(prompts, FULL_NEW_TOKENS), run_ms,
                  SERVING_KERNEL_GROUPS, "serving run")


def small_generation_phase() -> None:
    StepGraph.captures = 0
    rng = np.random.RandomState(6)
    params = {dev: init_params(SMALL, 0, device=dev) for dev in (DEV, "cpu")}
    for name, (cfg, t0, steps, kw) in SMALL_GEN.items():
        prompt = torch.from_numpy(
            rng.randint(0, cfg.vocab, (2, t0)).astype(np.int32))
        toks, launches = {}, {}
        for dev in ("cpu", DEV):
            on_dev = prompt.to(dev)
            da.flash_decode_attention.launches = 0
            with no_device_waits():
                out = generate(params[dev], cfg, on_dev, steps=steps, **kw)
            launches[dev] = da.flash_decode_attention.launches
            toks[dev] = out.cpu()
        # the ring fills one slot a step (prefill included); chunked
        # prefill reads with the masked read (g > 1)
        expect = cfg.n_layers * (steps - 1 + (t0 if cfg.window else 0))
        same = torch.equal(toks[DEV], toks["cpu"])
        logits = {}
        if "prefill_chunk" in kw:
            for dev in (DEV, "cpu"):
                cache = init_kv_cache(cfg, 2, t0 + steps, device=dev)
                logits[dev] = chunked_prefill(params[dev], cfg, cache,
                                              prompt.to(dev), 4)[0].cpu()
        else:
            stream = toks["cpu"]
            for dev in (DEV, "cpu"):
                cache = init_kv_cache(cfg, 2, stream.shape[1], device=dev)
                got = []
                for pos in range(stream.shape[1]):
                    lg, cache = decode_step(params[dev], cfg, cache, pos,
                                            stream[:, pos].to(dev))
                    got.append(lg.cpu())
                logits[dev] = torch.stack(got)
        diff = (logits[DEV] - logits["cpu"]).abs().max().item()
        print(f"  {name}: {steps} greedy tokens card == cpu: {same}, the "
              f"host never waiting for the card in generate(); B5 "
              f"launches on the card {launches[DEV]} (expected {expect}); "
              f"logits max |card - cpu| {diff:.3e} (tolerance "
              f"{TOL_ENGINE_LOGITS:.0e})")
        if not same or launches[DEV] != expect \
                or not diff <= TOL_ENGINE_LOGITS:
            raise AssertionError(f"generation on the card and the CPU "
                                 f"disagree: {name}")
    # sampling replays the captured step with the caller's generator
    # registered with the graph: a top_k = 1 draw is the greedy pick, and
    # a seed repeats its draws
    prompt = torch.from_numpy(
        rng.randint(0, SMALL.vocab, (2, 16)).astype(np.int32)).to(DEV)

    def sample(seed, **kw):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        with no_device_waits():
            out = generate(params[DEV], SMALL, prompt, steps=24,
                           generator=gen, **kw)
        return out.cpu()

    greedy = generate(params[DEV], SMALL, prompt, steps=24).cpu()
    top1 = sample(0, temperature=0.7, top_k=1)
    drawn = [sample(seed, temperature=1.0) for seed in (1, 1, 2)]
    print(f"  sampled on the card: top_k=1 == greedy {torch.equal(top1, greedy)}"
          f", one seed twice equal {torch.equal(drawn[0], drawn[1])}, two "
          f"seeds differ {not torch.equal(drawn[0], drawn[2])}, "
          f"{StepGraph.captures} graphs captured in this phase so far")
    if not torch.equal(top1, greedy) or not torch.equal(drawn[0], drawn[1]) \
            or not bool(((drawn[0] >= 0) & (drawn[0] < SMALL.vocab)).all()):
        raise AssertionError("sampled generation on the card breaks its law")


def _eager_chain(params, cfg, prompt, steps, max_t):
    """The long chain by the eager loop: block prefill, then
    ``decode_step`` at int positions with the argmax fed back, every
    kernel issued from the host. Returns (tokens [b, t0 + steps], wall
    seconds, prefill included, logits of every pick [steps, b, vocab])."""
    b, t0 = prompt.shape
    logits = torch.empty((steps, b, cfg.vocab), device=DEV)
    torch.cuda.synchronize()
    start = time.perf_counter()
    cache = init_kv_cache(cfg, b, max_t, device=DEV)
    lg, cache, _ = block_prefill(params, cfg, cache, prompt)
    toks = []
    for i in range(steps):
        if i:
            lg, cache = decode_step(params, cfg, cache, t0 + i - 1, toks[-1])
        logits[i].copy_(lg)
        toks.append(lg.argmax(-1).to(prompt.dtype))
    out = torch.cat([prompt, torch.stack(toks, 1)], 1)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start, logits


def _profile_decode(params, cfg, prompt, max_t, wall_step) -> float:
    """Device time by kernel over PROFILED_DECODE_STEPS decode steps from
    position t0 (the prefill outside the profile): issued eagerly by
    ``decode_step``, then as replays of ``generate``'s captured step over
    the same slots; the two device-busy times must agree. Returns the
    eager steps' device-busy ms per step."""
    b, t0 = prompt.shape
    n = PROFILED_DECODE_STEPS
    cache = init_kv_cache(cfg, b, max_t, device=DEV)
    logits, cache, _ = block_prefill(params, cfg, cache, prompt)
    tok = logits.argmax(-1).to(torch.int32)

    def steps():
        for i in range(n):
            decode_step(params, cfg, cache, t0 + i, tok)

    eager = _profile_step(steps, 1e3 * wall_step * n, DECODE_KERNEL_GROUPS,
                          f"{n} decode steps from position {t0}, eager")
    out = torch.zeros((b, t0 + n + 3), dtype=torch.int32, device=DEV)
    out[:, t0] = tok
    pos = torch.zeros((), dtype=torch.int32, device=DEV)
    step = StepGraph(_step_body(params, cfg, cache, out, pos,
                                lambda lg: lg.argmax(-1).to(torch.int32)),
                     DEV)
    pos.fill_(t0)
    step()                                   # warm-up
    step()                                   # capture and first replay
    pos.fill_(t0)

    def replays():
        for _ in range(n):
            step()

    graphed = _profile_step(replays, 1e3 * wall_step * n,
                            DECODE_KERNEL_GROUPS,
                            f"{n} decode steps from position {t0}, replays "
                            f"of the captured step")
    ratio = graphed / eager if eager and graphed else float("nan")
    print(f"  replayed over eager device-busy time: {ratio:.4f} "
          f"(allowed {DEVICE_STEP_RATIO})")
    if not DEVICE_STEP_RATIO[0] <= ratio <= DEVICE_STEP_RATIO[1]:
        raise AssertionError("the profiler does not see the replayed "
                             "steps' kernels as it sees the eager ones")
    return eager / n


def full_width_generation_phase(card: str) -> int:
    """Returns B5's launches over one long-chain bf16 generate call."""
    run = GEN_FULL_RUN
    short, long_ = run["gen_short"], run["gen_long"]
    b, t0 = run["b"], run["prompt_len"]
    bf16_launches = None
    for name, (kv_int8, int8_weights) in GEN_FULL_VARIANTS.items():
        cfg = replace(GEN_FULL, kv_int8=kv_int8)
        t_start = time.perf_counter()
        r = decode_tokens_per_sec(cfg=cfg, quantized=int8_weights,
                                  device=DEV, **run)
        # the same params and prompt as the benchmark's (seeds 0 and 1),
        # for two untraced chains: the wall rate, the idle share, and
        # B5's launches over one long-chain generate call
        params = init_params(cfg, 0, device=DEV)
        if int8_weights:
            params = quantize_params(params)
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (b, t0), generator=gen,
                               dtype=torch.int32).to(DEV)
        walls, outs = {}, {}
        for n in (short, long_):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            da.flash_decode_attention.launches = 0
            StepGraph.captures, StepGraph.capture_seconds = 0, 0.0
            start = time.perf_counter()
            with no_device_waits():
                outs[n] = generate(params, cfg, prompt, steps=n,
                                   max_t=t0 + long_)
            torch.cuda.synchronize()
            walls[n] = time.perf_counter() - start
            launches = da.flash_decode_attention.launches
            captures, capture_s = StepGraph.captures, StepGraph.capture_seconds
        peak = torch.cuda.max_memory_allocated()
        wall_step = (walls[long_] - walls[short]) / (long_ - short)
        dev_step = r["decode_step_ms"] / 1e3
        idle = 1.0 - dev_step * long_ / walls[long_]
        out = outs[long_]
        expect = cfg.n_layers * (long_ - 1)
        n_eager = long_ if name == "bf16" else EAGER_CHECK_STEPS
        eager, eager_wall, eager_logits = _eager_chain(params, cfg, prompt,
                                                       n_eager, t0 + long_)
        parts = _partings(out[:, t0:t0 + n_eager].cpu(), eager[:, t0:].cpu(),
                          eager_logits)
        del eager_logits
        print(f"{card}, {name}: {r['decode_tokens_per_sec']:.1f} tokens/s by "
              f"device time ({r['decode_step_ms']:.3f} ms/step, the long "
              f"chain's device-busy time over its {long_} steps), "
              f"{b / wall_step:.1f} tokens/s wall ({1e3 * wall_step:.3f} "
              f"ms/step, marginal between {short} and {long_} steps); long "
              f"chain {walls[long_]:.3f} s wall, card idle "
              f"{100 * idle:.1f}% of it; {captures} CUDA graph captured in "
              f"{1e3 * capture_s:.1f} ms per call, apart from the steps, "
              f"under sync-debug mode with its replays (no host wait); "
              f"params {r['param_mib']:.1f} MiB; peak memory "
              f"{peak / 2**30:.2f} GiB; B5 launches {launches}, counted per "
              f"replay (expected {expect}); {time.perf_counter() - t_start:.1f} s")
        print(f"  the long chain's first {n_eager} steps by the eager step, "
              f"issued from the host: {eager_wall:.3f} s wall, "
              f"{1e3 * eager_wall / n_eager:.3f} ms/step, prefill included; the eager loop's figures "
              f"(PERF.md): {EAGER_LOOP}; replayed tokens equal to the eager ones: "
              f"{not parts}"
              + "".join(f"; row {r_} parts at step {j} ({sl:.2e} of the "
                        f"largest |logit| below the eager top)"
                        for r_, j, sl in parts))
        if out.shape != (b, t0 + long_) or not bool(
                ((out >= 0) & (out < cfg.vocab)).all()):
            raise AssertionError(f"{name}: malformed generation output")
        if not torch.equal(outs[short], out[:, :t0 + short]):
            raise AssertionError(f"{name}: the short chain's tokens are not "
                                 f"a prefix of the long chain's")
        if any(sl > TOL_TIE_REL for _, _, sl in parts):
            raise AssertionError(f"{name}: the replayed chain parts from the "
                                 f"eager one where no near-tie is")
        if launches != expect or captures != 1:
            raise AssertionError(f"{name}: B5 launched {launches} times per "
                                 f"generate call, expected {expect}, or "
                                 f"{captures} captures, expected 1")
        if bf16_launches is None:
            bf16_launches = launches
            eager_ms = _profile_decode(params, cfg, prompt, t0 + long_,
                                       wall_step)
            ratio = r["decode_step_ms"] / eager_ms
            print(f"  the replayed long chain's device ms/step over the "
                  f"eager steps': {ratio:.4f} (allowed {DEVICE_STEP_RATIO})")
            if not DEVICE_STEP_RATIO[0] <= ratio <= DEVICE_STEP_RATIO[1]:
                raise AssertionError("the device-time rate of the replayed "
                                     "chain does not match the eager steps")
        del params, outs, out, eager
        torch.cuda.empty_cache()
    return bf16_launches


def small_training_phase() -> None:
    rng = np.random.RandomState(5)
    b, t = SMALL_TRAIN_BATCH
    batch = tuple(torch.from_numpy(rng.randint(0, SMALL_TRAIN.vocab, (b, t))
                                   .astype(np.int32)) for _ in range(2))
    wrappers = _flash_wrappers()
    results = {}
    for dev in (DEV, "cpu"):
        params = init_params(SMALL_TRAIN, 0, device=dev)
        step, init = tt.make_train_step(
            SMALL_TRAIN, optimizer=tt.default_optimizer(warmup_steps=1),
            attn_fn=fa.flash_attention)
        state = init(params)
        on_dev = tuple(x.to(dev) for x in batch)
        for w in wrappers.values():
            w.launches = 0
        losses = [step(params, state, on_dev)[2].item() for _ in range(3)]
        counts = {n: w.launches for n, w in wrappers.items()}
        results[dev] = (losses, [x.detach().cpu()
                                 for x in tt._param_leaves(params)], counts)
    (card, card_p, counts), (cpu, cpu_p, _) = results[DEV], results["cpu"]
    expect = SMALL_TRAIN.n_layers * 3          # no remat: once per layer
    print(f"losses card {card}, cpu {cpu}; card launches {counts}")
    if counts != {n: expect for n in wrappers}:
        raise AssertionError(f"card steps launched {counts}, expected "
                             f"{expect} of each flash kernel")
    if not all(math.isfinite(x) for x in card) or any(
            abs(a - c) > TOL_TRAIN_LOSS_REL * abs(c)
            for a, c in zip(card, cpu)):
        raise AssertionError("card and CPU training losses disagree")
    lr_max = tt.default_optimizer(warmup_steps=1).learning_rate(1)
    worst, beyond, total = 0.0, 0, 0
    for a, c in zip(card_p, cpu_p):
        diff = (a - c).abs()
        worst = max(worst, diff.max().item())
        beyond += int((diff > TOL_TRAIN_PARAM).sum())
        total += diff.numel()
    print(f"params after 3 steps: max |card - cpu| {worst:.2e}, "
          f"{beyond} of {total} beyond {TOL_TRAIN_PARAM:.0e}")
    if worst > 2 * 3 * lr_max or beyond > 1e-2 * total:
        raise AssertionError("card and CPU params disagree after 3 steps")
    # the entry point: the same seeded loss on the card and on the CPU
    fn, args = entry.entry(device=DEV)
    got = fn(*args).item()
    fn, args = entry.entry(device="cpu")
    want = fn(*args).item()
    print(f"entry() loss card {got:.6f}, cpu {want:.6f}")
    if not abs(got - want) <= 2 ** -7 * abs(want):
        raise AssertionError("entry() loss differs between card and CPU")


def _fresh(node, dev, dtype=None):
    """A copy of a params subtree on ``dev`` (every leaf cast to
    ``dtype`` when one is given) whose leaves require grad."""
    if isinstance(node, dict):
        return {k: _fresh(v, dev, dtype) for k, v in node.items()}
    x = node.detach().to(dev)
    return (x if dtype is None else x.to(dtype)).clone().requires_grad_()


def _block_check(layer) -> None:
    """One full-width block at b=1, loss mean(block(x)^2), in bf16 on the
    card and on the CPU and in f32 on the CPU. The loss and every
    gradient (x's and the layer's) are held row by row against the f32
    run, the bf16 CPU run setting each row's allowance
    (:func:`_allowance`)."""
    t, d = FULL_TRAIN_BATCH[1], FULL_TRAIN.d_model
    block = tt._make_block(FULL_TRAIN, fa.flash_attention)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, t, d), generator=gen).to(FULL_TRAIN.dtype)
    results = {}
    for run, dev, dtype in (("card", DEV, None), ("cpu", "cpu", None),
                            ("f32", "cpu", torch.float32)):
        t0 = time.perf_counter()
        lay = _fresh(layer, dev, dtype)
        xx = x.to(dev, dtype or x.dtype).requires_grad_()
        loss = block(xx, lay).float().square().mean()
        leaves = [xx] + tt._param_leaves(lay)
        grads = torch.autograd.grad(loss, leaves)
        results[run] = [loss.detach().float().cpu()] + [
            g.float().cpu() for g in grads]
        print(f"  block {run} on {dev}: {time.perf_counter() - t0:.1f} s")
    names = ["loss", "x", "ln1.g", "wqkv", "wo", "ln2.g", "w_up", "w_down"]
    finite = all(torch.isfinite(a).all() for a in results["card"])
    print(f"one block, b=1, bf16: worst row vs f32 on the CPU relative to "
          f"the row's largest value (card, cpu); card's worst error over "
          f"its allowance (<= 1 passes); finite {finite}")
    bad = []
    for n, a, c, ref in zip(names, results["card"], results["cpu"],
                            results["f32"]):
        got = _bf16_reading(a, c, ref)
        print(f"  {n}: {got['kernel']:.3e}, {got['plain']:.3e}; "
              f"{got['over']:.3f}")
        if not got["over"] <= 1.0:
            bad.append(n)
    if not finite or bad:
        raise AssertionError(f"full-width block: the card's bf16 run is "
                             f"off the f32 reference in {bad}")


# kernel-name fragments -> the part of the training step they belong to
KERNEL_GROUPS = (
    ("flash forward (B1)", ("flash_fwd_kernel",)),
    ("flash dq (B2)", ("flash_bwd_dq_kernel",)),
    ("flash dk/dv (B3)", ("flash_bwd_dkv_kernel",)),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)
# ... and of the serving engine's run
SERVING_KERNEL_GROUPS = (
    ("paged decode (B4)", ("paged_decode",)),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)
OTHER_KERNELS = "other (elementwise, reductions, copies)"
# ... and of a decode step
DECODE_KERNEL_GROUPS = (
    ("flash decode (B5)", ("flash_decode_split", "flash_decode_merge")),
    ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)


def _device_split(run, groups):
    """One more ``run()`` under ``torch.profiler``: (device-busy ms (the
    sum of the kernels' own times), {group: ms} by kernel-name fragments
    in ``groups`` (everything else is elementwise, reductions and
    copies), [(kernel name, ms, count)]), or None when the profiler
    recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return None
    shares = {name: 0.0 for name, _ in groups}
    shares[OTHER_KERNELS] = 0.0
    for key, ms, _ in kernels:
        low = key.lower()
        name = next((g for g, frags in groups
                     if any(f in low for f in frags)), OTHER_KERNELS)
        shares[name] += ms
    return sum(ms for _, ms, _ in kernels), shares, kernels


def _profile_step(run_step, step_ms: float, groups=KERNEL_GROUPS,
                  what: str = "step") -> Optional[float]:
    """Device time by kernel over one more run of ``run_step`` (a
    training step, or ``what``) under ``torch.profiler``, grouped as in
    ``groups``, against its timed wall time ``step_ms``; returns the
    device-busy ms (None when the profiler recorded none)."""
    split = _device_split(run_step, groups)
    if split is None:
        print("profiled step: the profiler recorded no device time "
              "(breakdown not measured)")
        return None
    busy, shares, kernels = split
    print(f"profiled {what}: {len(kernels)} kernel names, device busy "
          f"{busy:.2f} ms against the timed {step_ms:.2f} ms")
    for name, ms in shares.items():
        print(f"  {name}: {ms:.2f} ms ({100 * ms / busy:.1f}% of busy)")
    for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    return busy


def full_width_training_phase(card: str, flash: dict) -> dict:
    t0 = time.perf_counter()
    params = init_params(FULL_TRAIN, 0, device=DEV)
    n_params = tt.param_count(params)
    b, t = FULL_TRAIN_BATCH
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, FULL_TRAIN.vocab, (b, t), generator=gen,
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)       # as the reference's training benchmark
    step, init = tt.make_train_step(FULL_TRAIN,
                                    optimizer=tt.default_optimizer(),
                                    attn_fn=fa.flash_attention)
    state = init(params)
    print(f"{n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)    # untimed
    first = loss.item()
    print(f"untimed first step {time.perf_counter() - t0:.2f} s, loss "
          f"{first:.4f}")

    wrappers = _flash_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = []
    for _ in range(TIMED_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    losses = [x.item() for x in losses]
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    flops_per_token = 6 * n_params + 6 * FULL_TRAIN.n_layers * t \
        * FULL_TRAIN.d_model
    print(f"{card}: {TIMED_STEPS} steps of {b}x{t}: {step_ms:.2f} ms/step "
          f"(device events; wall {1e3 * wall / TIMED_STEPS:.2f} ms/step), "
          f"{b * t / step_ms * 1e3:.1f} tokens/s, "
          f"{b * t * flops_per_token / step_ms / 1e9:.1f} model TFLOP/s "
          f"(6N + attention per token), peak memory {peak / 2**30:.2f} GiB; "
          f"losses {losses}")
    for name, _ in FLASH_KERNELS:
        per_step = launches[name] / TIMED_STEPS
        share = per_step * flash[name]["ms"] / step_ms
        print(f"  {name}: {launches[name]} launches ({per_step:g} per "
              f"step) x {flash[name]['ms']:.3f} ms = {100 * share:.1f}% of "
              f"the step")
    n_l = FULL_TRAIN.n_layers * TIMED_STEPS
    # the forward runs once per layer, and again when the backward
    # recomputes the checkpointed block (the kernel is opaque to the
    # selective policy, so its outputs are not saved)
    expect = {"flash_forward": 2 * n_l, "flash_backward_dq": n_l,
              "flash_backward_dkv": n_l}
    if launches != expect:
        raise AssertionError(f"flash kernels launched {launches}, expected "
                             f"{expect}")
    lo, hi = FIRST_LOSS_RANGE
    if not all(math.isfinite(x) for x in [first] + losses) \
            or not lo <= first <= hi:
        raise AssertionError(f"full-width losses {[first] + losses}: not "
                             f"finite, or the first outside [{lo}, {hi}]")
    _profile_step(lambda: step(params, state, batch), step_ms)
    layer = tt.unstack_layer_params(params)["layers"][0]
    del state
    torch.cuda.empty_cache()
    _block_check(layer)
    return launches


def _on(node, dev):
    """A detached copy of a params tree on ``dev``."""
    if isinstance(node, dict):
        return {k: _on(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_on(v, dev) for v in node]
    return node.detach().to(dev)


# ------------------------------------------- MoE, Adafactor, LoRA and MLM

def _loss_and_grads(params, loss_of):
    """(loss, gradients of every leaf of ``params``) of ``loss_of(params)``."""
    leaves = [x.requires_grad_() for x in tt._param_leaves(params)]
    loss = loss_of(params)
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


def _check_grads(label, card, cpu) -> None:
    """The loss within TOL_TRAIN_LOSS_REL and each gradient within
    TOL_GRAD_REL of its leaf's largest |value|, card against CPU."""
    loss_rel = abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item())
    worst = max(((a.float().cpu() - c.float()).abs().max()
                 / c.float().abs().max().clamp_min(1e-30)).item()
                for a, c in zip(card[1:], cpu[1:]))
    print(f"  {label}: loss card {card[0].item():.6f}, cpu "
          f"{cpu[0].item():.6f}; gradients, worst |card - cpu| over the "
          f"leaf's largest {worst:.2e} (tolerance {TOL_GRAD_REL:.0e})")
    if not loss_rel <= TOL_TRAIN_LOSS_REL or not worst <= TOL_GRAD_REL:
        raise AssertionError(f"{label}: card and CPU losses or gradients "
                             f"disagree")


def _check_steps(label, card, cpu) -> None:
    """Training steps, card against CPU: each loss within
    TOL_TRAIN_LOSS_REL; each leaf after the steps within 1% of that
    leaf's largest move on the CPU for all but 1% of its elements, and
    within twice that move everywhere (an element whose gradient is near
    zero may step either way, as Adam and Adafactor divide it by its own
    RMS)."""
    (c_losses, c_start, c_end), (p_losses, p_start, p_end) = card, cpu
    c_losses, p_losses = c_losses.cpu().tolist(), p_losses.tolist()
    worst, beyond, total = 0.0, 0, 0
    for a, p, p0 in zip(c_end, p_end, p_start):
        diff = (a.detach().float().cpu() - p.detach().float()).abs()
        move = (p.detach().float() - p0.float()).abs().max().item()
        worst = max(worst, diff.max().item() / max(move, 1e-30))
        beyond += int((diff > 1e-2 * move).sum())
        total += diff.numel()
    print(f"  {label}: losses card {c_losses}, cpu {p_losses}; after the "
          f"steps, worst |card - cpu| over the leaf's largest move "
          f"{worst:.3f}, {beyond} of {total} elements beyond 1% of it")
    if any(abs(a - c) > TOL_TRAIN_LOSS_REL * abs(c)
           for a, c in zip(c_losses, p_losses)) \
            or worst > 2.0 or beyond > 1e-2 * total:
        raise AssertionError(f"{label}: card and CPU steps disagree")


def _small_moe_lora_mlm(dev, batch, corruption) -> dict:
    """Phase 12's runs on ``dev`` from seeded params."""
    on = tuple(x.to(dev) for x in batch)
    out = {}
    for name, cfg in (("top-2 MoE", SMALL_MOE),
                      ("dense MoE", replace(SMALL_MOE, moe_top_k=0))):
        out[name] = _loss_and_grads(
            init_params(cfg, 0, device=dev),
            lambda p, cfg=cfg: tt.loss_fn(p, on, cfg, fa.flash_attention))
    # three Adafactor steps of the top-2 model (the first at rate 0)
    params = init_params(SMALL_MOE, 0, device=dev)
    step, init = tt.make_train_step(
        SMALL_MOE, optimizer=tt.default_optimizer(kind="adafactor",
                                                  warmup_steps=1),
        attn_fn=fa.flash_attention)
    state = init(params)
    start = [x.detach().clone() for x in state.leaves]
    losses = torch.stack([step(params, state, on)[2] for _ in range(3)])
    out["Adafactor"] = (losses, start, state.leaves)
    # three AdamW steps of rank-4 f32 adapters on the dense base
    base = init_params(SMALL_TRAIN, 0, device=dev)
    frozen = [x.clone() for x in tt._param_leaves(base)]
    adapters = lora.init_lora(base, SMALL_LORA_RANK, 1, dtype=torch.float32)
    step, init = lora.make_lora_train_step(SMALL_TRAIN,
                                           attn_fn=fa.flash_attention)
    state = init(adapters)
    start = [x.detach().clone() for x in state.leaves]
    losses = torch.stack([step(base, adapters, state, on)[2]
                          for _ in range(3)])
    out["LoRA"] = (losses, start, state.leaves)
    out["base unchanged"] = all(
        torch.equal(a, b) for a, b in zip(frozen, tt._param_leaves(base)))
    # the encoder's loss and gradients given one corruption
    corrupted, selected = (x.to(dev) for x in corruption)
    out["MLM"] = _loss_and_grads(
        init_params(enc.encoder_config(SMALL_TRAIN), 0, device=dev),
        lambda p: enc._mlm_loss(p, on[0], corrupted, selected,
                                enc.encoder_config(SMALL_TRAIN),
                                fa.flash_attention))
    return out


def small_moe_lora_mlm_phase(card: str) -> None:
    print(f"{card}: fp32, the card's runs against the CPU's from one seed")
    rng = np.random.RandomState(7)
    b, t = SMALL_TRAIN_BATCH
    # token ids below vocab - 1, the [MASK] id
    batch = tuple(torch.from_numpy(
        rng.randint(0, SMALL_TRAIN.vocab - 1, (b, t)).astype(np.int32))
        for _ in range(2))
    corruption = enc.mlm_corrupt(batch[0], torch.Generator().manual_seed(3),
                                 SMALL_TRAIN.vocab)
    wrappers = _flash_wrappers()
    for w in wrappers.values():
        w.launches = 0
    card = _small_moe_lora_mlm(DEV, batch, corruption)
    counts = {n: w.launches for n, w in wrappers.items()}
    cpu = _small_moe_lora_mlm("cpu", batch, corruption)
    for name in ("top-2 MoE", "dense MoE", "MLM"):
        _check_grads(name, card[name], cpu[name])
    for name in ("Adafactor", "LoRA"):
        _check_steps(name, card[name], cpu[name])
    # nine forwards and backwards of two layers, no remat
    expect = 9 * SMALL_TRAIN.n_layers
    print(f"  LoRA base bit-identical after the steps: card "
          f"{card['base unchanged']}, cpu {cpu['base unchanged']}; card "
          f"flash launches {counts} (expected {expect} each)")
    if not (card["base unchanged"] and cpu["base unchanged"]):
        raise AssertionError("LoRA steps changed the frozen base")
    if counts != {n: expect for n in wrappers}:
        raise AssertionError(f"card runs launched {counts}, expected "
                             f"{expect} of each flash kernel")

    # the MLM step on the card draws its corruption there, from a CUDA
    # generator, without a host wait
    params = init_params(enc.encoder_config(SMALL_TRAIN), 0, device=DEV)
    step, init = enc.make_mlm_train_step(SMALL_TRAIN,
                                         attn_fn=fa.flash_attention)
    state = init(params)
    tokens = batch[0].to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    with no_device_waits():
        _, selected = enc.mlm_corrupt(tokens, gen, SMALL_TRAIN.vocab)
    share = selected.float().mean().item()
    losses = [step(params, state, tokens, gen)[2].item() for _ in range(2)]
    print(f"  MLM steps on the card, corruption from a CUDA generator (no "
          f"host wait): losses {losses}, selected share {share:.3f}")
    if not all(math.isfinite(x) for x in losses) or not 0.1 < share < 0.2:
        raise AssertionError("MLM steps on the card went wrong")

    # the MoE engine (its decode chunks replayed) and MoE generation, with
    # float and int8 expert banks: the card's greedy tokens are the CPU's
    rng = np.random.RandomState(8)
    prompts = [[int(x) for x in rng.randint(0, SMALL.vocab, 6)]
               for _ in range(16)]
    outs = {dev: ServingEngine(init_params(SMALL_MOE_GEN, 0, device=dev),
                               SMALL_MOE_GEN, device=dev,
                               **SMALL_ENGINE).run(prompts, 8)
            for dev in (DEV, "cpu")}
    print(f"  MoE engine, 16 requests x 8 tokens: card tokens == cpu "
          f"tokens: {outs[DEV] == outs['cpu']}")
    if outs[DEV] != outs["cpu"]:
        raise AssertionError("MoE engine: card and CPU tokens differ")
    prompt = torch.from_numpy(
        rng.randint(0, SMALL.vocab, (2, 16)).astype(np.int32))
    steps = 24
    for name, cfg, int8 in (
            ("top-2", SMALL_MOE_GEN, False),
            ("dense, int8", replace(SMALL_MOE_GEN, moe_top_k=0), True)):
        toks = {}
        for dev in ("cpu", DEV):
            params = init_params(cfg, 0, device=dev)
            if int8:
                params = quantize_params(params)
            on_dev = prompt.to(dev)
            da.flash_decode_attention.launches = 0
            with no_device_waits():
                out = generate(params, cfg, on_dev, steps=steps)
            launches = da.flash_decode_attention.launches
            toks[dev] = out.cpu()
        expect = cfg.n_layers * (steps - 1)
        same = torch.equal(toks[DEV], toks["cpu"])
        print(f"  MoE generate ({name}): {steps} greedy tokens card == cpu: "
              f"{same}, no host wait; B5 launches on the card {launches} "
              f"(expected {expect})")
        if not same or launches != expect:
            raise AssertionError(f"MoE generation ({name}): card and CPU "
                                 f"disagree")


def _timed_steps(run_step, n: int = TIMED_STEPS):
    """``n`` calls of ``run_step`` (returning a detached loss) between
    CUDA events, with the flash kernels' launches counted from zero and
    the peak memory reset: (ms per step, losses, launches, peak bytes)."""
    wrappers = _flash_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [run_step() for _ in range(n)]
    end.record()
    end.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    return (start.elapsed_time(end) / n, [x.item() for x in losses],
            launches, torch.cuda.max_memory_allocated())


def _check_flash_launches(launches, cfg, label) -> None:
    """B1 twice per layer and step under remat (the recompute), B2 and
    B3 once, over TIMED_STEPS steps."""
    n_l = cfg.n_layers * TIMED_STEPS
    expect = {"flash_forward": 2 * n_l, "flash_backward_dq": n_l,
              "flash_backward_dkv": n_l}
    if launches != expect:
        raise AssertionError(f"{label}: flash kernels launched {launches}, "
                             f"expected {expect}")


def _check_losses(first, losses, label) -> None:
    lo, hi = FIRST_LOSS_RANGE
    if not all(math.isfinite(x) for x in [first] + losses) \
            or not lo <= first <= hi:
        raise AssertionError(f"{label}: losses {[first] + losses} not "
                             f"finite, or the first outside [{lo}, {hi}]")


def full_width_mlm_phase(card: str) -> dict:
    """B1-B3 at the bidirectional full-width shape (prefix = t, every
    pair visible), then three timed MLM steps of the encoder. Returns the
    kernels' readings at that shape."""
    gen = torch.Generator().manual_seed(8)
    b, h, h_kv, t, d = FLASH_FULL
    print(f"{card}: B1-B3 at the full-width shape, every pair visible")
    _flash_bf16_case("bidirectional_full_width", (b, h, h_kv, t, t, d),
                     {"prefix": t}, gen)
    torch.cuda.empty_cache()
    bidir = _flash_full_width(gen, {"prefix": t})
    for name, r in bidir.items():
        print(f"{card}: {name}, bidirectional: {r['ms']:.4f} ms, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of its "
              f"{r['bound_ms']:.4f} ms bound")
    torch.cuda.empty_cache()

    cfg = enc.encoder_config(FULL_TRAIN)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=DEV)
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab - 1, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    step, init = enc.make_mlm_train_step(FULL_TRAIN,
                                         attn_fn=fa.flash_attention)
    state = init(params)
    cgen = torch.Generator(device=DEV).manual_seed(0)
    first = step(params, state, tokens, cgen)[2].item()
    print(f"{tt.param_count(params) / 1e6:.1f}M params, encoder prefix "
          f"{cfg.prefix}; untimed first step and set-up "
          f"{time.perf_counter() - t0:.1f} s, loss {first:.4f}")
    step_ms, losses, launches, peak = _timed_steps(
        lambda: step(params, state, tokens, cgen)[2])
    print(f"{card}: MLM, {TIMED_STEPS} steps of {b}x{t} (15% of positions "
          f"corrupted on the card each step): {step_ms:.2f} ms/step, "
          f"{b * t / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses}; flash launches "
          f"{launches}")
    _check_flash_launches(launches, FULL_TRAIN, "MLM")
    _check_losses(first, losses, "MLM")
    return bidir


def full_width_lora_phase(card: str) -> None:
    t0 = time.perf_counter()
    base = init_params(FULL_TRAIN, 0, device=DEV)
    adapters = lora.init_lora(base, LORA_RANK, 2)
    counts = lora.lora_param_counts(base, adapters)
    frozen = [x.clone() for x in tt._param_leaves(base)]
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, FULL_TRAIN.vocab, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)
    step, init = lora.make_lora_train_step(FULL_TRAIN,
                                           attn_fn=fa.flash_attention)
    state = init(adapters)
    first = step(base, adapters, state, batch)[2].item()
    print(f"base {counts['base'] / 1e6:.1f}M params, rank-{LORA_RANK} bf16 "
          f"adapters on wqkv and wo {counts['adapters'] / 1e6:.3f}M; "
          f"untimed first step and set-up {time.perf_counter() - t0:.1f} s, "
          f"loss {first:.4f}")
    step_ms, losses, launches, peak = _timed_steps(
        lambda: step(base, adapters, state, batch)[2])
    same = all(torch.equal(a, b)
               for a, b in zip(frozen, tt._param_leaves(base)))
    print(f"{card}: LoRA, {TIMED_STEPS} steps of {b}x{t}: {step_ms:.2f} "
          f"ms/step, {b * t / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses}; flash launches "
          f"{launches}; base bit-identical after the steps: {same}")
    _check_flash_launches(launches, FULL_TRAIN, "LoRA")
    _check_losses(first, losses, "LoRA")
    if not same:
        raise AssertionError("full-width LoRA steps changed the base")


def full_width_moe_generation_phase(card: str):
    """The generation cell with 8 experts, top-2, bf16: the short and
    long chains as replays (wall rate, idle share, capture time, B5
    launches), the long chain's device time, and the long chain's first
    EAGER_CHECK_STEPS steps by the eager step (tokens equal, or parting
    at a near-tie). Returns the
    params, which the MoE training phase reuses."""
    cfg = FULL_MOE_GEN
    run = GEN_FULL_RUN
    short, long_ = run["gen_short"], run["gen_long"]
    b, t0 = run["b"], run["prompt_len"]
    max_t = t0 + long_
    start = time.perf_counter()
    params = init_params(cfg, 0, device=DEV)
    n_params = tt.param_count(params)
    prompt = torch.randint(0, cfg.vocab, (b, t0),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    print(f"{n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - start:.1f} s")
    generate(params, cfg, prompt, steps=short, max_t=max_t)   # set-up
    walls, outs = {}, {}
    for n in (short, long_):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.flash_decode_attention.launches = 0
        StepGraph.captures, StepGraph.capture_seconds = 0, 0.0
        t_call = time.perf_counter()
        with no_device_waits():
            outs[n] = generate(params, cfg, prompt, steps=n, max_t=max_t)
        torch.cuda.synchronize()
        walls[n] = time.perf_counter() - t_call
        launches = da.flash_decode_attention.launches
        captures, capture_s = StepGraph.captures, StepGraph.capture_seconds
    peak = torch.cuda.max_memory_allocated()
    wall_step = (walls[long_] - walls[short]) / (long_ - short)
    dev_step = timing.device_seconds_per_step(
        lambda: generate(params, cfg, prompt, steps=long_, max_t=max_t),
        long_)
    out = outs[long_]
    expect = cfg.n_layers * (long_ - 1)
    n_eager = EAGER_CHECK_STEPS
    eager, eager_wall, eager_logits = _eager_chain(params, cfg, prompt,
                                                   n_eager, max_t)
    parts = _partings(out[:, t0:t0 + n_eager].cpu(), eager[:, t0:].cpu(),
                      eager_logits)
    del eager_logits
    if dev_step is None:
        device = "device time not measured (the profiler saw no kernel)"
    else:
        device = (f"{1e3 * dev_step:.3f} ms/step by device time (the long "
                  f"chain's device-busy time over its {long_} steps), card "
                  f"idle {100 * (1 - dev_step * long_ / walls[long_]):.1f}% "
                  f"of the long chain")
    print(f"{card}, MoE 8 experts top-2, bf16: {b / wall_step:.1f} tokens/s "
          f"wall ({1e3 * wall_step:.3f} ms/step, marginal between {short} "
          f"and {long_} steps); {device}; long chain {walls[long_]:.3f} s "
          f"wall; {captures} CUDA graph captured in {1e3 * capture_s:.1f} "
          f"ms per call, apart from the steps; peak memory "
          f"{peak / 2**30:.2f} GiB; B5 launches {launches} per call, counted "
          f"per replay (expected {expect})")
    print(f"  the long chain's first {n_eager} steps by the eager step: "
          f"{eager_wall:.3f} s wall, {1e3 * eager_wall / n_eager:.3f} "
          f"ms/step, prefill included; "
          f"replayed tokens equal to the eager ones: {not parts}"
          + "".join(f"; row {r_} parts at step {j} ({sl:.2e} of the largest "
                    f"|logit| below the eager top)" for r_, j, sl in parts))
    if out.shape != (b, t0 + long_) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError("MoE generation: malformed output")
    if not torch.equal(outs[short], out[:, :t0 + short]):
        raise AssertionError("MoE generation: the short chain's tokens are "
                             "not a prefix of the long chain's")
    if any(sl > TOL_TIE_REL for _, _, sl in parts):
        raise AssertionError("MoE generation: the replayed chain parts from "
                             "the eager one where no near-tie is")
    if launches != expect or captures != 1:
        raise AssertionError(f"MoE generation: B5 launched {launches} times "
                             f"per call, expected {expect}, or {captures} "
                             f"captures, expected 1")
    del outs, out, eager
    torch.cuda.empty_cache()
    return params


def _ranged(name, fn):
    """``fn`` run inside a ``torch.profiler`` range called ``name``."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _moe_split(events, d_ff) -> dict:
    """Device ms of a profiled MoE training step by part. A kernel is
    charged to the launching op's innermost range among the MoE FFN
    (forward and its recompute), the rest of the block and the
    optimizer, or, in the backward, to the forward op it differentiates
    (matched by sequence number to the ops run inside the MoE range).
    Products whose operands have a d_ff dim are the experts'; the MoE's
    other products are the router and the dispatch and combine."""
    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    moe_seq = {e.sequence_nr for e in events if e.sequence_nr >= 0
               and any(a.name == MOE_RANGE for a in chain(e.cpu_parent))}

    def part(e):
        for a in chain(e):
            if a.name in (MOE_RANGE, BLOCK_RANGE, OPT_RANGE):
                return a.name
            if a.name.startswith("autograd::engine::evaluate_function"):
                return MOE_RANGE if a.sequence_nr in moe_seq else None
        return None

    split = {g: 0.0 for g in (
        "flash (B1-B3)", "matrix products outside the MoE (cuBLAS)",
        "MoE expert products (cuBLAS)",
        "MoE router, dispatch and combine products (cuBLAS)",
        "MoE routing, one-hots, GELU, casts (elementwise)",
        "optimizer: clip and Adafactor",
        "other: norms, RoPE, loss, casts, copies")}
    for e in events:
        if not e.kernels:
            continue
        where = part(e)
        expert = any(isinstance(s, list) and d_ff in s
                     for s in e.input_shapes or ())
        for k in e.kernels:
            name = k.name.lower()
            if "flash_fwd" in name or "flash_bwd" in name:
                g = "flash (B1-B3)"
            elif where == OPT_RANGE:
                g = "optimizer: clip and Adafactor"
            elif any(f in name for f in GEMM_NAMES):
                g = ("matrix products outside the MoE (cuBLAS)"
                     if where != MOE_RANGE else
                     "MoE expert products (cuBLAS)" if expert else
                     "MoE router, dispatch and combine products (cuBLAS)")
            elif where == MOE_RANGE:
                g = "MoE routing, one-hots, GELU, casts (elementwise)"
            else:
                g = "other: norms, RoPE, loss, casts, copies"
            split[g] += k.duration / 1e3
    return split


def _profile_moe_step(run_step, state, step_ms: float, card: str) -> None:
    """One more MoE training step under ``torch.profiler``, its device
    time split by :func:`_moe_split`."""
    from torch.profiler import ProfilerActivity, profile

    patched = {"_moe_topk": tt._moe_topk, "_make_block": tt._make_block}
    tt._moe_topk = _ranged(MOE_RANGE, tt._moe_topk)
    make_block = patched["_make_block"]
    tt._make_block = lambda cfg, attn_fn: _ranged(
        BLOCK_RANGE, make_block(cfg, attn_fn))
    state.apply = _ranged(OPT_RANGE, state.apply)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run_step()
            torch.cuda.synchronize()
    finally:
        for name, fn in patched.items():
            setattr(tt, name, fn)
        del state.apply
    split = _moe_split(prof.events(), FULL_MOE_TRAIN.d_ff)
    busy = sum(split.values())
    if not busy:
        print("profiled MoE step: the profiler recorded no device time "
              "(split not measured)")
        return
    print(f"{card}: profiled MoE step, device busy {busy:.2f} ms against "
          f"the timed {step_ms:.2f} ms")
    for name, ms in split.items():
        print(f"  {name}: {ms:.2f} ms ({100 * ms / busy:.1f}% of busy)")


def full_width_moe_training_phase(card: str, params) -> None:
    """The training cell with 8 experts, top-2, capacity 1.25 and
    Adafactor: one untimed and three timed steps on ``params`` (the
    generation phase's, the same seed's draws) in the stacked layout."""
    cfg = FULL_MOE_TRAIN
    t0 = time.perf_counter()
    params = tt.stack_layer_params(params)
    torch.cuda.empty_cache()
    n_params = tt.param_count(params)
    banks = sum(params["layers"][k].numel() for k in ("moe_up", "moe_down"))
    active = n_params - banks + banks * cfg.moe_top_k / cfg.n_experts
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)
    step, init = tt.make_train_step(
        cfg, optimizer=tt.default_optimizer(kind="adafactor"),
        attn_fn=fa.flash_attention)
    state = init(params)
    first = step(params, state, batch)[2].item()
    capacity = max(1, int(cfg.moe_capacity_factor * cfg.moe_top_k * t
                          / cfg.n_experts))
    print(f"{n_params / 1e9:.3f}B params ({active / 1e9:.3f}B active: all "
          f"but the expert banks, plus {cfg.moe_top_k}/{cfg.n_experts} of "
          f"them), capacity {capacity} a row; untimed first step and "
          f"set-up {time.perf_counter() - t0:.1f} s, loss {first:.4f}")
    step_ms, losses, launches, peak = _timed_steps(
        lambda: step(params, state, batch)[2])
    flops_per_token = 6 * active + 6 * cfg.n_layers * t * cfg.d_model
    print(f"{card}: MoE training, {TIMED_STEPS} steps of {b}x{t} with "
          f"Adafactor: {step_ms:.2f} ms/step, {b * t / step_ms * 1e3:.1f} "
          f"tokens/s, {b * t * flops_per_token / step_ms / 1e9:.1f} model "
          f"TFLOP/s (6 x active params + 6 x layers x t x d_model a token; "
          f"the dispatch and combine products are not counted), peak "
          f"memory {peak / 2**30:.2f} GiB; losses {losses}; flash launches "
          f"{launches}")
    _check_flash_launches(launches, cfg, "MoE training")
    _check_losses(first, losses, "MoE training")
    _profile_moe_step(lambda: step(params, state, batch), state, step_ms,
                      card)


# ------------------------------------- seq2seq, beam and speculative decoding

@contextlib.contextmanager
def _rounds_without_waits():
    """Inside, every run of a speculative round's :class:`StepGraph`
    made there (the warm-up, the capture and each replay) is under
    sync-debug mode; the host's read of the counters between rounds is
    outside it. Yields the graphs' class, whose ``calls`` counts those
    runs (the rounds, one host read each) and ``captures`` and
    ``capture_seconds`` the rounds' share of :class:`StepGraph`'s."""
    class Guarded(StepGraph):
        calls, captures, capture_seconds = 0, 0, 0.0

        def __call__(self):
            Guarded.calls += 1
            n, seconds = StepGraph.captures, StepGraph.capture_seconds
            with no_device_waits():
                out = super().__call__()
            Guarded.captures += StepGraph.captures - n
            Guarded.capture_seconds += StepGraph.capture_seconds - seconds
            return out

    real = spec.StepGraph
    spec.StepGraph = Guarded
    try:
        yield Guarded
    finally:
        spec.StepGraph = real


def _small_seq2seq(card: str) -> None:
    rng = np.random.RandomState(9)
    b, t = SMALL_S2S_BATCH
    src = torch.from_numpy(
        rng.randint(1, SMALL_S2S.vocab, (b, t)).astype(np.int32))
    batch = (src, src.flip(1))
    wrappers = _flash_wrappers()
    runs = {}
    for dev in (DEV, "cpu"):
        on = tuple(x.to(dev) for x in batch)
        grads = _loss_and_grads(
            s2s.init_seq2seq_params(SMALL_S2S, 0, device=dev),
            lambda p: s2s.seq2seq_loss_fn(p, on, SMALL_S2S,
                                          fa.flash_attention))
        params = s2s.init_seq2seq_params(SMALL_S2S, 0, device=dev)
        step, init = s2s.make_seq2seq_train_step(SMALL_S2S,
                                                 attn_fn=fa.flash_attention)
        state = init(params)
        start = [x.detach().clone() for x in state.leaves]
        for w in wrappers.values():
            w.launches = 0
        losses = torch.stack([step(params, state, on)[2] for _ in range(3)])
        launches = {n: w.launches for n, w in wrappers.items()}
        runs[dev] = (grads, (losses, start, state.leaves), params, launches)
    print(f"  seq2seq ({SMALL_S2S.n_enc_layers} + {SMALL_S2S.n_dec_layers} "
          f"layers, source {t} of max_src {SMALL_S2S.max_src}), "
          f"attn_fn=flash_attention; card launches over 3 steps "
          f"{runs[DEV][3]}")
    _check_grads("seq2seq loss and gradients", runs[DEV][0], runs["cpu"][0])
    _check_steps("seq2seq, three AdamW(1e-3) steps", runs[DEV][1],
                 runs["cpu"][1])
    # each step: the encoder's layers, and the decoder's self- and
    # cross-attention
    per_step = SMALL_S2S.n_enc_layers + 2 * SMALL_S2S.n_dec_layers
    if runs[DEV][3] != {n: 3 * per_step for n in wrappers}:
        raise AssertionError(f"seq2seq steps launched {runs[DEV][3]}, "
                             f"expected {3 * per_step} of each")
    # greedy decoding from the CPU's trained params on both sides
    params = _on(runs["cpu"][2], "cpu")
    toks = {dev: s2s.greedy_decode(_on(params, dev), src.to(dev), SMALL_S2S,
                                   t, attn_fn=fa.flash_attention).cpu()
            for dev in (DEV, "cpu")}
    print(f"  greedy_decode of {t} steps, card == cpu: "
          f"{torch.equal(toks[DEV], toks['cpu'])}")
    if not torch.equal(toks[DEV], toks["cpu"]):
        raise AssertionError("seq2seq greedy tokens differ between the "
                             "card and the CPU")


def _small_beam(card: str) -> None:
    cfg, steps, beam = SMALL_BEAM, SMALL_BEAM_STEPS, 4
    prompt = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    runs = {}
    for dev in ("cpu", DEV):
        params = init_params(cfg, 0, device=dev)
        on = prompt.to(dev)
        da.flash_decode_attention.launches = 0
        StepGraph.captures = 0
        with (no_device_waits() if dev == DEV else contextlib.nullcontext()):
            seqs, scores = bm.beam_search(params, cfg, on, steps, beam,
                                          return_all=True)
        runs[dev] = (seqs.cpu(), scores.cpu(), da.flash_decode_attention
                     .launches, StepGraph.captures)
        if dev == DEV:
            rescored = torch.stack(
                [bm.sequence_logprob(params, cfg, on, seqs[:, k])
                 for k in range(beam)], 1)
            rescore_err = ((rescored - scores).abs()
                           / scores.abs()).max().item()
    (seqs, scores, launches, captures), (c_seqs, c_scores, _, _) = \
        runs[DEV], runs["cpu"]
    err = ((scores - c_scores).abs() / c_scores.abs()).max().item()
    expect = cfg.n_layers * (steps - 1)
    print(f"  beam_search (beam {beam}, {steps} steps, return_all) under "
          f"sync-debug mode: sequences card == cpu "
          f"{torch.equal(seqs, c_seqs)}, scores worst relative |card - "
          f"cpu| {err:.2e} (tolerance {TOL_BEAM_SCORE_REL:.0e}); each "
          f"score against sequence_logprob of its sequence on the card "
          f"{rescore_err:.2e} (tolerance {TOL_BEAM_RESCORE_REL:.0e}); B5 "
          f"launches {launches} (expected {expect}), {captures} graphs "
          f"captured")
    if not torch.equal(seqs, c_seqs) or not err <= TOL_BEAM_SCORE_REL \
            or not rescore_err <= TOL_BEAM_RESCORE_REL:
        raise AssertionError("beam search on the card disagrees with the "
                             "CPU or with its own re-scoring")
    if launches != expect or captures != 2:
        raise AssertionError(f"beam search launched B5 {launches} times "
                             f"(expected {expect}) in {captures} captures "
                             f"(expected 2)")


def _small_speculative(card: str) -> None:
    tcfg, dcfg = SMALL_SPEC_TARGET, SMALL_SPEC_DRAFT
    prompt = torch.from_numpy(np.random.RandomState(11).randint(
        0, tcfg.vocab, (2, 8)).astype(np.int32))
    gamma, steps = 3, 17
    runs = {}
    for dev in ("cpu", DEV):
        tp = init_params(tcfg, 0, device=dev)
        dp = init_params(dcfg, 9, device=dev)
        on = prompt.to(dev)
        want = generate(tp, tcfg, on, steps).cpu()
        da.flash_decode_attention.launches = 0
        with _rounds_without_waits():
            got, stats = spec.speculative_generate(
                tp, tcfg, dp, dcfg, on, steps, gamma, return_stats=True)
            launches = da.flash_decode_attention.launches
            self_got, self_stats = spec.self_speculative_generate(
                tp, tcfg, on, steps, gamma, return_stats=True)
        # the wide verify alone, at a device position, g = gamma + 1
        cache = init_kv_cache(tcfg, 2, 32, device=dev)
        block_prefill(tp, tcfg, cache, on)
        pos = torch.full((), prompt.shape[1], dtype=torch.int32, device=dev)
        wide, _ = wide_step(tp, tcfg, cache, pos, on[:, :gamma + 1])
        runs[dev] = (want, got.cpu(), stats, self_got.cpu(), self_stats,
                     launches, wide.cpu())
    card, cpu = runs[DEV], runs["cpu"]
    wide_err = (card[6] - cpu[6]).abs().max().item()
    expect = card[2]["rounds"] * (gamma + 1) * dcfg.n_layers
    print(f"  speculative_generate (gamma {gamma}), each round's replay "
          f"under sync-debug mode: random draft (mean accepted "
          f"{card[2]['mean_accepted']:.3f} of {gamma}: it rejects) == the "
          f"card's generate "
          f"{torch.equal(card[1], card[0])} ({card[2]}, cpu {cpu[2]}); int8 "
          f"self-draft == generate {torch.equal(card[3], card[0])} "
          f"({card[4]}, cpu {cpu[4]}); tokens card == cpu "
          f"{torch.equal(card[1], cpu[1])}; B5 launches {card[5]} (expected "
          f"{expect}); wide_step g={gamma + 1} at a device position, "
          f"logits max |card - cpu| {wide_err:.2e} (tolerance "
          f"{TOL_ENGINE_LOGITS:.0e})")
    if not (torch.equal(card[1], card[0]) and torch.equal(card[3], card[0])
            and torch.equal(card[1], cpu[1]) and card[2] == cpu[2]
            and card[4] == cpu[4]):
        raise AssertionError("speculative decoding on the card is not the "
                             "target's greedy decode or disagrees with the "
                             "CPU")
    if not card[2]["mean_accepted"] < gamma:
        raise AssertionError("the random draft was never rejected: the "
                             "partial-acceptance path did not run")
    if card[5] != expect or not wide_err <= TOL_ENGINE_LOGITS:
        raise AssertionError(f"speculative drafts launched B5 {card[5]} "
                             f"times (expected {expect}), or the wide "
                             f"verify disagrees with the CPU")
    # draft = target: every proposal accepted (p_t / p_d = 1 up to f32)
    tp = init_params(tcfg, 0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    with _rounds_without_waits():
        out, stats = spec.speculative_sample(
            tp, tcfg, tp, tcfg, prompt.to(DEV), 16, gen, gamma=4,
            return_stats=True)
    print(f"  speculative_sample with draft = target (gamma 4): {stats}")
    if stats["mean_accepted"] != 4.0 or out.shape != (2, 24):
        raise AssertionError("speculative_sample with draft = target did "
                             "not accept every proposal")


def small_seq2seq_beam_spec_phase(card: str) -> None:
    print(f"{card}: fp32, the card's runs against the CPU's from one seed")
    _small_seq2seq(card)
    _small_beam(card)
    _small_speculative(card)


def full_width_seq2seq_phase(card: str) -> dict:
    """B1-B3 at the cross-attention shape and at the decoder's causal
    self-attention, then seq2seq training steps and greedy decoding at
    full width. Returns the kernels' readings at the cross shape."""
    gen = torch.Generator().manual_seed(12)
    print(f"{card}: B1-B3 at the cross-attention shape, no mask, "
          f"q [{FLASH_CROSS[0]}, {FLASH_CROSS[1]}, {FLASH_CROSS[3]}, "
          f"{FLASH_CROSS[5]}], k/v [{FLASH_CROSS[0]}, {FLASH_CROSS[2]}, "
          f"{FLASH_CROSS[4]}, {FLASH_CROSS[5]}]")
    _flash_bf16_case("cross_full_width", FLASH_CROSS, {"causal": False}, gen)
    torch.cuda.empty_cache()
    cross = _flash_full_width(gen, {"causal": False}, FLASH_CROSS,
                              FLASH_CROSS_TILES)
    print(f"{card}: B1-B3 at the decoder's causal self-attention, t = "
          f"{FLASH_DEC_CAUSAL[3]}")
    dec = _flash_full_width(gen, {}, FLASH_DEC_CAUSAL,
                            FLASH_DEC_CAUSAL_TILES)
    for label, readings in (("cross shape", cross),
                            ("decoder causal t = 512", dec)):
        for name, r in readings.items():
            print(f"{card}: {name}, {label}: {r['ms']:.4f} ms, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of its "
                  f"{r['bound_ms']:.4f} ms bound")
    torch.cuda.empty_cache()

    cfg = FULL_S2S
    t_set = time.perf_counter()
    params = s2s.init_seq2seq_params(cfg, 0, device=DEV)
    n_params = tt.param_count(params)
    b, ts, tt_ = FULL_S2S_BATCH
    g = torch.Generator().manual_seed(1)
    src = torch.randint(0, cfg.vocab, (b, ts), generator=g,
                        dtype=torch.int32).to(DEV)
    tgt = torch.randint(0, cfg.vocab, (b, tt_), generator=g,
                        dtype=torch.int32).to(DEV)
    batch = (src, tgt)
    step, init = s2s.make_seq2seq_train_step(cfg, optimizer=tt.AdamW(1e-3),
                                             attn_fn=fa.flash_attention)
    state = init(params)
    first = step(params, state, batch)[2].item()
    print(f"{n_params / 1e6:.1f}M params (encoder "
          f"{tt.param_count(params['encoder']) / 1e6:.1f}M); untimed first "
          f"step and set-up {time.perf_counter() - t_set:.1f} s, loss "
          f"{first:.4f}")
    step_ms, losses, launches, peak = _timed_steps(
        lambda: step(params, state, batch)[2])
    print(f"{card}: seq2seq, {TIMED_STEPS} steps of {b} x ({ts} source + "
          f"{tt_} target): {step_ms:.2f} ms/step, "
          f"{b * (ts + tt_) / step_ms * 1e3:.1f} tokens/s (source plus "
          f"target), peak memory {peak / 2**30:.2f} GiB; losses {losses}; "
          f"flash launches {launches}")
    per_step = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    expect = {name: per_step * TIMED_STEPS for name, _ in FLASH_KERNELS}
    if launches != expect:
        raise AssertionError(f"seq2seq: flash kernels launched {launches}, "
                             f"expected {expect}")
    if not all(math.isfinite(x) for x in [first] + losses):
        raise AssertionError(f"seq2seq losses {[first] + losses} not finite")
    _profile_step(lambda: step(params, state, batch), step_ms)
    for leaf in state.leaves:
        leaf.requires_grad_(False)
    del state
    torch.cuda.empty_cache()

    # greedy decoding: the encoder once, then the whole decoder over the
    # [b, steps + 1] buffer at every step, eagerly (the reference's
    # design: no KV cache)
    steps = S2S_DECODE_STEPS
    with torch.no_grad():
        s2s.encode(params, src, cfg, fa.flash_attention)    # warm
        torch.cuda.synchronize()
        start = time.perf_counter()
        s2s.encode(params, src, cfg, fa.flash_attention)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - start
    for name, _ in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = s2s.greedy_decode(params, src, cfg, steps,
                            attn_fn=fa.flash_attention)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    b1 = fa.flash_forward.launches
    expect = cfg.n_enc_layers + steps * 2 * cfg.n_dec_layers
    print(f"{card}: greedy_decode, {steps} steps of {b} rows over "
          f"{ts}-token sources: {wall:.3f} s wall, the encoder "
          f"{1e3 * enc_s:.2f} ms of it, "
          f"{1e3 * (wall - enc_s) / steps:.2f} ms per step (eager: the "
          f"whole decoder over the buffer each step); B1 launches {b1} "
          f"(expected {expect})")
    if out.shape != (b, steps) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()) or b1 != expect:
        raise AssertionError("seq2seq greedy_decode: malformed output or "
                             "B1 launches")
    return cross


def full_width_beam_phase(card: str) -> int:
    """B5 alone at the beam's read, then beam_search at full width.
    Returns B5's launches over one beam_search call."""
    gen = torch.Generator().manual_seed(13)
    print(f"{card}: B5 at the beam's read, q [{DECODE_BEAM[0]}, "
          f"{DECODE_BEAM[1]}, 1, {DECODE_BEAM[4]}], cache [{DECODE_BEAM[0]}, "
          f"{DECODE_BEAM[2]}, {DECODE_BEAM[3]}, {DECODE_BEAM[4]}], bf16")
    beam_inputs = _decode_inputs(DECODE_BEAM, torch.bfloat16, gen)
    for pos in DECODE_BEAM_POS:
        _decode_check("beam bf16", *beam_inputs, pos)
    del beam_inputs
    torch.cuda.empty_cache()

    cfg = GEN_FULL
    b, t0, width, steps = (BEAM_FULL[k] for k in
                           ("b", "prompt_len", "beam", "steps"))
    short = BEAM_SHORT_STEPS
    params = init_params(cfg, 0, device=DEV)
    prompt = torch.randint(0, cfg.vocab, (b, t0),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)

    def run(n):
        return bm.beam_search(params, cfg, prompt, n, width,
                                return_all=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.flash_decode_attention.launches = 0
    StepGraph.captures, StepGraph.capture_seconds = 0, 0.0
    with no_device_waits():
        seqs, scores = run(steps)
    torch.cuda.synchronize()
    launches = da.flash_decode_attention.launches
    captures, capture_s = StepGraph.captures, StepGraph.capture_seconds
    peak = torch.cuda.max_memory_allocated()
    # the best of three calls of each length (a call's wall, its two
    # captures included, moves with the host by tens of ms)
    walls = {n: timing.time_fn(lambda n=n: run(n), warmup=0,
                               iters=3).best_s
             for n in (short, steps)}
    wall_step = (walls[steps] - walls[short]) / (steps - short)
    expect = cfg.n_layers * (steps - 1)
    slots = da.round_up_kv(t0 + steps)
    cache_gb = 2 * cfg.n_layers * b * width * (cfg.n_kv_heads or
                                               cfg.n_heads) \
        * slots * (cfg.d_model // cfg.n_heads) * 2 / 1e9
    print(f"{card}: beam_search, batch {b}, prompt {t0}, beam {width}, "
          f"{steps} steps ({b * width} cache rows of {slots} slots, "
          f"{cache_gb:.2f} GB): {walls[steps]:.3f} s wall per call, "
          f"{1e3 * wall_step:.3f} ms per step (marginal between {short} "
          f"and {steps} steps); {captures} CUDA graphs captured in "
          f"{1e3 * capture_s:.1f} ms, under sync-debug mode with the "
          f"prefill and every replay; B5 launches {launches}, counted per "
          f"replay (expected {expect}); peak memory {peak / 2**30:.2f} GiB")
    if launches != expect or captures != 2:
        raise AssertionError(f"beam: B5 launched {launches} times "
                             f"(expected {expect}) in {captures} captures")
    # the rescoring invariant on the best row, in bf16
    best = seqs[:, 0]
    lp = bm.sequence_logprob(params, cfg, prompt, best)
    rel = ((lp - scores[:, 0]).abs() / scores[:, 0].abs()).max().item()
    print(f"{card}: the best row's score {scores[:, 0].tolist()} against "
          f"sequence_logprob {lp.tolist()}: worst relative difference "
          f"{rel:.2e} (tolerance {TOL_BEAM_BF16_REL:.2e}: bf16's unit "
          f"roundoff)")
    sorted_ = bool((scores[:, 1:] <= scores[:, :-1]).all())
    if not rel <= TOL_BEAM_BF16_REL or not sorted_ \
            or not torch.equal(seqs[:, :, :t0], prompt[:, None].expand(
                b, width, t0)):
        raise AssertionError("beam at full width: the best score is not "
                             "its sequence's log-probability, the beams "
                             "are not sorted, or the prompt is not kept")
    del seqs, scores, lp
    torch.cuda.empty_cache()
    # device time by kernel group, the long and the short call
    split = {n: _device_split(lambda n=n: run(n), BEAM_KERNEL_GROUPS)
             for n in (short, steps)}
    if split[steps] is None:
        print("  the profiler recorded no device time (not measured)")
        return launches
    (busy_l, shares_l, kernels), (busy_s, shares_s, _) = split[steps], \
        split[short]
    dev_step = (busy_l - busy_s) / (steps - short)
    print(f"{card}: beam device time: {busy_l:.2f} ms busy per call, "
          f"{dev_step:.3f} ms per step (marginal); the card idle "
          f"{100 * (1 - busy_l / (1e3 * walls[steps])):.1f}% of the call's "
          f"wall; per step:")
    for name in shares_l:
        ms = (shares_l[name] - shares_s[name]) / (steps - short)
        print(f"    {name}: {ms:.4f} ms ({100 * ms / dev_step:.1f}% of the "
              f"step)")
    for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        print(f"    {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    # B5 at 32 rows: the K/V bytes of the live slots (pos + 1 at each of
    # the replayed steps' positions, t0 .. t0 + steps - 2) read once
    rows, h_kv = b * width, cfg.n_kv_heads or cfg.n_heads
    hd = cfg.d_model // cfg.n_heads
    live = t0 + (steps - 2) / 2 + 1
    bound_ms = 2 * rows * h_kv * live * hd * 2 / HBM_BYTES_PER_S * 1e3
    per_launch = shares_l["flash decode (B5)"] / launches
    print(f"{card}: B5 at {rows} rows: {per_launch:.4f} ms per launch by the "
          f"profiler (split and merge kernels), {launches} launches; byte "
          f"bound {bound_ms:.4f} ms at the run's mean {live:.0f} live "
          f"slots ({100 * bound_ms / per_launch:.1f}% of it)")
    return launches


def full_width_speculative_phase(card: str) -> None:
    gen = torch.Generator().manual_seed(14)
    print(f"{card}: B5 at the drafts' reads, b = 1: q [1, 16, 1, 128], "
          f"cache [1, 4, L, 128]")
    for length, positions in DECODE_SPEC.items():
        inputs = _decode_inputs((1, 16, 4, length, 128), torch.bfloat16, gen)
        for pos in positions:
            _decode_check(f"b = 1, {length} slots, bf16", *inputs, pos)
    length, pos = DECODE_SPEC_F32
    _decode_check(f"b = 1, {length} slots, f32", *_decode_inputs(
        (1, 16, 4, length, 128), torch.float32, gen), pos)
    del inputs
    torch.cuda.empty_cache()

    for name, bench in (
            ("speculative_decode_tokens_per_sec (int8 self-draft)",
             spec.speculative_decode_tokens_per_sec),
            ("early_exit_decode_tokens_per_sec (2-layer int8 draft, "
             "150 quick steps on the bigram chain)",
             spec.early_exit_decode_tokens_per_sec)):
        da.flash_decode_attention.launches = 0
        StepGraph.captures, StepGraph.capture_seconds = 0, 0.0
        start = time.perf_counter()
        with _rounds_without_waits() as rounds:
            r = bench(device=DEV, **SPEC_FULL)
        print(f"{card}: {name}, {time.perf_counter() - start:.1f} s: "
              + ", ".join(f"{k} {v}" for k, v in r.items()))
        n_gen = StepGraph.captures - rounds.captures
        gen_s = StepGraph.capture_seconds - rounds.capture_seconds
        print(f"{card}: host reads (rounds, each replay under sync-debug "
              f"mode) {rounds.calls} over the bench's {SPEC_BENCH_CALLS} "
              f"speculative calls, {rounds.calls / SPEC_BENCH_CALLS:.1f} a "
              f"call; B5 launches {da.flash_decode_attention.launches} over "
              f"the bench; the round captured {rounds.captures} time(s) "
              f"in {1e3 * rounds.capture_seconds:.1f} ms (kept across "
              f"its calls); generate's step {n_gen} times, "
              f"{1e3 * gen_s / max(n_gen, 1):.1f} ms each (once in each "
              f"of its calls, the timed ones included)")
        if not r["spec_tokens_per_sec"] > 0 \
                or not 0 <= r["mean_accepted"] <= SPEC_FULL["gamma"] \
                or da.flash_decode_attention.launches == 0 \
                or rounds.calls % SPEC_BENCH_CALLS:
            raise AssertionError(f"{name}: malformed result")
        if "exact_greedy" in r and not (
                r["exact_greedy"] or r["divergence"]):
            raise AssertionError(f"{name}: output neither exact nor "
                                 f"a near-tie")

    # speculative_sample with draft = target: every proposal accepted in
    # f32 (p_t / p_d is 1 up to f32 rounding). In bf16, the configuration's
    # own precision, the g = 1 draft step and the g-wide verify round the
    # logits differently: each p_t / p_d is off 1 by about bf16's unit
    # roundoff, so a rejection is possible but rare (under one expected in
    # a call's ~232 proposals); at most one round's worth of proposals may
    # be lost (mean accepted >= gamma (1 - 1 / rounds))
    b, gamma, n = SPEC_FULL["b"], SPEC_FULL["gamma"], SPEC_FULL["gen"]
    prompt = torch.randint(0, GEN_FULL.vocab, (b, 128),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = replace(GEN_FULL, dtype=dtype)
        params = init_params(cfg, 0, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(3)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out, stats = spec.speculative_sample(
            params, cfg, params, cfg, prompt, n, gen, gamma=gamma,
            return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        print(f"{card}: speculative_sample, draft = target, {dtype}, b {b}, "
              f"gamma {gamma}, {n} tokens: {stats}, {wall:.3f} s wall, "
              f"{b * n / wall:.1f} tokens/s")
        least = gamma if dtype == torch.float32 else \
            gamma * (1 - 1 / stats["rounds"])
        print(f"  mean accepted {stats['mean_accepted']} (at least "
              f"{least:.3f} asserted in {dtype})")
        if out.shape != (b, 128 + n) or not stats["mean_accepted"] >= least:
            raise AssertionError(f"speculative_sample with draft = target "
                                 f"in {dtype} accepted "
                                 f"{stats['mean_accepted']} of {gamma} a "
                                 f"round, under {least}")
        del params
        torch.cuda.empty_cache()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype, shape and bytes (NaN payloads and signed zeros
    included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    if a.numel() == 0:
        return True
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _prefetch_source(n: int):
    """n host batches of PREFETCH_SHAPE float32 integers (exact sums in
    f64 on either side) and their sums."""
    base = np.arange(np.prod(PREFETCH_SHAPE), dtype=np.int64)
    batches, sums = [], []
    for i in range(n):
        x = ((base * (i + 3)) % 2003 - 1001).astype(np.float32)
        batches.append(x.reshape(PREFETCH_SHAPE))
        sums.append(float(x.astype(np.float64).sum()))
    return batches, sums


def _trace_events(log_dir: str) -> list:
    run = latest_trace(log_dir)
    if run is None:
        raise AssertionError(f"latest_trace found no run under {log_dir}")
    with open(os.path.join(run, "trace.json")) as f:
        return json.load(f)["traceEvents"]


def _prefetch_checks(card: str) -> None:
    """The copy/consumer race, the side stream and an abandoned loop."""
    batches, sums = _prefetch_source(PREFETCH_BATCHES)
    w = torch.randn((4096, 4096), generator=torch.Generator().manual_seed(2)
                    ).to(DEV, torch.bfloat16) / 64
    got = []
    start = time.perf_counter()
    for x in data.prefetch_to_device(iter(batches), size=2, device=DEV):
        # a slow kernel first, then the read of the batch, both on the
        # consumer's stream: a batch whose memory a later copy reused
        # before this read would give another sum
        y = w
        for _ in range(PREFETCH_SLOW_PRODUCTS):
            y = y @ w
        got.append(x.double().sum())
    got = torch.stack(got).cpu().tolist()
    wall = time.perf_counter() - start
    bad = [i for i, (a, b) in enumerate(zip(got, sums)) if a != b]
    print(f"{card}: prefetch_to_device, {PREFETCH_BATCHES} batches of "
          f"{PREFETCH_SHAPE} f32 ({4 * np.prod(PREFETCH_SHAPE) >> 20} MiB), "
          f"{PREFETCH_SLOW_PRODUCTS} products of 4096^2 per batch before "
          f"its read: {wall:.2f} s; device sums equal to the host's for "
          f"{len(got) - len(bad)} of {len(sums)}")
    if len(got) != len(sums) or bad:
        raise AssertionError(f"prefetched batches {bad} read other values "
                             f"than the host's")

    # the copies on the producer's stream, not the consumer's (the whole
    # loop once more: a short trace may record none of the card's events)
    log_dir = tempfile.mkdtemp()
    try:
        with trace_to(log_dir):
            with annotate("smoke:prefetch"):
                for x in data.prefetch_to_device(iter(batches), size=2,
                                                 device=DEV):
                    y = w
                    for _ in range(PREFETCH_SLOW_PRODUCTS):
                        y = y @ w
                    x.square().sum()
            torch.cuda.synchronize()
        events = _trace_events(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    copies = {e.get("args", {}).get("stream") for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")}
    kernels = {e.get("args", {}).get("stream") for e in events
               if e.get("cat") == "kernel"}
    spans = [e for e in events if e.get("name") == "smoke:prefetch"]
    print(f"  traced: host-to-device copies on stream(s) {sorted(copies)}, "
          f"the consumer's kernels on {sorted(kernels)}; span "
          f"'smoke:prefetch' {len(spans)} time(s)")
    if not copies or not kernels or copies & kernels or not spans:
        raise AssertionError("the prefetch copies did not run on a stream "
                             "of their own, or the trace lacks them")

    # a consumer that leaves early releases the producer
    it = data.prefetch_to_device(iter(batches), size=2, device=DEV)
    for i, _ in enumerate(it):
        if i == 1:
            break
    it.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == data.PRODUCER_THREAD and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.02)
    alive = [t for t in threading.enumerate()
             if t.name == data.PRODUCER_THREAD and t.is_alive()]
    print(f"  abandoned after 2 of {len(batches)} batches: "
          f"{len(alive)} producer thread(s) alive")
    if alive:
        raise AssertionError("an abandoned prefetch loop left its producer "
                             "running")


def _state_tensors(tree) -> list:
    """(name, tensor) of every tensor of a train-state tree, optimizer
    moments and step counts by their state_dict names."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        elif isinstance(node, (tt.OptState, tt.AdafactorState)):
            for k, v in node.state_dict().items():
                if isinstance(v, torch.Tensor):
                    out.append((prefix + k, v))
        elif isinstance(node, torch.Tensor):
            out.append((prefix[:-1], node))

    walk(tree, "")
    return out


def _checkpoint_check(card: str, params, state, step, batch) -> None:
    """The full-width train state saved, restored onto the card and onto
    the CPU (both bit-equal), and one step from the restored state equal
    to the continuation's, loss and parameters bit for bit."""
    tree = {"params": params, "opt": state, "step": 2,
            "rng": torch.Generator().manual_seed(5)}
    tensors = _state_tensors(tree)
    n_bytes = sum(t.numel() * t.element_size() for _, t in tensors)
    ck_dir = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_state(ck_dir, 2, tree)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        restored, seconds = {}, {}
        for label, where in (("card", DEV), ("CPU", "cpu")):
            t0 = time.perf_counter()
            restored[label] = restore_train_state(
                ck_dir, abstract_like(tree, device=where))
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"{card}: checkpoint of the full-width training state "
          f"({tt.param_count(params) / 1e6:.1f}M params, AdamW, "
          f"{len(tensors)} tensors, {n_bytes / 1e9:.3f} GB): "
          f"{written / 1e9:.3f} GB written in {save_s:.2f} s "
          f"({written / save_s / 1e9:.2f} GB/s); restored onto the card in "
          f"{seconds['card']:.2f} s, onto the CPU in {seconds['CPU']:.2f} s")
    for label, back in restored.items():
        where = DEV if label == "card" else "cpu"
        got = dict(_state_tensors(back))
        # AdamW's step counts live on the CPU wherever its params are
        bad = [name for name, t in tensors
               if name not in got or got[name].device.type
               != ("cpu" if name.endswith(".step")
                   else torch.device(where).type)
               or not _bits_equal(t.cpu(), got[name].cpu())]
        if back["step"] != 2 or not torch.equal(
                back["rng"].get_state(), tree["rng"].get_state()):
            bad.append("step/rng")
        print(f"  restored onto the {label}: {len(tensors) - len(bad)} of "
              f"{len(tensors)} tensors bit-equal, on {where}")
        if bad:
            raise AssertionError(f"checkpoint restored onto the {label} "
                                 f"differs in {bad[:5]}")
    del restored["CPU"]
    back = restored.pop("card")

    _, _, loss_cont = step(params, state, batch)
    _, _, loss_res = step(back["params"], back["opt"], batch)
    same = [_bits_equal(a, b) for a, b in zip(
        tt._param_leaves(params), tt._param_leaves(back["params"]))]
    moments = [_bits_equal(a, b) for (_, a), (_, b) in zip(
        _state_tensors(state), _state_tensors(back["opt"]))]
    print(f"  one step on: continuation loss {loss_cont.item()!r}, resumed "
          f"{loss_res.item()!r}; parameters bit-equal {sum(same)} of "
          f"{len(same)}, optimizer tensors {sum(moments)} of {len(moments)}")
    if loss_cont.item() != loss_res.item() or not all(same) \
            or not all(moments):
        raise AssertionError("the resumed step differs from the "
                             "continuation")


def data_checkpoint_profiling_phase(card: str) -> None:
    _prefetch_checks(card)

    t0 = time.perf_counter()
    params = init_params(FULL_TRAIN, 0, device=DEV)
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, FULL_TRAIN.vocab, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)
    step, init = tt.make_train_step(FULL_TRAIN,
                                    optimizer=tt.default_optimizer(),
                                    attn_fn=fa.flash_attention)
    state = init(params)
    # two steps: the warm-up's first rate is 0, its second is not
    for _ in range(2):
        params, state, loss = step(params, state, batch)
    print(f"{card}: the training configuration, two steps in "
          f"{time.perf_counter() - t0:.1f} s (loss {loss.item():.4f})")
    _checkpoint_check(card, params, state, step, batch)

    # one full-width step under trace_to, with its span and B1-B3
    log_dir = tempfile.mkdtemp()
    try:
        with trace_to(log_dir):
            with annotate("smoke:train_step"):
                step(params, state, batch)
        run = latest_trace(log_dir)
        size = os.path.getsize(os.path.join(run, "trace.json"))
        events = _trace_events(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    names = [e.get("name", "") for e in events]
    found = {frag: sum(frag in n for n in names)
             for frag in ("smoke:train_step", "flash_fwd_kernel",
                          "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
    print(f"  trace_to around one step: {os.path.basename(run)}, "
          f"{size / 1e6:.1f} MB, {len(events)} events; " + ", ".join(
              f"{k} x{v}" for k, v in found.items()))
    if not all(found.values()):
        raise AssertionError(f"the trace lacks {found}")
    del params, state
    torch.cuda.empty_cache()


def _sdpa_backend(fn, calls: int = 10) -> str:
    """The SDPA backend that ran ``fn``, from its kernels' names over
    ``calls`` calls under the profiler (cuDNN's names also say "flash",
    so it is looked for first), and its longest kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    names = [e.key.lower() for e in kernels]
    backend = "math"
    for name, frags in (("cuDNN", ("cudnn",)),
                        ("memory-efficient", ("efficient", "mem_eff",
                                              "fmha")),
                        ("flash", ("flash",))):
        if any(f in n for n in names for f in frags):
            backend = name
            break
    top = kernels[0].key[:90] if kernels else "no kernel"
    return f"the {backend} backend (longest kernel: {top})"


def _window_forward_blocks(q, k, v, out, lse, window) -> None:
    """B1's output at the long window shape in row blocks at the start,
    the middle and the end: each row within its allowance against
    ``attention_reference`` in f32 (full K/V, ``row_offset``), lse within
    TOL_FLASH_LSE of the f32 one, and a 64 x 64 tile of the band left out
    of each block's last rows shown to break that allowance."""
    k32, v32 = k.float(), v.float()
    d, n = q.shape[-1], FLASH_MUTANT_TILE
    for r0 in FLASH_LONG_BLOCKS:
        rows = slice(r0, r0 + FLASH_LONG_BLOCK)
        qb = q[:, :, rows]
        mask = dict(causal=True, window=window, row_offset=r0)
        ref = fa.attention_reference(qb.float(), k32, v32, **mask)
        _, ref_lse = fa._flash_forward_plain(qb.float(), k32, v32,
                                             window=window, row_offset=r0)
        plain, _ = fa._flash_forward_plain(qb, k, v, window=window,
                                           row_offset=r0)
        got = _bf16_reading(out[:, :, rows], plain, ref)
        lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
        allow = _allowance(plain, ref)
        # tiles of the last 64 rows: on the diagonal, and at the middle
        # of the band
        i0 = FLASH_LONG_BLOCK - n
        omitted = []
        for c0 in (r0 + i0, r0 + i0 - window // 2):
            if c0 < 0:
                continue
            qt = qb[:, :, i0:].float()
            s = torch.einsum("bhid,bhjd->bhij", qt,
                             k32[:, :, c0:c0 + n]) / math.sqrt(d)
            vis = fa._visible(n, n, True, window, r0 + i0 - c0, None, DEV)
            p = torch.where(vis, torch.exp(s - ref_lse[:, :, i0:, None]),
                            0.0)
            c = torch.einsum("bhij,bhjd->bhid", p, v32[:, :, c0:c0 + n])
            omitted.append((c0, (c.abs().amax(-1)
                                 / allow[:, :, i0:]).max().item()))
        print(f"  rows {r0}..{r0 + FLASH_LONG_BLOCK - 1}: out worst row "
              f"{got['kernel']:.3e} (bf16 plain {got['plain']:.3e}), "
              f"{got['over']:.3f} of its allowance; lse {lse_err:.2e}; "
              + ", ".join(f"tile {r0 + i0},{c0} left out {m:.1f}"
                          for c0, m in omitted))
        if not got["over"] <= 1.0 or not lse_err <= TOL_FLASH_LSE:
            raise AssertionError(f"B1 at the long window shape, rows "
                                 f"{r0}..: {got['over']} of its allowance, "
                                 f"lse {lse_err}")
        if not omitted or not min(m for _, m in omitted) > 1.0:
            raise AssertionError(f"the allowance of rows {r0}.. would not "
                                 f"see a tile left out ({omitted})")


def _flash_window_long(card: str, gen) -> dict:
    """B1-B3 at the long-context benchmarks' shape under the window mask:
    B1 held row block by row block against the f32 oracle, then the
    full-width check of phase 4 at the whole shape (the gradients too:
    their plain versions and f32 reference fit the card at this t), timed
    against the plain versions, SDPA with an explicit band mask and the
    bounds."""
    b, h, h_kv, t, _, d = FLASH_LONG
    w = FLASH_LONG_WINDOW
    q, k, v, _, _ = _flash_inputs(FLASH_LONG, torch.bfloat16, gen)
    out, lse = fa.flash_forward(q, k, v, window=w)
    print(f"{card}: B1-B3 at b {b}, h {h} (MHA), t {t}, window {w}, d {d}, "
          f"bf16: B1 against attention_reference in f32 (full K/V, "
          f"row_offset) in {FLASH_LONG_BLOCK}-row blocks")
    _window_forward_blocks(q, k, v, out, lse, w)
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{card}: B1-B3 at that shape in full, every output row against "
          f"the f32 reference (the gradients too: at t {t} their plain "
          f"versions fit the card)")
    readings = _flash_full_width(gen, {"window": w}, shape=FLASH_LONG,
                                 tiles=FLASH_LONG_TILES)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    return readings


def _counted(fn, **kwargs):
    """``fn(**kwargs)`` with B1-B3's launches counted from zero: (result,
    launches)."""
    wrappers = _flash_wrappers()
    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.perf_counter()
    out = fn(**kwargs)
    launches = {name: wr.launches for name, wr in wrappers.items()}
    print(f"  {fn.__name__}({', '.join(f'{k}={v}' for k, v in kwargs.items())}"
          f"), {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v}" for k, v in out.items())
          + f"; launches {launches}")
    for key, value in out.items():
        if key != "shape" and not all(
                math.isfinite(x) and x > 0
                for x in (value if isinstance(value, list) else [value])):
            raise AssertionError(f"{fn.__name__}: {key} = {value}")
    return out, launches


def attention_benchmarks_phase(card: str) -> dict:
    """B1-B3 held at the flash benchmarks' causal MHA shape and at the
    long-context window shape (the gradients in full at the longest t
    whose plain backward fits), then the four benchmarks at their
    reference defaults, each kernel's launches counted over them, and the
    matrix-product rate against the card's peak. Returns the kernels'
    readings by shape."""
    gen = torch.Generator().manual_seed(21)
    b, h, _, t, _, d = FLASH_MHA
    print(f"{card}: B1-B3 at the flash benchmarks' shape, b {b}, h {h} "
          f"(MHA), t {t}, d {d}, causal")
    mha = _flash_full_width(gen, {}, shape=FLASH_MHA,
                            tiles=FLASH_MUTANT_TILES)
    torch.cuda.empty_cache()
    long = _flash_window_long(card, gen)
    torch.cuda.empty_cache()

    print(f"{card}: the flash benchmarks at their reference defaults "
          f"(bench.py:2177-2200; TFLOP/s by device-busy time)")
    fwd, l_fwd = _counted(fa.flash_attention_tflops)
    train, l_train = _counted(fa.flash_attention_train_tflops)
    lfwd, l_lfwd = _counted(fa.flash_attention_long_context_tflops,
                            n_runs=LONG_CTX_RUNS)
    ltrain, l_ltrain = _counted(
        fa.flash_attention_long_context_train_tflops, n_runs=LONG_CTX_RUNS)
    launches = {
        "mha": {n: l_fwd[n] + l_train[n] for n in l_fwd},
        "long": {n: l_lfwd[n] + l_ltrain[n] for n in l_lfwd},
    }
    if any(v == 0 for shape in launches.values() for v in shape.values()):
        raise AssertionError(f"a flash kernel was not launched by the "
                             f"benchmarks: {launches}")
    for label, r, per, shape in (
            ("forward, MHA", fwd["flash_attn_tflops"], "flash_forward", mha),
            ("forward, window", lfwd["flash_attn_long_ctx_tflops"],
             "flash_forward", long)):
        print(f"  {label}: {r:.1f} TFLOP/s of useful work; B1 alone at "
              f"{shape[per]['ms']:.4f} ms = "
              f"{100 * shape[per]['bound_ms'] / shape[per]['ms']:.1f}% of "
              f"its bound")
    mm = co.matmul_tflops_steady(m=MATMUL_M)
    peak = co.device_peak_tflops()
    share = "not known" if peak is None else f"{100 * mm.tflops / peak:.1f}%"
    print(f"{card}: {mm}; device_peak_tflops() {peak}: {share} of the peak")
    if not mm.tflops > 0:
        raise AssertionError(f"matmul_tflops_steady: {mm}")
    return {"mha": (mha, launches["mha"]), "long": (long, launches["long"])}


def full_width_real_data_phase(card: str) -> None:
    """The reference bench's real-data early-exit call (bench.py:2433):
    the byte-level target trained on the card's stdlib, then measured
    on held-out prompts, B5's launches and the host reads counted."""
    print(f"{card}: B5 at this bench's draft read (b = 1, 16 heads over 4, "
          f"hd 128, 394 slots rounded to 512) is held alone in the "
          f"speculative phase (DECODE_SPEC)")
    da.flash_decode_attention.launches = 0
    start = time.perf_counter()
    with _rounds_without_waits() as rounds:
        r = spec.early_exit_real_data_tokens_per_sec(device=DEV,
                                                     **REAL_DATA_BENCH)
    wall = time.perf_counter() - start
    print(f"{card}: early_exit_real_data_tokens_per_sec("
          + ", ".join(f"{k}={v}" for k, v in REAL_DATA_BENCH.items())
          + f"), {wall:.1f} s:")
    for key in ("speedup", "spec_tokens_per_sec", "plain_tokens_per_sec",
                "mean_accepted", "draft_cost_ratio",
                "perfect_acceptance_bound", "per_prompt", "train_steps",
                "final_train_loss", "corpus_bytes", "holdout_docs",
                "exact_greedy", "divergence", "shape"):
        print(f"  {key}: {r[key]}")
    print(f"  rounds (host reads, each replay under sync-debug mode) "
          f"{rounds.calls}; B5 launches {da.flash_decode_attention.launches}")
    if r["train_steps"] != REAL_DATA_BENCH["train_steps"] \
            or not math.isfinite(r["final_train_loss"]) \
            or not 0 <= r["mean_accepted"] <= REAL_DATA_BENCH["gamma"] \
            or da.flash_decode_attention.launches == 0 \
            or not (r["exact_greedy"] or r["divergence"]):
        raise AssertionError("the real-data bench's result is malformed")


# phases 3-20 and 21-24 run in two processes of this script, one after
# the other, started by main() with this argument and the half's number;
# each prints its kernels' readings on a line that starts with READINGS.
# In one process, torch.profiler sessions late in a long run recorded
# none of the card's events when they were short (torch 2.11, H100:
# phase 21's first trace after phases 3-20; long sessions kept theirs;
# cause not found), and phase 21's traces, phase 22's SDPA backend and
# benchmark timings rest on such sessions
# ------------------------------------------ the sharded training tier

def collectives_phase(card: str) -> None:
    """An NCCL group of one rank: both meshes over it, every axis 1; the
    five collective benchmarks at their defaults, each collective's
    output the input (one rank), the bus factor 0 and the algorithm
    bandwidth positive, the ppermute ring's data home (asserted inside
    ``ppermute_latency``)."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        flat = pm.build_mesh(device_type="cuda")
        mesh = pm.build_mesh_spmd(device_type="cuda")
        print(f"build_mesh {dict(zip(flat.mesh_dim_names, flat.shape))}, "
              f"build_mesh_spmd "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        if tuple(flat.shape) != (1, 1) or tuple(mesh.shape) != (1, 1, 1, 1):
            raise AssertionError("a one-rank world gives meshes of size 1")
        x = torch.arange(4096, dtype=torch.float32, device=DEV)
        for kind in ("psum", "all_gather", "reduce_scatter", "all_to_all"):
            if not torch.equal(co.collective(kind, x), x):
                raise AssertionError(f"{kind} over one rank is not its input")
        for bench in (co.psum_bandwidth, co.all_gather_bandwidth,
                      co.reduce_scatter_bandwidth, co.all_to_all_bandwidth):
            r = bench()
            print(f"{bench.__name__}: {r}")
            if not (r.algo_gbps > 0 and r.bus_gbps == 0
                    and r.backend == "nccl"):
                raise AssertionError(f"{bench.__name__} at n = 1: {r}")
        print(f"ppermute_latency: {co.ppermute_latency()}")
    finally:
        dist.destroy_process_group()
    print(f"{card}: the collectives at world size 1 over NCCL")


def _ring_grads(q, k, v, n, window):
    """(out, dq, dk, dv) of ``(out ** 2).sum()`` through every rank's hops
    of the causal ring of ``n`` ranks (``ring_attention_all_ranks``: the
    forward and backward loops that ``ring_attention`` runs, with the
    chunks rotated between the ranks in place of the collective)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = pr.ring_attention_all_ranks(*leaves, n, True, window)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    return (out.detach(),) + grads


@contextlib.contextmanager
def _plain_flash():
    """Inside, the flash wrappers run their plain versions on the card
    too: the same composition through the plain versions of B1-B3."""
    saved = _flash_wrappers()
    fa.flash_forward = lambda *a, with_lse=True, **kw: \
        fa._flash_forward_plain(*a, **kw)
    fa.flash_backward_dq = fa._flash_backward_dq_plain
    fa.flash_backward_dkv = fa._flash_backward_dkv_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


def _ring_shape_check(key: str, gen) -> tuple:
    """One ring shape: the hops of every rank forward and backward with
    B1-B3's launches counted (the main path of the kernels' ring rows),
    held row by row against the f32 reference. The ring's plain version
    is the same ring through the plain versions of B1-B3 in bf16: each
    hop's partial output is rounded to bf16 before the f32 merge (as in
    the reference) and each chunk's dk/dv sum to bf16 for the wire,
    roundings that the whole sequence's one kernel call does not make,
    so the whole sequence's ``flash_attention`` is read beside it but
    does not set the allowance (chosen so before the first chip run of
    this phase). A tile left out is shown
    to break the allowance. Then one hop held alone and timed
    (:func:`_flash_full_width`), and the hops' kernels by the profiler.
    Returns (the hop's readings by kernel, launches)."""
    (b, h, h_kv, t, d), n, window = RING_SHAPES[key]
    tl = t // n
    q, k, v, _, _ = _flash_inputs((b, h, h_kv, t, t, d), torch.bfloat16,
                                  gen)
    wrappers = _flash_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    got = _ring_grads(q, k, v, n, window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    visited = sum(m is not None for idx in range(n)
                  for m in pr.ring_schedule(idx, n, tl, True, window))
    print(f"ring {key}: q [{b}, {h}, {t}, {d}], k/v [{b}, {h_kv}, {t}, {d}], "
          f"bf16, n {n} (t_local {tl}), window {window}: {visited} hops "
          f"visited, forward and backward {wall:.2f} s; launches {launches}")
    if launches != dict.fromkeys(wrappers, visited):
        raise AssertionError(f"ring {key}: launches {launches}, expected "
                             f"{visited} of each")

    mask = {} if window is None else {"window": window}
    with _plain_flash():
        plain = _ring_grads(q, k, v, n, window)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    whole = fa.flash_attention(*leaves, True, window=window)
    whole = (whole.detach(),) + torch.autograd.grad(
        (whole.float() ** 2).sum(), leaves)
    del leaves
    out32, _ = fa._flash_forward_plain(q.float(), k.float(), v.float(),
                                       **mask)
    dout = 2 * out32
    del out32
    ref, operands = _flash_f32_reference(q, k, v, dout, torch.zeros(
        b, h, t, device=DEV), mask)
    del dout
    outputs = ("out", "dq", "dk", "dv")
    allow = {o: _allowance(p, ref[o]) for o, p in zip(outputs, plain)}
    omitted = [_tile_omission(allow, operands, r0, c0, FLASH_MUTANT_TILE,
                              mask) for r0, c0 in RING_TILES[key]]
    del operands
    print("  worst row vs the f32 reference, relative to the row's "
          "largest value (ring through B1-B3, through their plain "
          "versions, whole-sequence flash_attention); the ring's worst "
          "error over its allowance (<= 1 passes); a tile left out, over "
          "the allowance (> 1 is seen); the ring's worst error over the "
          "allowance the whole-sequence call would set (read only)")
    for o, ring_o, plain_o, whole_o in zip(outputs, got, plain, whole):
        r = _bf16_reading(ring_o, plain_o, ref[o])
        w = _bf16_reading(ring_o, whole_o, ref[o])
        mutants = [m[o] for m in omitted]
        print(f"  {o}: {r['kernel']:.3e} (row {r['at']}), "
              f"{r['plain']:.3e}, {w['plain']:.3e}; {r['over']:.3f}; "
              + ", ".join(f"tile {r0},{c0} {m:.1f}"
                          for m, (r0, c0) in zip(mutants, RING_TILES[key]))
              + f"; {w['over']:.3f}")
        if not r["over"] <= 1.0:
            raise AssertionError(f"ring {key}: {o} off the f32 reference: "
                                 f"{r['over']} of its allowance")
        if not min(mutants) > 1.0:
            raise AssertionError(f"ring {key}: the allowance on {o} would "
                                 f"not see a tile left out ({mutants})")
    del ref, allow, plain, got, whole
    torch.cuda.empty_cache()

    shape, hop_mask, tiles = RING_HOP_CASES[key]
    print(f"one hop held alone: {shape} {hop_mask}")
    readings = _flash_full_width(gen, hop_mask, shape, tiles, grad_f32=True)
    split = _device_split(lambda: _ring_grads(q, k, v, n, window),
                          KERNEL_GROUPS)
    if split is None:
        print("  the profiler recorded no device time (ms per hop not "
              "measured)")
    else:
        busy, shares, _ = split
        print(f"  profiled, forward and backward of every hop: busy "
              f"{busy:.2f} ms; per hop " + ", ".join(
                  f"{g} {shares[g] / visited:.4f} ms"
                  for g, _ in KERNEL_GROUPS[:3])
              + f"; the rest (merges, slices, casts) "
              f"{(busy - sum(shares[g] for g, _ in KERNEL_GROUPS[:3])) / visited:.4f} ms")
    return readings, launches


def ring_hops_phase(card: str) -> dict:
    gen = torch.Generator().manual_seed(11)
    out = {}
    for key in RING_SHAPES:
        out[key] = _ring_shape_check(key, gen)
        torch.cuda.empty_cache()
    print(f"{card}: the ring's hops at both shapes")
    return out


@torch.no_grad()
def _bf16_ulps_apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in units of b's bf16 ulp (the spacing at |b|)."""
    b32 = b.float()
    exp = torch.floor(torch.log2(b32.abs().clamp_min(2.0 ** -126)))
    ulp = torch.exp2(exp - 7)
    return ((a.float() - b32).abs() / ulp).max().item()


def _sharded_step_cell(card: str, label: str, cfg, opt, mesh) -> None:
    """The training cell through the reference dryrun's calls on a
    one-rank mesh, against ``make_train_step(attn_fn=flash_attention)``
    on the same weights and batch: one untimed and three timed steps of
    each, the losses within TOL_SHARDED_LOSS_REL and the params after
    the four steps within one bf16 ulp."""
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=DEV)
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)
    ring = pr.make_ring_attention(mesh, axis_name="sp", batch_axes=("dp",),
                                  head_axis="tp")
    train_step, opt_init = tt.make_train_step(cfg, optimizer=opt,
                                              attn_fn=ring)
    p_shard = pm.param_shardings(mesh, params)
    z_shard = pm.zero1_opt_shardings(mesh, params, opt)
    s_params = pm.device_put(params, p_shard)
    s_batch = tuple(pm.device_put(x, pm.batch_sharding(mesh))
                    for x in batch)
    s_opt = opt_init(s_params, z_shard)
    step, init = tt.make_train_step(cfg, optimizer=opt,
                                    attn_fn=fa.flash_attention)
    state = init(params)
    first = (train_step(s_params, s_opt, s_batch)[2].item(),
             step(params, state, batch)[2].item())
    print(f"{label}: {tt.param_count(params) / 1e6:.1f}M params, set-up "
          f"and first steps {time.perf_counter() - t0:.1f} s; first loss "
          f"sharded {first[0]:.6f}, unsharded {first[1]:.6f}")
    s_ms, s_losses, s_launches, s_peak = _timed_steps(
        lambda: train_step(s_params, s_opt, s_batch)[2])
    _check_flash_launches(s_launches, cfg, f"sharded {label}")
    p_ms, p_losses, _, p_peak = _timed_steps(
        lambda: step(params, state, batch)[2])
    apart = max(_bf16_ulps_apart(a, c) for a, c in zip(
        tt._param_leaves(s_params), tt._param_leaves(params)))
    rel = [abs(x - y) / abs(y) for x, y in zip(
        (first[0], *s_losses), (first[1], *p_losses))]
    print(f"{card}: {label}, {TIMED_STEPS} steps of {b}x{t}: sharded step "
          f"(world 1, ring attention, ZeRO-1 layout) {s_ms:.2f} ms/step, "
          f"peak {s_peak / 2**30:.2f} GiB; make_train_step {p_ms:.2f} "
          f"ms/step, peak {p_peak / 2**30:.2f} GiB ({s_ms / p_ms - 1:+.2%}); "
          f"losses {s_losses} / {p_losses}, largest relative difference "
          f"{max(rel):.2e}; params {apart:.2f} bf16 ulps apart at most; "
          f"flash launches {s_launches}")
    if not max(rel) <= TOL_SHARDED_LOSS_REL:
        raise AssertionError(f"sharded {label}: losses {s_losses} against "
                             f"{p_losses}")
    if not apart <= 1.0:
        raise AssertionError(f"sharded {label}: params {apart} bf16 ulps "
                             f"from make_train_step's")
    _check_losses(first[0], s_losses, f"sharded {label}")


def sharded_step_phase(card: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = pm.build_mesh_spmd(device_type="cuda")
        _sharded_step_cell(card, "dense, default_optimizer()", FULL_TRAIN,
                           tt.default_optimizer(), mesh)
        torch.cuda.empty_cache()
        _sharded_step_cell(card, "MoE top-2, Adafactor", FULL_MOE_TRAIN,
                           tt.default_optimizer(kind="adafactor"), mesh)
    finally:
        dist.destroy_process_group()


# --------------------------------------------- phases 28-31 (fourth half)

# the GPipe train step at the training cell's widths, learned positions
# (the reference's pipeline adds pos_embed and its stages apply no RoPE)
# and no remat (the reference's stages take none)
PP_FULL = replace(FULL_TRAIN, use_rope=False, remat=False)
PP_MICRO = (1, 4)
# pp step over 4 microbatches against make_train_step on the whole
# batch: the same function, with cuBLAS's products at M = 2 x 2048 rows
# in place of 8 x 2048 and the stage's gradients summed in bf16 over the
# microbatches, so roundings fall otherwise. Params are held by their
# update: |pp - plain| over |plain - init|, both over every element of
# every leaf (a bf16 ulp is no unit here: AdamW's first update is
# lr x the gradient's sign, and a gradient within rounding of 0 flips
# it on a weight near 0, thousands of that weight's ulps). Each limit
# lies between the sound run's reading and those of the runs with three
# microbatches' gradients dropped or the outputs one slot on
# (tools/pp_fault_reading.py), nearer the sound one: on the H100 the
# loss read 1.2e-5 sound and 8.6e-2 and 9.4e-2 broken, the update
# 1.9e-2 sound and 1.10 and 1.22 broken (PERF.md).
TOL_PP_MICRO_LOSS_REL = 1e-4
TOL_PP_MICRO_UPDATE_REL = 0.1
# int8 generate under a (dp, tp) mesh of one rank at the generation
# cell: batch 8, prompt 2048, 32 steps
SHARDED_GEN_STEPS = 32
# sharded prefetch: batches of the prefetch phase's shape
SHARDED_PREFETCH_BATCHES = 4
# the device type of the fourth half's meshes (NCCL on the card)
MESH_DEVICE = "cuda"


def _clone(node):
    """A detached copy of a params tree on its device."""
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.detach().clone()


def _train_batch(cfg):
    b, t = FULL_TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab, (b, t),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    return tokens, tokens


def _update_rel(got: dict, want: dict, init: dict) -> float:
    """|got - want| over |want - init|, each the norm over every element
    of the trees' leaves (the same keys in all three), in f32."""
    apart = moved = 0.0
    for k in want:
        w = want[k].float()
        apart += (got[k].float() - w).square().sum().item()
        moved += (w - init[k].float()).square().sum().item()
    return (apart / moved) ** 0.5


def _pp_leaves(pp_params: dict) -> dict:
    """The pipeline layout's leaves by name: its stages' and the
    replicated ones."""
    out = {f"stages.{k}": v for k, v in pp_params["stages"].items()}
    out.update({k: pp_params[k] for k in ("embed", "pos_embed",
                                          "final_norm_g")})
    return out


def pipeline_phase(card: str, micro=PP_MICRO) -> None:
    """Phase 28: ``make_pp_train_step`` over a pp axis of one rank at
    the training cell's widths through B1-B3, against ``make_train_step``
    on the same weights and batch: with one microbatch the losses within
    TOL_SHARDED_LOSS_REL and the params within one bf16 ulp after the
    four steps, with four the losses within TOL_PP_MICRO_LOSS_REL and
    the params' update within TOL_PP_MICRO_UPDATE_REL (``micro``: the
    microbatch counts to run)."""
    t0 = time.perf_counter()
    params = init_params(PP_FULL, 0, device=DEV)
    batch = _train_batch(PP_FULL)
    mesh = DeviceMesh(MESH_DEVICE, torch.tensor([0]),
                      mesh_dim_names=("pp",))
    step, init = tt.make_train_step(PP_FULL, attn_fn=fa.flash_attention)
    plain = _clone(params)
    state = init(plain)
    first = step(plain, state, batch)[2].item()
    p_ms, p_losses, p_launches, p_peak = _timed_steps(
        lambda: step(plain, state, batch)[2])
    want = pp.stack_layers(tt.unstack_layer_params(plain)["layers"], 1)
    want_all = _pp_leaves(pp.params_to_pp(plain, 1))
    init_all = _pp_leaves(pp.params_to_pp(params, 1))
    print(f"{card}: GPipe, the training cell with learned positions and no "
          f"remat ({tt.param_count(params) / 1e6:.1f}M params, batch "
          f"{FULL_TRAIN_BATCH[0]}x{FULL_TRAIN_BATCH[1]}, AdamW(1e-3), "
          f"flash attention), set-up {time.perf_counter() - t0:.1f} s; "
          f"make_train_step {p_ms:.2f} ms/step, peak {p_peak / 2**30:.2f} "
          f"GiB, losses {[first] + p_losses}; flash launches {p_launches}")
    for n_micro in micro:
        pp_params = _clone(pp.params_to_pp(params, 1))
        pp_params = pm.device_put(pp_params,
                                  pp.pp_param_shardings(mesh, pp_params))
        pp_step, pp_init = pp.make_pp_train_step(
            mesh, PP_FULL, 1, n_micro, attn_fn=fa.flash_attention)
        pp_state = pp_init(pp_params)
        pp_first = pp_step(pp_params, pp_state, batch)[2].item()
        ms, losses, launches, peak = _timed_steps(
            lambda: pp_step(pp_params, pp_state, batch)[2])
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            [pp_first] + losses, [first] + p_losses))
        apart = max([_bf16_ulps_apart(pp_params["stages"][k][0], want[k][0])
                     for k in want] + [_bf16_ulps_apart(
                         pp_params[k], plain[k]) for k in ("embed",
                                                           "pos_embed")]
                    + [_bf16_ulps_apart(pp_params["final_norm_g"],
                                        plain["final_norm"]["g"])])
        update = _update_rel(_pp_leaves(pp_params), want_all, init_all)
        expect = {name: PP_FULL.n_layers * n_micro * TIMED_STEPS
                  for name in ("flash_forward", "flash_backward_dq",
                               "flash_backward_dkv")}
        tol = TOL_SHARDED_LOSS_REL if n_micro == 1 else TOL_PP_MICRO_LOSS_REL
        print(f"{card}: GPipe pp=1, {n_micro} microbatch(es): {ms:.2f} "
              f"ms/step ({ms / p_ms - 1:+.2%} against make_train_step), "
              f"peak {peak / 2**30:.2f} GiB; losses {[pp_first] + losses}, "
              f"largest relative difference {rel:.3e} (allowed {tol:.0e}); "
              f"params {apart:.2f} bf16 ulps apart at most, their update "
              f"{update:.3e} apart relative to its size"
              + ("" if n_micro == 1 else
                 f" (allowed {TOL_PP_MICRO_UPDATE_REL:.0e})")
              + f"; flash launches {launches} ({PP_FULL.n_layers} x "
              f"{n_micro} a step)")
        if launches != expect:
            raise AssertionError(f"GPipe: flash kernels launched {launches}, "
                                 f"expected {expect}")
        if not rel <= tol:
            raise AssertionError(f"GPipe, {n_micro} microbatch(es): losses "
                                 f"{losses} against {p_losses}")
        if n_micro == 1 and not apart <= 1.0:
            raise AssertionError(f"GPipe: params {apart} bf16 ulps from "
                                 f"make_train_step's")
        if n_micro > 1 and not update <= TOL_PP_MICRO_UPDATE_REL:
            raise AssertionError(f"GPipe, {n_micro} microbatches: the "
                                 f"params' update {update:.3e} apart from "
                                 f"make_train_step's, relative to its size")
        _check_losses(pp_first, losses, f"GPipe, {n_micro} microbatch(es)")
        del pp_params, pp_state
        torch.cuda.empty_cache()


def _teacher_forced(params, cfg, tokens, t0, mesh=None):
    """Logits of the prefill and of each decode step over ``tokens``."""
    cache = init_kv_cache(cfg, tokens.shape[0], tokens.shape[1],
                          device=DEV, mesh=mesh)
    logits, cache, _ = block_prefill(params, cfg, cache, tokens[:, :t0],
                                     mesh=mesh)
    out = [logits]
    for pos in range(t0, tokens.shape[1] - 1):
        logits, cache = decode_step(params, cfg, cache, pos, tokens[:, pos],
                                    mesh=mesh)
        out.append(logits)
    return torch.stack(out, 1)


def sharded_generation_phase(card: str, mesh) -> None:
    """Phase 29: int8 ``generate`` under the (dp, tp) mesh of one rank at
    the generation cell against the unsharded int8 ``generate`` on the
    same params: tokens equal, the teacher-forced logits of every step
    equal, B5's launches equal; device ms per decode step of each,
    timed in both orders."""
    b, t0 = GEN_FULL_RUN["b"], GEN_FULL_RUN["prompt_len"]
    steps = SHARDED_GEN_STEPS
    params = quantize_params(init_params(GEN_FULL, 0, device=DEV))
    prompt = torch.randint(0, GEN_FULL.vocab, (b, t0),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(DEV)
    local = pm.device_put(params, pm.param_shardings(mesh, params))
    rows = pm.device_put(prompt, pm.NamedSharding(mesh, ("dp", None)))
    runs = {"sharded": lambda n: generate(local, GEN_FULL, rows, steps=n,
                                          mesh=mesh),
            "unsharded": lambda n: generate(params, GEN_FULL, prompt,
                                            steps=n)}
    out, launches = {}, {}
    for label, run in runs.items():
        da.flash_decode_attention.launches = 0
        with no_device_waits():
            out[label] = run(steps)
        torch.cuda.synchronize()
        launches[label] = da.flash_decode_attention.launches
    # each timed first and second (A B B A), so an order effect shows
    ms = {label: [] for label in runs}
    for label in ("sharded", "unsharded", "unsharded", "sharded"):
        long_ = timing.device_seconds_total(lambda: runs[label](steps))
        short = timing.device_seconds_total(lambda: runs[label](1))
        ms[label].append(1e3 * (long_ - short) / (steps - 1))
    logits = {"sharded": _teacher_forced(local_params(local, GEN_FULL, mesh),
                                         GEN_FULL, out["sharded"], t0, mesh),
              "unsharded": _teacher_forced(params, GEN_FULL,
                                           out["sharded"], t0)}
    same_tokens = torch.equal(out["sharded"], out["unsharded"])
    same_logits = _bits_equal(logits["sharded"], logits["unsharded"])
    expect = GEN_FULL.n_layers * (steps - 1)
    print(f"{card}: int8 generate under the (dp 1, tp 1) mesh, batch {b}, "
          f"prompt {t0}, {steps} steps: device ms per decode step, "
          f"sharded {ms['sharded'][0]:.3f} then unsharded "
          f"{ms['unsharded'][0]:.3f}, unsharded {ms['unsharded'][1]:.3f} "
          f"then sharded {ms['sharded'][1]:.3f} (PERF.md section 5: int8 "
          f"weights 2.61-2.66 ms at the 1056-step chain's longer reads); "
          f"tokens equal {same_tokens}, the {steps} steps' "
          f"teacher-forced logits bit-equal {same_logits}; B5 launches "
          f"{launches} (expected {expect} each)")
    if not same_tokens or not same_logits:
        raise AssertionError("sharded int8 generate differs from the "
                             "unsharded one")
    if set(launches.values()) != {expect}:
        raise AssertionError(f"B5 launched {launches} times, expected "
                             f"{expect} each")


def sharded_engine_phase(card: str, mesh) -> None:
    """Phase 30: the engine with its pools holding the rank's kv heads
    and tp-sharded params at the serving cell, against the solo engine:
    tokens identical, B4's launches the same (570)."""
    params = init_params(FULL, 3, device=DEV)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, FULL.vocab, n)]
               for n in FULL_PROMPT_LENS]
    local = pm.device_put(params, pm.param_shardings(mesh, params))
    runs = {"sharded": lambda: ServingEngine(
                local, FULL, device=DEV, mesh=mesh, **FULL_ENGINE),
            "solo": lambda: ServingEngine(params, FULL, device=DEV,
                                          **FULL_ENGINE)}
    got, launches = {}, {}
    for label, make in runs.items():
        eng = make()
        if label == "sharded":
            pool = tuple(eng.pool_ks[0].shape)
        pa.paged_decode_attention.launches = 0
        got[label] = eng.run(prompts, FULL_NEW_TOKENS)
        torch.cuda.synchronize()
        launches[label] = pa.paged_decode_attention.launches
    n_tok = sum(len(o) for o in got["sharded"].values())
    dev_s = timing.device_seconds_total(
        lambda: runs["sharded"]().run(prompts, FULL_NEW_TOKENS))
    expect = (FULL_NEW_TOKENS - 1) * FULL.n_layers
    print(f"{card}: the kv-head-sharded engine (tp 1: pools {pool}), "
          f"{len(prompts)} prompts x {FULL_NEW_TOKENS} new tokens: "
          f"{n_tok / dev_s:.1f} tokens/s by device time; tokens identical "
          f"to the solo engine's {got['sharded'] == got['solo']}; B4 "
          f"launches {launches} (expected {expect} each)")
    if got["sharded"] != got["solo"]:
        raise AssertionError("the kv-head-sharded engine's tokens differ "
                             "from the solo engine's")
    if set(launches.values()) != {expect}:
        raise AssertionError(f"B4 launched {launches} times, expected "
                             f"{expect} each")


def _sharded_seq2seq_check(card: str, mesh) -> None:
    t0 = time.perf_counter()
    params = s2s.init_seq2seq_params(FULL_S2S, 0, device=DEV)
    b, ts, tt_ = FULL_S2S_BATCH
    gen = torch.Generator().manual_seed(2)
    src = torch.randint(1, FULL_S2S.vocab, (b, ts), generator=gen,
                        dtype=torch.int32).to(DEV)
    tgt = torch.randint(1, FULL_S2S.vocab, (b, tt_), generator=gen,
                        dtype=torch.int32).to(DEV)
    local = pm.device_put(params, s2s.seq2seq_param_shardings(mesh, params))
    rows = pm.NamedSharding(mesh, ("dp", None))
    with torch.no_grad():
        want = s2s.seq2seq_loss_fn(params, (src, tgt), FULL_S2S,
                                   attn_fn=fa.flash_attention)
        got = s2s.seq2seq_loss_fn(local, (pm.device_put(src, rows),
                                          pm.device_put(tgt, rows)),
                                  FULL_S2S, attn_fn=fa.flash_attention,
                                  mesh=mesh)
    same = _bits_equal(got, want)
    print(f"{card}: the sharded seq2seq loss at the full-width seq2seq "
          f"configuration (seq2seq_param_shardings, dp 1 tp 1): "
          f"{got.item()!r} against the unsharded {want.item()!r}, "
          f"bit-equal {same}; {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("the sharded seq2seq loss differs from the "
                             "unsharded one")
    del params, local
    torch.cuda.empty_cache()


def _reshard_checkpoint_check(card: str, mesh) -> None:
    """Phase 27's dense cell (ZeRO-1 shardings, ring attention) after one
    step, saved from the mesh, restored onto the mesh and onto the card
    alone (both bit-equal), and one step from the mesh-restored state
    bit-identical to the continuation."""
    opt = tt.default_optimizer()
    params = init_params(FULL_TRAIN, 0, device=DEV)
    ring = pr.make_ring_attention(mesh, axis_name="sp", batch_axes=("dp",),
                                  head_axis="tp")
    step, init = tt.make_train_step(FULL_TRAIN, optimizer=opt, attn_fn=ring)
    p_shard = pm.param_shardings(mesh, params)
    z_shard = pm.zero1_opt_shardings(mesh, params, opt)
    s_params = pm.device_put(params, p_shard)
    del params
    s_opt = init(s_params, z_shard)
    batch = tuple(pm.device_put(x, pm.batch_sharding(mesh))
                  for x in _train_batch(FULL_TRAIN))
    # two steps: the warm-up's first rate is 0, its second is not
    for _ in range(2):
        step(s_params, s_opt, batch)
    state = {"params": s_params, "opt": s_opt}
    shardings = {"params": p_shard}
    tensors = _state_tensors(state)
    n_bytes = sum(t.numel() * t.element_size() for _, t in tensors)
    ck_dir = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_train_state(ck_dir, 2, state, shardings=shardings)
        save_s = time.perf_counter() - t0
        abstract = abstract_like(state, shardings=shardings)
        back, seconds = {}, {}
        for label, skel in (("mesh", abstract),
                            ("card alone", on_one_device(abstract, DEV))):
            t0 = time.perf_counter()
            back[label] = restore_train_state(ck_dir, skel)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"{card}: the sharded dense cell's state (ZeRO-1 layout, "
          f"{len(tensors)} tensors, {n_bytes / 1e9:.3f} GB) saved from the "
          f"mesh in {save_s:.2f} s; restored onto the mesh in "
          f"{seconds['mesh']:.2f} s, onto the card alone in "
          f"{seconds['card alone']:.2f} s")
    for label, got in back.items():
        got_t = dict(_state_tensors(got))
        bad = [name for name, t in tensors
               if name not in got_t or not _bits_equal(t.cpu(),
                                                       got_t[name].cpu())]
        print(f"  restored onto the {label}: {len(tensors) - len(bad)} of "
              f"{len(tensors)} tensors bit-equal; optimizer layout "
              f"{'kept' if got['opt'].layout is not None else 'none'}")
        if bad or (got["opt"].layout is None) != (label != "mesh"):
            raise AssertionError(f"checkpoint restored onto the {label} "
                                 f"differs in {bad[:5]}")
    restored = back.pop("mesh")
    del back
    _, _, loss_cont = step(s_params, s_opt, batch)
    _, _, loss_res = step(restored["params"], restored["opt"], batch)
    same = [_bits_equal(a, c) for a, c in zip(
        tt._param_leaves(s_params), tt._param_leaves(restored["params"]))]
    print(f"  one step on: continuation loss {loss_cont.item()!r}, resumed "
          f"{loss_res.item()!r}; parameters bit-equal {sum(same)} of "
          f"{len(same)}")
    if loss_cont.item() != loss_res.item() or not all(same):
        raise AssertionError("the step resumed from the mesh-restored "
                             "state differs from the continuation")
    del state, restored, s_params, s_opt
    torch.cuda.empty_cache()


def _sharded_prefetch_check(card: str, mesh) -> None:
    batches, sums = _prefetch_source(SHARDED_PREFETCH_BATCHES)
    got = [x.double().sum() for x in data.prefetch_to_device(
        iter(batches), sharding=pm.batch_sharding(mesh))]
    got = torch.stack(got).cpu().tolist()
    print(f"{card}: prefetch_to_device with sharding=batch_sharding(mesh) "
          f"(dp 1), {len(batches)} batches: device sums equal to the "
          f"host's {got == sums}")
    if got != sums:
        raise AssertionError("sharded prefetch read other values than the "
                             "host's")


def sharded_state_phase(card: str, mesh) -> None:
    """Phase 31: the sharded seq2seq loss, the reshard round trip,
    sharded prefetch and the dryrun."""
    _sharded_seq2seq_check(card, mesh)
    _reshard_checkpoint_check(card, mesh)
    _sharded_prefetch_check(card, mesh)
    t0 = time.perf_counter()
    entry.dryrun_multichip(1, device=DEV)
    print(f"{card}: dryrun_multichip(1) over NCCL in "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------- phase 32 (fifth half)

# Head dim 256: Gemma-2B's attention geometry (google/gemma-2b's
# config.json: 8 query heads, 1 KV head, head_dim 256) at the training
# cell's widths (vocab 8192, d_model 2048, d_ff 8192, 8 layers, RoPE,
# bf16). h * d is 2048 as in the training cell, so its attention does the
# same operations and B1-B3's bounds are the same.
HD256 = replace(FULL_TRAIN, n_heads=8, n_kv_heads=1)
# ... for generation and serving: the generation cell's cache length
HD256_GEN = replace(GEN_FULL, n_heads=8, n_kv_heads=1)
# generate at b 8, prompt 2048: chains of 8 and 32 new tokens (the wall
# per step is marginal between them), the long one against the eager loop
HD256_GEN_RUN = dict(b=8, prompt_len=2048, gen_short=8, gen_long=32)
# B1-B3 at one attention call of HD256's training step
FLASH_HD256 = (8, 8, 1, 2048, 2048, 256)
# the mask forms of phase 4 at head dim 256, and head dims 160 and 192,
# which run the <256> instantiations with the columns past d zero-filled;
# bf16 row by row against the f32 reference, f32 against the plain
# versions
FLASH_BF16_CASES_HD256 = {
    "causal_d256": ((2, 4, 2, 256, 256, 256), {}),
    "causal_gqa_8to1_d256": ((1, 8, 1, 256, 256, 256), {}),
    "window_d256": ((1, 4, 2, 256, 256, 256), dict(window=48)),
    "window_row_offset_empty_rows_d256": ((1, 2, 1, 128, 128, 256),
                                          dict(window=32, row_offset=64)),
    "noncausal_tkv_ne_t_d256": ((1, 4, 2, 128, 320, 256),
                                dict(causal=False)),
    "causal_ragged_192_d256": ((1, 4, 1, 192, 192, 256), {}),
    "causal_d160": ((1, 4, 2, 256, 256, 160), {}),
    "window_d192": ((1, 4, 2, 256, 256, 192), dict(window=48)),
}
FLASH_CASES_HD256 = {
    "causal_gqa_4to1_d256": ((1, 4, 1, 256, 256, 256), {}),
    "window_row_offset_empty_rows_d256": ((1, 2, 1, 128, 128, 256),
                                          dict(window=32, row_offset=64)),
}
# B5 at the HD256 generation read: (b, h, h_kv, L, hd), pos 2048; bf16
# queries take the tensor-core kernel <256> (f32 ones the FMA kernel)
DECODE_HD256 = (8, 8, 1, 3200, 256)
# the kernels the HD256 reads must run, by the profiler's names
HD256_DECODE_KERNEL = "flash_decode_split_mma_kernel"
HD256_PAGED_KERNEL = "paged_decode_split_mma_kernel"
# the <256> instantiations each source builds, none of which may spill:
# B1-B3's, B5's tensor-core kernel over bf16 and int8 caches, B4's
# tensor-core kernel
HD256_INSTANTIATIONS = {"flash_attention": 3, "decode_attention": 2,
                        "paged_attention": 1}
# one past every kernel's largest head dim: each wrapper must refuse it
REFUSED_HEAD_DIM = 272


def _refusal_probe() -> None:
    """d = REFUSED_HEAD_DIM on the card: each wrapper raises ValueError
    naming it, and launches nothing."""
    d = REFUSED_HEAD_DIM
    x = torch.zeros((1, 1, 128, d), dtype=torch.bfloat16, device=DEV)
    row = torch.zeros((1, 1, 128), dtype=torch.float32, device=DEV)
    q1 = torch.zeros((1, 1, 1, d), dtype=torch.bfloat16, device=DEV)
    pool = torch.zeros((2, 1, 16, d), dtype=torch.bfloat16, device=DEV)
    table = torch.ones((1, 2), dtype=torch.int32, device=DEV)
    lens = torch.ones((1,), dtype=torch.int32, device=DEV)
    calls = {
        fa.flash_forward: lambda: fa.flash_forward(x, x, x),
        fa.flash_backward_dq: lambda: fa.flash_backward_dq(x, x, x, x, row,
                                                           row),
        fa.flash_backward_dkv: lambda: fa.flash_backward_dkv(x, x, x, x, row,
                                                             row),
        pa.paged_decode_attention: lambda: pa.paged_decode_attention(
            q1, pool, pool, table, lens, 1),
        da.flash_decode_attention: lambda: da.flash_decode_attention(
            q1, x, x, 0),
    }
    for wrapper, call in calls.items():
        before = wrapper.launches
        try:
            call()
        except ValueError as e:
            if str(d) not in str(e) or wrapper.launches != before:
                raise AssertionError(f"{wrapper.__name__} refused head dim "
                                     f"{d} for another reason: {e}")
            print(f"  {wrapper.__name__}, head dim {d}: ValueError: {e}")
            continue
        raise AssertionError(f"{wrapper.__name__} took head dim {d}")


def hd256_kernel_phase(gen) -> dict:
    """B1-B3 over the mask forms at head dim 256 (and 160, 192) in f32
    and bf16, then at HD256's full-width training shape; B5 (bf16 and
    int8 caches) and B4 (also at its chunks' edges) at the HD256 reads,
    on their tensor-core kernels: each held against its plain version,
    timed by events and by the profiler (whose kernel names must show
    those kernels), with its bound and library yardstick; d = 272 refused
    by every wrapper."""
    for name, (shape, mask) in FLASH_CASES_HD256.items():
        _flash_f32_case(name, shape, mask, gen)
    for name, (shape, mask) in FLASH_BF16_CASES_HD256.items():
        _flash_bf16_case(name, shape, mask, gen)
    torch.cuda.empty_cache()
    flash = _flash_full_width(gen, {}, FLASH_HD256)
    torch.cuda.empty_cache()

    h_kv, hd = DECODE_HD256[2], DECODE_HD256[4]
    pos = DECODE_BF16_POS[0]
    errs = [_decode_check(f"bf16 hd {hd}", *_decode_inputs(
                DECODE_HD256, torch.bfloat16, gen), pos),
            _decode_check(f"int8 cache, bf16 q, hd {hd}", *_decode_inputs(
                DECODE_HD256, torch.bfloat16, gen, int8=True), pos)]
    _decode_check(f"f32 hd {hd}", *_decode_inputs(
        DECODE_HD256, torch.float32, gen), pos)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=DEV)
    decode = _decode_readings(gen, flush, pos, DECODE_HD256)

    shape = dict(h_kv=h_kv, hd=hd)
    paged_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        paged_err[dtype] = _paged_check(
            f"serving lens, h_kv {h_kv}, hd {hd}",
            paged_inputs(dtype, gen, **shape),
            mutant=dtype == torch.bfloat16)
    for name, (block_t, lens) in PAGED_EDGE_CASES_HD256.items():
        n_live = 1 << (-(-max(lens) // block_t) - 1).bit_length()
        _paged_check(f"{name} (block_t {block_t}, lens {lens}, {n_live} "
                     f"blocks walked, h_kv {h_kv}, hd {hd})",
                     paged_inputs(torch.bfloat16, gen, block_t, lens, n_live,
                                  **shape))
    paged = _paged_readings(gen, flush, **shape)
    # short kernels on one clock, after the phase's event readings; the
    # profiler's names show which kernel each read ran
    ran = _decode_profile(gen, flush, pos, DECODE_HD256)
    paged_ran = _paged_profile(gen, flush, **shape)["B4"]
    del flush
    for key in ("bf16 split", "int8 split"):
        if HD256_DECODE_KERNEL not in ran.get(key, ("",))[0]:
            raise AssertionError(f"B5 at hd {hd} ({key}) ran "
                                 f"{ran.get(key)}, not {HD256_DECODE_KERNEL}")
    if not any(HD256_PAGED_KERNEL in name for name in paged_ran):
        raise AssertionError(f"B4 at hd {hd} ran {paged_ran}, not "
                             f"{HD256_PAGED_KERNEL}")
    torch.cuda.empty_cache()
    _refusal_probe()
    return {"flash": flash,
            "decode": {"max_abs_err": max(errs), **decode["bf16"]},
            "decode_int8": {"max_abs_err": errs[1], **decode["int8"]},
            "paged": {"max_abs_err": paged_err[torch.bfloat16], **paged}}


def hd256_training_phase(card: str, flash: dict) -> dict:
    """Three timed steps of HD256 (remat "dots", scan_layers, 8 x 2048,
    ``default_optimizer()``, flash attention): ms, peak, B1-B3 launches,
    finite falling losses; one more step split by kernel group."""
    params = init_params(HD256, 0, device=DEV)
    n_params = tt.param_count(params)
    b, t = FULL_TRAIN_BATCH
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, HD256.vocab, (b, t), generator=gen,
                           dtype=torch.int32).to(DEV)
    batch = (tokens, tokens)       # as the reference's training benchmark
    step, init = tt.make_train_step(HD256, optimizer=tt.default_optimizer(),
                                    attn_fn=fa.flash_attention)
    state = init(params)
    params, state, loss = step(params, state, batch)    # untimed
    first = loss.item()
    step_ms, losses, launches, peak = _timed_steps(
        lambda: step(params, state, batch)[2])
    print(f"{card}: HD256 ({n_params / 1e6:.1f}M params, {HD256.n_heads} "
          f"heads over {HD256.n_kv_heads} KV head, head dim "
          f"{HD256.d_model // HD256.n_heads}), {TIMED_STEPS} steps of "
          f"{b}x{t}: {step_ms:.2f} ms/step (device events), "
          f"{b * t / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; losses {[first] + losses}")
    for name, _ in FLASH_KERNELS:
        per_step = launches[name] / TIMED_STEPS
        share = per_step * flash[name]["ms"] / step_ms
        print(f"  {name}: {launches[name]} launches ({per_step:g} per "
              f"step) x {flash[name]['ms']:.3f} ms = {100 * share:.1f}% of "
              f"the step")
    _check_flash_launches(launches, HD256, "HD256 training")
    _check_losses(first, losses, "HD256 training")
    if not losses[-1] < first:
        raise AssertionError(f"HD256 training: the loss does not fall "
                             f"({[first] + losses})")
    _profile_step(lambda: step(params, state, batch), step_ms)
    return launches


def hd256_generation_phase(card: str) -> int:
    """``generate`` on HD256_GEN at b 8, prompt 2048: the long chain's
    replays against the eager loop (equal tokens, or partings at near
    ties), B5's launches per call, and its decode steps' device time by
    kernel group. Returns B5's launches over the long-chain call."""
    run = HD256_GEN_RUN
    cfg = HD256_GEN
    b, t0 = run["b"], run["prompt_len"]
    short, long_ = run["gen_short"], run["gen_long"]
    max_t = cfg.max_seq              # the cache of DECODE_HD256's read
    params = init_params(cfg, 0, device=DEV)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (b, t0), generator=gen,
                           dtype=torch.int32).to(DEV)
    generate(params, cfg, prompt, steps=short, max_t=max_t)   # warm-up
    walls, outs = {}, {}
    for n in (short, long_):
        torch.cuda.synchronize()
        da.flash_decode_attention.launches = 0
        StepGraph.captures = 0
        start = time.perf_counter()
        with no_device_waits():
            outs[n] = generate(params, cfg, prompt, steps=n, max_t=max_t)
        torch.cuda.synchronize()
        walls[n] = time.perf_counter() - start
        launches, captures = da.flash_decode_attention.launches, \
            StepGraph.captures
    wall_step = (walls[long_] - walls[short]) / (long_ - short)
    out = outs[long_]
    expect = cfg.n_layers * (long_ - 1)
    eager, eager_wall, eager_logits = _eager_chain(params, cfg, prompt,
                                                   long_, max_t)
    parts = _partings(out[:, t0:].cpu(), eager[:, t0:].cpu(), eager_logits)
    del eager_logits
    print(f"{card}, HD256 generate: {b} x {long_} tokens after a {t0}-token "
          f"prompt in {walls[long_]:.3f} s wall, {1e3 * wall_step:.3f} "
          f"ms/step (marginal between {short} and {long_} steps), under "
          f"sync-debug mode; B5 launches {launches} (expected {expect}), "
          f"{captures} capture(s); the eager chain {eager_wall:.3f} s; "
          f"replayed tokens equal to the eager ones: {not parts}"
          + "".join(f"; row {r_} parts at step {j} ({sl:.2e} of the "
                    f"largest |logit| below the eager top)"
                    for r_, j, sl in parts))
    if out.shape != (b, t0 + long_) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError("HD256: malformed generation output")
    if not torch.equal(outs[short], out[:, :t0 + short]):
        raise AssertionError("HD256: the short chain's tokens are not a "
                             "prefix of the long chain's")
    if any(sl > TOL_TIE_REL for _, _, sl in parts):
        raise AssertionError("HD256: the replayed chain parts from the "
                             "eager one where no near-tie is")
    if launches != expect or captures != 1:
        raise AssertionError(f"HD256: B5 launched {launches} times per "
                             f"generate call, expected {expect}, or "
                             f"{captures} captures, expected 1")
    eager_ms = _profile_decode(params, cfg, prompt, max_t, wall_step)
    print(f"  HD256 decode step: {eager_ms:.3f} device ms (eager, "
          f"{PROFILED_DECODE_STEPS} steps from position {t0})")
    return launches


def hd256_serving_phase(card: str) -> int:
    """The serving cell's run at HD256_GEN's weights (B4 at h_kv 1, hd
    256) with phase 7's checks, then once more under the profiler for
    its device tokens/s and B4's share. Returns B4's launches."""
    served = full_width_phase(card, HD256_GEN)
    params = init_params(HD256_GEN, 3, device=DEV)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, HD256_GEN.vocab, n)]
               for n in FULL_PROMPT_LENS]
    eng = ServingEngine(params, HD256_GEN, device=DEV, **FULL_ENGINE)
    busy = _profile_step(lambda: eng.run(prompts, FULL_NEW_TOKENS),
                         served["wall_ms"], SERVING_KERNEL_GROUPS,
                         "HD256 serving run")
    n_tok = len(FULL_PROMPT_LENS) * FULL_NEW_TOKENS
    print(f"  HD256 serving: {n_tok} tokens, "
          + (f"{1e3 * n_tok / busy:.1f} tokens/s by device time"
             if busy else "device time not measured"))
    return served["launches"]


HALF = "--half"
READINGS = "chip_smoke readings: "


def _card(quiet: bool = False) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if not quiet:
        print(smi)
    return smi


def first_half(smi: str) -> dict:
    """Phases 3-20: the serving, generation and training paths and the
    families on them. Returns the kernels' readings."""
    phase("paged kernel vs plain version, full-width shapes")
    gen = torch.Generator().manual_seed(0)
    kern = kernel_phase(gen)

    phase("flash kernels vs plain versions")
    flash = flash_phase(gen)

    phase("flash-decode kernel vs plain version, full-width shapes")
    decode = decode_kernel_phase(gen)

    phase("engine on the card vs on the CPU (fp32, small)")
    small_engine_phase()

    phase("full-width serving")
    served = full_width_phase(smi)
    serving_throughput_phase(smi, served["wall_ms"])

    phase("generation on the card vs on the CPU (fp32, small)")
    small_generation_phase()

    phase("full-width generation")
    decode_launches = full_width_generation_phase(smi)

    phase("training on the card vs on the CPU (fp32, small)")
    small_training_phase()

    phase("full-width training")
    launches = full_width_training_phase(smi, flash)

    phase("MoE, Adafactor, LoRA and MLM on the card vs on the CPU "
          "(fp32, small)")
    small_moe_lora_mlm_phase(smi)

    phase("full-width MLM")
    full_width_mlm_phase(smi)

    phase("full-width LoRA")
    full_width_lora_phase(smi)

    phase("full-width MoE generation")
    # held in a list so that the training phase, which restacks them, has
    # the only reference to the generation layout's params
    moe_params = [full_width_moe_generation_phase(smi)]

    phase("full-width MoE training")
    full_width_moe_training_phase(smi, moe_params.pop())

    phase("seq2seq, beam and speculative on the card vs on the CPU "
          "(fp32, small)")
    small_seq2seq_beam_spec_phase(smi)

    phase("full-width seq2seq")
    full_width_seq2seq_phase(smi)

    phase("full-width beam search")
    full_width_beam_phase(smi)

    phase("full-width speculative decoding")
    full_width_speculative_phase(smi)
    return {"paged": kern, "paged_launches": served["launches"],
            "flash": flash, "flash_launches": launches, "decode": decode,
            "decode_launches": decode_launches}


def second_half(smi: str) -> dict:
    """Phases 21-24: the input pipeline, checkpoint and profiling, the
    attention benchmarks, the real-data speculative bench and B4 per
    launch. Returns the benchmarks' kernel readings."""
    phase("data, checkpoint and profiling on the card against the CPU")
    data_checkpoint_profiling_phase(smi)

    phase("full-width attention benchmarks")
    benches = attention_benchmarks_phase(smi)

    phase("full-width real-data speculative decoding")
    full_width_real_data_phase(smi)

    phase("paged kernel per launch")
    paged_launch_phase(torch.Generator().manual_seed(0))
    return {"benches": benches}


def third_half(smi: str) -> dict:
    """Phases 25-27: the sharded training tier on the card, at world
    size 1 (the machine has one card): the collectives, the ring's hops
    at full width for every rank, and the sharded step. Returns the ring
    hops' kernel readings."""
    phase("collectives and meshes over an NCCL group of one rank")
    collectives_phase(smi)

    phase("the ring's hops at full width, every rank's")
    ring = ring_hops_phase(smi)

    phase("the sharded training step at world size 1, full width")
    sharded_step_phase(smi)
    return {"ring": ring}


def fourth_half(smi: str) -> dict:
    """Phases 28-31: the pipeline and the sharded inference and state
    callers at world size 1 (an NCCL group of one rank): the GPipe step,
    int8 generate under the (dp, tp) mesh, the kv-head-sharded engine,
    the sharded seq2seq loss, the reshard checkpoint, sharded prefetch
    and the dryrun. Their launches are printed here; the kernels' rows
    are the earlier phases'."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        phase("the GPipe train step at full width, pp = 1")
        pipeline_phase(smi)
        mesh = pm.build_mesh(device_type=MESH_DEVICE)

        phase("int8 generate under the (dp, tp) mesh, full width")
        sharded_generation_phase(smi, mesh)

        phase("the kv-head-sharded engine, full width")
        sharded_engine_phase(smi, mesh)

        phase("the sharded seq2seq loss, the reshard checkpoint, sharded "
              "prefetch and the dryrun")
        sharded_state_phase(smi, mesh)
    finally:
        dist.destroy_process_group()
    return {}


def fifth_half(smi: str) -> dict:
    """Phase 32: head dim 256. B1-B5 at the HD256 shapes, then HD256's
    training steps, ``generate`` and the serving engine. Returns the
    kernels' readings and their launches on those paths."""
    phase("head dim 256: the five kernels at the HD256 shapes")
    kernels = hd256_kernel_phase(torch.Generator().manual_seed(9))

    phase("head dim 256: HD256 training at full width")
    flash_launches = hd256_training_phase(smi, kernels["flash"])

    phase("head dim 256: HD256 generate at full width")
    decode_launches = hd256_generation_phase(smi)

    phase("head dim 256: the HD256 serving engine at full width")
    paged_launches = hd256_serving_phase(smi)
    return {**kernels, "flash_launches": flash_launches,
            "decode_launches": decode_launches,
            "paged_launches": paged_launches}


def _run_half(which: str) -> dict:
    """Runs phases ``which`` ("1": 3-20, "2": 21-24, "3": 25-27, "4":
    28-31, "5": 32) in a new process of this script, its output passed
    through; returns its readings, or raises when it failed."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), HALF, which],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, text=True)
    readings = None
    try:
        for line in proc.stdout:
            if line.startswith(READINGS):
                readings = json.loads(line[len(READINGS):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or readings is None:
        raise AssertionError(f"the phases of half {which} failed (exit "
                             f"code {rc})")
    return readings


def _half_main(which: str) -> int:
    # fp32 products in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card(quiet=True)
    readings = {"1": first_half, "2": second_half, "3": third_half,
                "4": fourth_half, "5": fifth_half}[which](smi)
    print(READINGS + json.dumps(readings), flush=True)
    return 0


def _kernel_row(name, source, replaces, launches, reading) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"tpu_dra_driver_torch/workloads/csrc/{source}",
            "replaces": replaces, "launches": launches,
            **{k: reading[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}


def _spills(log: str) -> dict:
    """{entry function: (spill store bytes, spill load bytes)} from
    ptxas's ``-v`` report in an nvcc log."""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name is not None:
            found[name] = (int(spill.group(1)), int(spill.group(2)))
    return found


# an sm90 flash kernel's mangled name: (kernel, head dim)
SM90_FLASH_KERNEL = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel_sm90)ILi(\d+)E")


def _wgmma_notes(log: str) -> dict:
    """{entry function: {code: count}} of ptxas's notes on its wgmma
    pipelines (C7510-C7520: a ``warpgroup.arrive`` or ``warpgroup.wait``
    it injected, or the products it serialised) in an nvcc log, {} for
    each entry function it compiled without one. A note belongs to the
    function it names, or else to the entry function being compiled."""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        note = re.search(r"\((C75(?:1\d|20))\)", line)
        if entry:
            name = entry.group(1)
            found.setdefault(name, {})
        elif note:
            named = re.search(r"function '([^']+)'", line)
            notes = found.setdefault(named.group(1) if named else name, {})
            notes[note.group(1)] = notes.get(note.group(1), 0) + 1
    return found


def _check_flash_build(log: str) -> None:
    """Every sm90 flash instantiation in flash_attention.cu's nvcc log
    (B1-B3, ``flash_{fwd,bwd_dq,bwd_dkv}_kernel_sm90<64, 128, 256>``)
    with its wgmma notes and spill bytes printed; each must have been
    built with no note at all (no injected arrive or wait, no serialised
    product) and no spill."""
    notes, spills = _wgmma_notes(log), _spills(log)
    bad, built = [], 0
    for fn in sorted(notes):
        kernel = SM90_FLASH_KERNEL.search(fn)
        if kernel is None:
            continue
        built += 1
        label = f"{kernel.group(1)}<{kernel.group(2)}>"
        other = {c: n for c, n in notes[fn].items() if c != "C7519"}
        print(f"{label}: {notes[fn].get('C7519', 0)} injected "
              f"warpgroup.arrive (C7519), other wgmma notes {other}, spill "
              f"bytes (stores, loads) {spills.get(fn)}")
        if notes[fn] or spills.get(fn) != (0, 0):
            bad.append(label)
    if bad or built != 9:
        raise AssertionError(f"the sm90 flash instantiations ({built} of 9 "
                             f"built) serialise their products or spill: "
                             f"{bad}")


def _check_hd256_spills(logs: dict) -> None:
    """Each source's <256> instantiations (HD256_INSTANTIATIONS, by
    source name; ``logs``: nvcc's output by source name) built, none of
    them spilling."""
    for source, want in HD256_INSTANTIATIONS.items():
        hd256 = {n: s for n, s in _spills(logs[source]).items()
                 if "Li256E" in n}
        print(f"{source}: <256> instantiations {len(hd256)}, spill bytes "
              f"(stores, loads) {sorted(hd256.values())}")
        if len(hd256) != want or any(s != (0, 0) for s in hd256.values()):
            raise AssertionError(f"{source} at head dim 256: {hd256}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == HALF:
        return _half_main(sys.argv[2])
    t_start = time.perf_counter()

    phase("card")
    smi = _card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("build")
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(_build.build, KERNEL_SOURCES))
    for path, seconds, log in built:
        print(f"{path.name}: nvcc {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("  " + line.strip())
    logs = {name: log for name, (_, _, log) in zip(KERNEL_SOURCES, built)}
    _check_hd256_spills(logs)
    _check_flash_build(logs["flash_attention"])

    first = _run_half("1")
    second = _run_half("2")
    third = _run_half("3")
    _run_half("4")
    fifth = _run_half("5")

    rows = [_kernel_row("paged_decode_attention (paged_decode_split_mma_"
                        "kernel<128> + paged_decode_merge_rows_kernel)",
                        "paged_attention.cu",
                        "tpu_dra_driver/workloads/ops/paged_attention.py:112",
                        first["paged_launches"], first["paged"])]
    for name, replaces in FLASH_KERNELS:
        rows.append(_kernel_row(name, "flash_attention.cu", replaces,
                                first["flash_launches"][name],
                                first["flash"][name]))
    # B1-B3 at the benchmarks' shapes, launches counted over the
    # benchmarks run at that shape
    for tag, key in (("flash_attention_tflops+train, b4 h8 t2048 d128 "
                      "causal", "mha"),
                     ("long_context+train, b1 h8 t16384 w2048 d128",
                      "long")):
        readings, counts = second["benches"][key]
        for name, replaces in FLASH_KERNELS:
            rows.append(_kernel_row(f"{name} ({tag})", "flash_attention.cu",
                                    replaces, counts[name], readings[name]))
    # B1-B3 at the ring's hop shapes, launches counted over every rank's
    # hops, forward and backward, at that ring's shape
    for tag, key in (("ring hop, b8 h16/4 t512 of 2048, n 4, no mask",
                      "train"),
                     ("ring hop, b1 h8 t2048 of 16384, n 8, window 2048, "
                      "row_offset 2048", "long")):
        readings, counts = third["ring"][key]
        for name, replaces in FLASH_KERNELS:
            rows.append(_kernel_row(f"{name} ({tag})", "flash_attention.cu",
                                    replaces, counts[name], readings[name]))
    rows.append(_kernel_row("flash_decode_attention", "decode_attention.cu",
                            "tpu_dra_driver/workloads/ops/decode_attention.py:73",
                            first["decode_launches"], first["decode"]))
    # the five at head dim 256 (phase 32), launches counted over HD256's
    # three training steps, its long-chain generate call and serving run
    for name, replaces in FLASH_KERNELS:
        rows.append(_kernel_row(f"{name} (hd256, b8 h8/1 t2048 d256 causal)",
                                "flash_attention.cu", replaces,
                                fifth["flash_launches"][name],
                                fifth["flash"][name]))
    rows.append(_kernel_row("paged_decode_attention (hd256, h8/1 d256: "
                            "paged_decode_split_mma_kernel<256> + "
                            "paged_decode_merge_rows_kernel)",
                            "paged_attention.cu",
                            "tpu_dra_driver/workloads/ops/paged_attention.py:112",
                            fifth["paged_launches"], fifth["paged"]))
    rows.append(_kernel_row("flash_decode_attention (hd256, b8 h8/1 L3200 "
                            "d256 pos 2048: flash_decode_split_mma_kernel"
                            "<256> + flash_decode_merge_kernel)",
                            "decode_attention.cu",
                            "tpu_dra_driver/workloads/ops/decode_attention.py:73",
                            fifth["decode_launches"], fifth["decode"]))
    print(json.dumps({"kernels": rows}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
