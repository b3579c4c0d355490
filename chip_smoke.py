#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; TF32 off for fp32 products;
  2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, started together); every entry function's
     registers, spills (none allowed) and shared memory, the HGMMA
     instructions of both products of the bf16 ``flash_attention`` at
     every padded width (16 to 512) in both its instantiations (16-byte
     copies or value by value) and the TF32 HMMA of the ``mlstm_scan``
     prefill in their SASS;
  3. hold each kernel against its plain PyTorch version on the card, fp32
     and bf16, over the repo's sweeps (with head-dim-256, GQA-16, 24-head
     MHA and head-dim-112 cases, then the shapes of the widened kernels:
     head dims 1 to 512, GQA groups past g·hd 2,048, state sizes 1 to 256,
     ragged channel counts, chunk 256, unaligned rows) and the public
     full widths (``*_FULL_WIDTH``: Phi-3-mini's prefill, StarCoder's and
     Falcon-7B's decode, Mamba-2-2.7B's scan, xLSTM-7B's mLSTM), each case
     one launch, and the serving paths' own shapes,
     gemma2's at head dim 256, qwen2-vl's (g 8) and qwen3-moe's (g 16) at
     head dim 128, musicgen's MHA and kimi-k2's (64/8 heads at head dim
     112, ragged kv_len) included (``mlstm_scan``: y, C and the normalizer
     n);
  4. full-width llama3.2-1b (16 layers) in fp32: the kernel path against
     the plain path on the prefill logits, 8 decode steps and the greedy
     tokens;
  5. serve llama3.2-1b in bf16 with ``generate`` (4 requests, 256-token
     prompts, 32 new tokens, max_len 512); the launch counters show that
     every prefill and decode attention went through the kernels;
  6. the continuous batcher with ``KernelDecode`` on the card, no drops;
  7. full-width xlstm-125m (12 layers) in fp32: kernel path against plain
     path layer by layer (``layer_parity``: the free-running paths of this
     model part by more than rounding at random init);
  8. serve xlstm-125m in bf16 as in phase 5; every mLSTM layer of the
     prefill and of each decode step went through ``mlstm_scan``; then the
     bf16 model's kernel path against its plain path layer by layer;
  9. full-width jamba-v0.1-52b cut to 1 of its 4 periods (8 layers) in
     fp32: kernel path against plain path layer by layer, then the
     free-running logits as in phase 4, with the expert choices that
     differ between the two paths counted;
 10. serve jamba-v0.1-52b cut to 2 periods (16 layers: 52 GB of bf16
     weights; all 32 layers would be 103 GB) in bf16 as in phase 5: every
     mamba layer went through ``mamba_scan``, both attention layers
     through the attention kernels; then its layers as in phase 9;
 11. train llama3.2-1b at full width (16 layers, fp32 parameters and
     moments, batch 1 x 4,096 tokens of the synthetic zipf stream,
     remat "full") through ``repro_torch.launch.train.train`` (MFU on
     the model FLOPs without recompute, and the executed FLOPs of the
     dry run's cost pass, which ``train_flops`` must equal), with
     deterministic algorithms on: the training forward (plain path, with
     grad) against the served forward through the kernels; the gradient
     against a central difference along a random unit direction; a
     6-step golden run whose loss falls; then a run with Cornus
     checkpoints over 4 hosts every 3 steps that crashes after host 0's
     vote in epoch 6, and its resume from epoch 3, whose losses must
     equal the golden run's.  The training path launches none of the
     four kernels: it differentiates the plain path, as the JAX package
     does;
11b. the same model and shape: one uncompressed and one int8-compressed
     step of ``steps.make_train_step`` from the same start state at step
     index 1 (equal losses), each step's ms and peak memory; the codes and
     scales the card made from the step's fp32 gradients (one scale per
     leaf of the JAX package's tree) must equal bit for bit the ones the
     CPU makes from the same gradients copied to the host, and each leaf's
     dequantization error must stay within half its scale; then
     ``make_host_mesh()`` over a one-rank NCCL group: a (1, 1) ("data",
     "model") mesh, llama3.2-1b's specs placed on it under each sharding
     profile, and one leaf redistributed by ``constrain`` through NCCL;
     the group is destroyed before phase 12;
11c. llama3.2-1b at full width on DTensor parameters over the (1, 1)
     NCCL mesh of ``make_host_mesh()``, under each sharding profile
     (``sharded_step_phase``): in fp32 one train step of
     ``steps.make_train_step(cfg, settings, rules)`` at step index 1 from
     ``init_model(seed 0, rules=)``, its loss and every updated parameter
     and moment held to the plain-tensor step's; then one int8-compressed
     train step (``TrainSettings(compress=CompressionConfig())``) from the
     same start state, plain and on DTensors, the DTensor step's loss,
     parameters and moments held to the plain compressed step's, its
     codes and scales (``CompressRecorder``, one per leaf of the JAX
     package's tree) to the plain step's bit for bit, every scale finite
     and every gradient handed to AdamW placed as its parameter; each
     train step's ms and peak memory printed (the uncompressed DTensor
     step timed once more after the compressed one); in bf16 a prefill of
     4 x 256 and 4 decode steps through the kernel path
     (``make_prefill_step`` / ``make_decode_step`` under the rules), the
     logits held to the same weights' plain-tensor kernel run, with
     ``flash_attention`` and ``flash_decode`` launched on the DTensors'
     local shards (path "llama3.2-1b sharded").  Bit for bit is
     expected; a difference is printed and held to fp32 2e-5 / bf16
     3e-2.  The group is destroyed after;
11d. qwen3-moe-235b-a22b at full width on DTensor parameters over the same
     (1, 1) NCCL mesh, each profile (``moe_sharded_step_phase``): the fp32
     train step of 11c cut to 1 of its 94 layers (3.73 G parameters; the
     plain run's updated leaves wait on the host, and it is freed before
     the DTensor runs), and an fp32 prefill of 4 x 256 and 4 decode steps
     at phase 21's 4 layers through the kernel path (path
     "qwen3-moe-235b-a22b sharded"), each held to the plain tensors' as in
     11c.  One rank holds every expert (ep = 1): the single-shard MoE on
     DTensors; the expert-parallel all-to-alls and their backward run on
     CPU ranks only (tests/test_torch_moe_ep.py,
     tests/test_torch_sharded_moe_step.py);
11e. jamba-v0.1-52b and xlstm-125m at full width on DTensor parameters
     over the same (1, 1) NCCL mesh, each profile
     (``recurrent_sharded_step_phase``): Jamba's fp32 train step of 11c
     cut to its first 2 layers (a mamba mixer with a dense FFN, then one
     with its 16-expert MoE: 3.74 G parameters, the plain run's leaves
     waiting on the host) and an fp32 prefill of 4 x 256 and 4 decode
     steps at phase 9's 8 layers (path "jamba-v0.1-52b sharded": 7 mamba
     layers through ``mamba_scan``, the attention layer through
     ``flash_attention`` and ``flash_decode``); xLSTM whole, 11c's fp32
     train step and bf16 prefill and decode steps (path "xlstm-125m
     sharded": its 10 mLSTM layers through ``mlstm_scan``).  The scans run
     on the DTensors' local shards; each run is held to the plain tensors'
     as in 11c, and every scan must launch once a layer a pass;
 12. one ``flash_attention`` and one ``flash_decode`` call under
     torch.profiler, each exactly one device kernel, and each scan call
     (one kernel; two for the ``mlstm_scan`` prefill: scores, then the
     scan; how often a trace of that prefill comes up short, with and
     without the spin kernel that opens the window, is logged); each
     kernel's time (events and profiler), bound, plain and
     library times at the serving shapes (the attention kernels at head
     dims 64, 128 and gemma2's 256, and at the shapes of qwen2-vl,
     qwen3-moe, musicgen and kimi-k2), beside the timing method's floor
     and the times PERF.md records for them (``RECORDED_MS``, moves past
     5% named); the same at the public full widths of phase 3;
 13. full-width gemma2-2b (26 layers, 13 of them local with window 4,096,
     head dim 256, softcaps 50 and 30) in fp32: the kernel path against
     the plain path as in phase 4, on one 4,352-token prompt;
 14. serve gemma2-2b in bf16 as in phase 5: 26 ``flash_attention``
     launches in the prefill, 26 ``flash_decode`` launches a decode step;
 15. full-width gemma3-4b (34 layers: 5 periods of 5 local + 1 global and
     4 remainder layers; dual rope theta, qk-norm) in fp32 as in phase 4,
     on 2 prompts of 1,280 tokens (window 1,024);
 16. full-width minicpm-2b (40 layers, μP scaling, 36-head MHA) in fp32 as
     in phase 4;
 17. full-width qwen2-vl-72b cut to 12 of its 80 layers in fp32 (52.4 GB):
     the kernel path against the plain path as in phase 4 on the "mixed"
     input mode, 4 prompts of 64 patch embeddings and 192 tokens under
     M-RoPE;
 18. serve qwen2-vl-72b cut to 32 layers in bf16 (61.3 GB): the wave of
     phase 5 with the mode's batch keys (``serve_wave``), 32
     ``flash_attention`` and 992 ``flash_decode`` launches; decode ms a
     token beside the weights' floor, and a profiled wave's device-busy
     ms and idle share;
 19. musicgen-medium, all 48 layers, in fp32 on the "embeds" input mode:
     kernel path against plain path on 4 x 256 frame embeddings and 8
     decode steps, each fed a seeded frame embedding;
 20. serve musicgen-medium in bf16 as in phase 18;
 21. full-width qwen3-moe-235b-a22b cut to 4 of its 94 layers in fp32
     (44.8 GB): as in phase 9, with the expert choices that differ
     counted;
 22. full-width kimi-k2-1t-a32b cut to 1 of its 61 layers in fp32
     (77.7 GB: 384 experts top-8 and a shared expert, attention at head
     dim 112): as in phase 21, and the peak device memory;
 23. serve kimi-k2-1t-a32b cut to 2 layers in bf16 (73.0 GB) as in phase
     10: 2 ``flash_attention`` launches in the prefill and 2
     ``flash_decode`` launches a decode step, the layers held as in phase
     22, decode ms a token beside the weights' floor (the single-shard
     MoE reads all 384 experts' weights every step), and a profiled
     wave's device-busy ms and idle share as in phase 18;
 24. the transactional serving engine (``repro_torch.serve.ServeEngine``)
     with 64 closed-loop clients on ``decode="kernel"``: ``KernelDecode``
     at llama3.2-1b's decode geometry (32/8 heads of 64) over a bf16 pool
     of 64 sessions x 4,096 positions, every batch one ``flash_decode``
     launch, every step's KV-cache update committed through the session's
     protocol before it is acknowledged (``engine_config``).  24a: cornus
     and 2pc, three runs each in alternating order, on the delayed memory
     store (serve_bench's closed batched cell without its deadline), 30
     steps a session; 24b: the disruption
     cell (replicated store, R = 3, a publish window over the middle
     third, a replica killed as it opens, one step stalled and
     scavenged), 45 steps a session; each run must complete and commit
     every step (24b: all but the stalled one), drop nothing, raise no
     decode error, form batches of more than one and launch
     ``flash_decode`` once a batch (``engine_failures``); in 24a and
     24b the first batch of each size and of each ``kv_len`` keeps what
     ``flash_decode`` was given and returned (``DecodeRecorder``), and
     each output is held against the plain version at the bf16 tolerance,
     its K/V at the pool's (B, 8, 4,096, 64) (``decode_failures``);
     p50/p95/p99,
     TTFT, throughput and goodput are printed; serve_bench's tail gate
     (each protocol's best p99 of the three, cornus's within 1.02 x 2pc's,
     ``p99_gate``) and the publish-window ratio against 0.8 are printed
     with their verdicts, not gated.
     24c: 24a's cornus run under torch.profiler, its device-busy ms and
     idle share, and the device ms of ``flash_decode`` beside the
     ``index_select`` gathers before it (``device_ms_by_role``);
 25. the prefill_32k cell's length on the card: 25a, one counted
     ``flash_attention`` call (``ops.attention``) at 32,768 causal query
     tokens per case of LONG_CASES (llama3.2-1b's 32/8 heads of 64 in
     bf16 and fp32, qwen2-vl-72b's 64/8 of 128 in bf16), each held
     against ``layers.attention``, which must take
     ``_chunked_attention`` once and peak below the whole fp32 score
     tensor (``oracle_failures``: bf16 3e-2, fp32 2e-5, and each
     block of 1,024 query rows within 1e-2 (bf16) or 2e-5 (fp32) of the
     oracle relative to its own norm, ``block_rel_err``); each case's
     kernel, oracle and SDPA times with a cold L2 beside its bound (SDPA
     on the expanded kv heads; in fp32 its memory-efficient backend);
     25b, phase 11's training step and phase 5's prefill (4 x 256) and
     decode (batch 4 against 512 positions) counted by FlopCounterMode on
     the card (plain path), each equal to the dry run's meta pass
     (``card_cost``, ``flop_failures``), with the pass's compute and
     memory terms beside the phases' measured ms; 25c, ``launch.dryrun``
     for llama3.2-1b on the (16, 16) layout and its
     ``launch.roofline.table``;
 26. the discrete-event half of the commit core on the card's host
     (``sim_phase``): the port's ``run_bench`` (in process, no fork) on
     the Fig 5 cell (Redis and Blob, cornus and 2pc), a seeded chaos run
     with its history checked, the R = 3 geo pair, the six Table 3 rows
     and the coordinator failure of examples/nonblocking_demo.py, each
     value equal to the JAX package's (``SIM_PINNED``, sim ms); the Fig 5
     speedups with their verdicts against tests/test_paper_bands.py's
     bands; it launches no kernel;
 26b. chaos cells on the card's host (``rot_phase``): the chaos cell of
     tests/test_torch_gc_safety.py (``chaos_cell``, a copy of
     benchmarks/chaos.run_one) on the port for each "rot"-mix
     ``ROT_CELLS`` entry and for each 2PC cell where the reference
     decides both ways and the port's 2PC must not (``REPAIRED_CELLS``:
     mix, R, seed, horizon); each must have no violation and commits, and
     under "rot" GC truncations, and each ``ROT_CELLS`` value equals the
     JAX package's (``ROT_PINNED``); it launches no kernel;
then one ``{"kernels": [...]}`` line, whose launches are those of every
served path's counted wave (phases 5, 8, 10, 14, 18, 20, 23), of the
training runs (phases 11 and 11b), of phases 11c-11e's DTensor runs, of the
engine runs (phase 24) and of phase 25a's counted calls.  The expert-parallel MoE
(``moe._moe_expert_parallel``) does not run here: NCCL puts one rank on
a card, and the script needs one card; tests/test_torch_moe_ep.py holds
it on four CPU ranks.
The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parent

# The repo's kernel tolerances (tests/test_kernels.py:28-29).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The repo's kernel sweeps (tests/test_kernels.py:35-44 and :76-86), with
# head-dim-128 and head-dim-256 cases appended (the CPU tests pick earlier
# cases by index).  Head dim 256 is gemma2's and gemma3's: GQA g = 2, the
# window, gemma2's softcap 50, ragged lengths.  Then qwen3-moe's GQA group
# of 16 at head dim 128 (in decode g·hd = 2,048, flash_decode's
# MAX_GROUP_HD) and musicgen's MHA over 24 heads at head dim 64; then
# kimi-k2's head dim 112 with its GQA group of 8.
ATTN_SWEEP = [
    # (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap)
    (1, 2, 2, 64, 64, 32, True, 0, 0.0),      # MHA causal
    (2, 4, 2, 128, 128, 16, True, 0, 0.0),    # GQA
    (1, 2, 1, 96, 96, 32, True, 0, 0.0),      # ragged seq vs block
    (1, 2, 2, 64, 64, 32, True, 32, 0.0),     # sliding window
    (1, 2, 2, 64, 64, 32, True, 0, 50.0),     # softcap (gemma)
    (1, 2, 2, 64, 64, 32, False, 0, 0.0),     # non-causal
    (1, 8, 4, 160, 224, 64, True, 64, 30.0),  # everything at once, ragged
    (1, 4, 2, 80, 112, 128, True, 48, 30.0),  # head dim 128, all at once
    (1, 4, 2, 96, 160, 256, True, 64, 50.0),  # head dim 256, all at once
    (2, 8, 4, 130, 130, 256, True, 0, 0.0),   # head dim 256, ragged causal
    (1, 2, 1, 64, 100, 256, False, 0, 50.0),  # head dim 256, non-causal
    (2, 32, 2, 100, 100, 128, True, 0, 30.0),  # g 16, hd 128, ragged
    (1, 24, 24, 130, 130, 64, True, 0, 0.0),   # MHA over 24 heads, ragged
    (2, 16, 2, 130, 130, 112, True, 0, 0.0),   # kimi: g 8, hd 112, ragged
    (1, 8, 1, 96, 160, 112, True, 48, 30.0),   # hd 112, g 8, all at once
    (1, 4, 2, 70, 100, 112, False, 0, 0.0),    # hd 112, non-causal
    # Every head dim up to 512: padded widths, unaligned rows (hd
    # 1 and 100), the output split across blocks (hd 320 and 512).
    (1, 2, 1, 40, 40, 1, True, 0, 0.0),        # hd 1, g 2
    (1, 4, 2, 70, 70, 8, True, 16, 0.0),       # hd 8, window, ragged
    (2, 4, 4, 64, 96, 24, False, 0, 30.0),     # hd 24, non-causal, softcap
    (1, 4, 1, 100, 100, 40, True, 0, 0.0),     # hd 40, g 4, ragged
    (1, 2, 2, 64, 64, 48, True, 0, 50.0),      # hd 48, softcap
    (1, 6, 2, 90, 130, 72, True, 40, 0.0),     # hd 72, window, ragged
    (1, 4, 4, 128, 128, 80, True, 0, 0.0),     # hd 80 (Phi-2)
    (2, 4, 2, 96, 96, 96, True, 0, 30.0),      # hd 96 (Phi-3-mini), softcap
    (1, 3, 1, 77, 77, 100, True, 0, 0.0),      # hd 100, g 3, ragged
    (1, 2, 2, 64, 100, 160, False, 0, 0.0),    # hd 160, non-causal
    (1, 4, 2, 80, 80, 200, True, 32, 50.0),    # hd 200, all at once
    (1, 2, 1, 96, 96, 320, True, 0, 0.0),      # hd 320, g 2
    (1, 2, 2, 70, 70, 512, True, 24, 30.0),    # hd 512, all at once, ragged
]
# Public models' full-width shapes, on the card only (phase 3): Phi-3-mini's
# prefill, 32 heads of hd 96 over 2,048 causal tokens.
ATTN_FULL_WIDTH = [
    (1, 32, 32, 2048, 2048, 96, True, 0, 0.0),
]
DECODE_SWEEP = [
    # (B, Hq, Hkv, T, hd, kv_len, softcap)
    (1, 2, 2, 128, 32, 100, 0.0),
    (2, 8, 2, 256, 64, 256, 0.0),
    (1, 4, 1, 96, 32, 17, 0.0),      # ragged cache vs block
    (3, 4, 4, 512, 16, 333, 0.0),
    (1, 2, 2, 128, 32, 100, 50.0),   # softcap (gemma decode)
    (2, 8, 1, 192, 32, 130, 30.0),   # softcap + deep GQA group, ragged
    (1, 16, 2, 256, 64, 256, 0.0),   # wide GQA group in the q tile
    (4, 4, 2, 64, 128, 50, 20.0),    # big head dim, everything on
    (2, 8, 4, 320, 256, 233, 50.0),  # gemma: head dim 256, g 2, ragged
    (1, 2, 1, 96, 256, 70, 0.0),     # head dim 256, g 2, one KV head
    (2, 32, 2, 300, 128, 233, 30.0),  # g 16, hd 128: g·hd at the cap
    (2, 24, 24, 160, 64, 97, 0.0),   # MHA over 24 heads, ragged
    (2, 16, 2, 300, 112, 233, 0.0),  # kimi: g 8, hd 112, ragged
    (1, 8, 1, 96, 112, 70, 30.0),    # hd 112, g 8, one KV head, softcap
    # Every head dim up to 512 and any group: g·hd past 2,048 runs
    # as group slices; hd 37 has unaligned rows.
    (2, 2, 2, 160, 80, 97, 0.0),     # hd 80, g 1
    (1, 4, 2, 100, 80, 100, 30.0),   # hd 80, g 2, softcap
    (1, 8, 1, 128, 80, 33, 0.0),     # hd 80, g 8
    (1, 2, 2, 96, 96, 70, 0.0),      # hd 96, g 1
    (2, 4, 2, 160, 96, 160, 0.0),    # hd 96, g 2
    (1, 8, 1, 130, 96, 129, 50.0),   # hd 96, g 8, softcap
    (1, 2, 2, 64, 320, 50, 0.0),     # hd 320, g 1
    (1, 4, 2, 96, 320, 96, 30.0),    # hd 320, g 2, softcap
    (1, 8, 1, 100, 320, 77, 0.0),    # hd 320, g 8: two group slices
    (1, 2, 2, 64, 512, 64, 0.0),     # hd 512, g 1
    (1, 4, 2, 80, 512, 41, 0.0),     # hd 512, g 2
    (2, 8, 1, 96, 512, 90, 30.0),    # hd 512, g 8: two group slices
    (1, 4, 2, 100, 37, 61, 0.0),     # hd 37: rows not 16-byte aligned
    (1, 24, 1, 64, 128, 50, 0.0),    # g·hd 3,072: two group slices
    (1, 71, 1, 96, 64, 90, 0.0),     # Falcon-7B's group of 71, small T
]
# Public models' full-width decode shapes, on the card only (phase 3):
# StarCoder's 48 query heads over 1 KV head at hd 128 (g·hd 6,144) against
# an 8,192-key cache, ragged; Falcon-7B's 71 over 1 at hd 64 (4,544).
DECODE_FULL_WIDTH = [
    (4, 48, 1, 8192, 128, 8000, 0.0),
    (4, 71, 1, 2048, 64, 2000, 0.0),
]
MLSTM_SWEEP = [                      # tests/test_kernels.py:157-162
    # (B, S, H, hd, chunk)
    (1, 32, 2, 16, 8),
    (2, 80, 4, 32, 16),        # ragged seq vs chunk
    (1, 64, 1, 64, 64),        # single chunk
    # Any head dim up to 512 and any chunk.
    (1, 40, 2, 8, 16),         # hd 8
    (1, 50, 2, 24, 32),        # hd 24
    (2, 30, 1, 40, 8),         # hd 40
    (1, 70, 2, 100, 64),       # hd 100, ragged
    (1, 40, 1, 448, 32),       # hd 448
    (1, 36, 1, 512, 16),       # hd 512
    (1, 300, 2, 64, 256),      # chunk 256 against S 300
    (1, 45, 2, 37, 16),        # hd 37: rows not 16-byte aligned
]
# xLSTM-7B's mLSTM width, on the card only (phase 3): 8 heads of hd 512
# over 2,048 tokens.
MLSTM_FULL_WIDTH = [
    (1, 2048, 8, 512, 128),
]
MLSTM_C_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the returned state
MAMBA_SWEEP = [                      # tests/test_kernels.py:107-112
    # (B, S, di, N, chunk)
    (1, 32, 64, 8, 8),
    (2, 100, 128, 16, 16),     # ragged seq vs chunk
    (1, 64, 256, 4, 64),       # single chunk
    # Any state size up to 256 and any di.
    (1, 40, 64, 1, 16),        # N 1
    (2, 33, 32, 2, 16),        # N 2, di 32
    (1, 50, 96, 12, 16),       # N 12, di 96
    (1, 70, 200, 32, 32),      # N 32, di 200, ragged
    (2, 40, 64, 64, 16),       # N 64
    (1, 30, 96, 128, 16),      # N 128, di 96
    (1, 20, 200, 256, 8),      # N 256, di 200
    (1, 25, 37, 16, 8),        # di 37: rows not 16-byte aligned
]
# Mamba-2-2.7B's width, on the card only (phase 3): di 5,120 at N 128.
MAMBA_FULL_WIDTH = [
    (4, 256, 5120, 128, 0),
]
# Device ms that PERF.md §6 records for phase 12's shapes (NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's times: a move past 5% is named.
RECORDED_MS = {
    "flash_attention": {"hd64": 0.01981, "hd128": 0.02584, "hd256": 0.02369,
                        "qwen2-vl-72b": 0.04537, "qwen3-moe-235b-a22b": 0.04532,
                        "musicgen-medium": 0.01894, "kimi-k2-1t-a32b": 0.04580},
    "flash_decode": {"hd64": 0.01222, "hd128": 0.01542, "hd256": 0.01517,
                     "qwen2-vl-72b": 0.02127, "qwen3-moe-235b-a22b": 0.02861,
                     "musicgen-medium": 0.01556, "kimi-k2-1t-a32b": 0.02140},
    "mlstm_scan": {"prefill": 0.12306, "decode": 0.01348},
    "mamba_scan": {"prefill": 0.07215, "decode": 0.00780},
}
MAMBA_H_TOL = 5e-3          # the returned state (tests/test_kernels.py:130)

# The serving path: llama3.2-1b, 4 requests, 256-token prompts, 32 new
# tokens, cache capacity 512.
ARCH = "llama3.2-1b"
BATCH, PROMPT, NEW, MAX_LEN = 4, 256, 32, 512
DECODE_KV_LENS = (1, 63, 64, 65, 257, 272, 300, 512)
FP32_DECODE_STEPS = 8
MODEL_TOL = 1e-3       # fp32 logits, kernel path vs plain path, 16 layers
BF16_MODEL_TOL = 0.25  # bf16 prefill logits: bf16 rounding through 16 layers
# The second serving path: xlstm-125m, the same wave.  Its mLSTM layers run
# at head dim 1536 / 4 = 384; each pass (the prefill and each decode step)
# launches mlstm_scan once per mLSTM layer.
XLSTM = "xlstm-125m"
MLSTM_HD = 384
# The third: jamba-v0.1-52b at full width, its depth cut to whole periods
# of its 8-layer pattern (7 mamba + 1 attention, MoE on odd layers) so the
# weights fit the card: 1 period in fp32 (13.3 B parameters, 53 GB), 2 in
# bf16 for serving (26.1 B, 52.1 GB).  Its attention runs at head dim 128.
JAMBA = "jamba-v0.1-52b"
JAMBA_FP32_LAYERS, JAMBA_SERVE_LAYERS = 8, 16
# The gemma2/gemma3/minicpm phases, each model at full width and full
# depth.  gemma2-2b is served (phase 14) with the wave above; its fp32
# parity (phase 13) runs one prompt of 4,352 tokens, past the 4,096-key
# window, so its 13 local layers skip whole key tiles in the kernels.
# gemma3-4b's prompts of 1,280 tokens pass its window of 1,024; minicpm-2b
# (no window) takes the standard wave's shape.  All three attend at head
# dim 256 except minicpm (64, MHA over 36 heads).
GEMMA2, GEMMA3, MINICPM = "gemma2-2b", "gemma3-4b", "minicpm-2b"
FP32_PROMPTS = {GEMMA2: (1, 4352), GEMMA3: (2, 1280), MINICPM: (4, 256)}
# The stub input modes and the largest MoE, each at full width with the
# standard wave's shape: qwen2-vl-72b ("mixed": 64 patch embeddings and
# 192 tokens a prompt under M-RoPE; 0.878 B parameters a layer, so 12 of
# 80 layers in fp32, 52.4 GB, and 32 in bf16 for serving, 61.3 GB),
# musicgen-medium ("embeds": frame embeddings in, all 48 layers) and
# qwen3-moe-235b-a22b (2.49 B parameters a layer, so 4 of 94 in fp32,
# 44.8 GB).  Their prompts and frame embeddings are drawn from STUB_SEED.
QWEN2VL, MUSICGEN, QWEN3MOE = ("qwen2-vl-72b", "musicgen-medium",
                               "qwen3-moe-235b-a22b")
QWEN2VL_FP32_LAYERS, QWEN2VL_SERVE_LAYERS, QWEN3MOE_FP32_LAYERS = 12, 32, 4
STUB_SEED = 0
# kimi-k2-1t-a32b at full width: 17.07 G parameters a layer (384 experts of
# 3 x 7,168 x 2,048 are 16.91 G of them) and 2.35 G in the untied embedding
# and head, so 1 of its 61 layers in fp32 (77.7 GB) and 2 in bf16 for
# serving (73.0 GB).
KIMI = "kimi-k2-1t-a32b"
KIMI_FP32_LAYERS, KIMI_SERVE_LAYERS = 1, 2
# The serving engine (phase 24): ``ServeEngine`` with 64 closed-loop
# clients over ``KernelDecode`` at llama3.2-1b's decode geometry (32 query
# heads, 8 KV heads, head dim 64) with a pool of 64 sessions of 4,096
# positions in bf16 (537 MB of K and V); the commit knobs are those of
# benchmarks/serve_bench.py's quick cells (SERVICE_DELAY_MS 2.0, seed 7).
ENGINE_CLIENTS = 64
ENGINE_DECODE = dict(slots=64, q_heads=32, kv_heads=8, head_dim=64,
                     max_len=4096)
ENGINE_SERVICE_DELAY_MS = 2.0
ENGINE_PAIR_STEPS, ENGINE_DISRUPTION_STEPS = 30, 45
ENGINE_PUBLISH_RATIO = 0.8   # serve_bench's publish-window gate, printed
# serve_bench's tail gate (benchmarks/serve_bench.py:48, :202-230): each
# protocol's best p99 of ENGINE_TRIALS runs, cornus's within P99_SLACK of
# 2pc's.  Printed with its verdict, not gated.
ENGINE_TRIALS = 3
P99_SLACK = 1.02

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# fp32 products on the tensor cores as 3xTF32: three TF32 products each.
TF32X3_FLOPS = 495e12 / 3
# The special-function units: 16 MUFU.EX2 per SM a clock, 132 SMs, at the
# 1.98 GHz behind the 67 TFLOP/s fp32 figure (128 lanes x 2 x 132 SMs).
SFU_EXPS_PER_S = 132 * 16 * 1.98e9

# The training path: llama3.2-1b at full width, fp32 parameters and AdamW
# moments, batch 1 of TRAIN_4K's 4,096-token sequence (its global batch of
# 256 cut to what one card holds), remat "full", WSD warm-up of 2 steps.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 1, 6
TRAIN_CKPT_EVERY, TRAIN_HOSTS, TRAIN_CRASH_AT = 3, 4, 6
TRAIN_FWD_TOL = 1e-3     # training forward vs served forward (the fp32
                         # logits' tolerance, MODEL_TOL), relative
TRAIN_FD_TOL = 1e-2      # directional derivative vs central difference
TRAIN_RESUME_RTOL = 1e-5  # tests/test_train_loop.py:44-60
# Phase 11b: phase 11's model and first batch, one uncompressed and one
# int8-compressed step from the same start state at step index 1 (WSD gives
# lr 0 at step 0).  A leaf's dequantization error is at most half its
# scale, plus what fp32 rounding of the quotient g / scale and of the
# product q * scale can add: each within 2^-24 relative with |q| <= 127,
# so under 2^-17 of the scale each.
COMPRESS_STEP = 1
# Phase 11c: the DTensor train step's batch x tokens (fp32), and the bf16
# decode steps after the 4 x 256 prefill.
SHARDED_TRAIN, SHARDED_DECODE_STEPS = (2, 512), 4
# Phase 11d: qwen3-moe-235b-a22b's DTensor train step cut to 1 of its 94
# layers: 3.73 G parameters (experts 2.416 G, embedding and head 1.245 G,
# attention and router 0.072 G), so parameters, gradients and both moments
# in fp32 take 59.7 GB; its prefill and decode at QWEN3MOE_FP32_LAYERS.
MOE_SHARDED_TRAIN_LAYERS = 1
# Phase 11e: jamba-v0.1-52b's DTensor train step cut to its first 2 layers
# (a mamba mixer with a dense FFN, then one with a 16-expert MoE: 3.74 G
# parameters, 59.9 GB in fp32 with gradients and both moments); its
# prefill and decode at JAMBA_FP32_LAYERS.  xlstm-125m runs whole.
JAMBA_SHARDED_TRAIN_LAYERS = 2
COMPRESS_ERR_SLACK = 2.0 ** -16
# Phase 25: flash_attention at the prefill_32k cell's 32,768 query tokens
# (src/repro/models/config.py:192), held against the port's
# ``_chunked_attention``: (tag, Hq, Hkv, hd, dtype), llama3.2-1b's geometry
# in bf16 and fp32 and qwen2-vl-72b's (hd 128, g 8) in bf16, batch 1.
LONG_SEQ = 32_768
LONG_CASES = (("llama3.2-1b", 32, 8, 64, "bfloat16"),
              ("qwen2-vl-72b", 64, 8, 128, "bfloat16"),
              ("llama3.2-1b fp32", 32, 8, 64, "float32"))
# Beside TOL, each long case is held to the largest, over blocks of
# LONG_BLOCK query rows, of ||kernel - oracle|| / ||oracle||
# (``block_rel_err``).  A row's output shrinks as about 1/sqrt(its
# position), to under 1e-2 at the late rows, so an absolute error of 3e-2
# is set by the first few hundred rows and passes a dropped or misscaled
# tile late in the chain; the ratio is a block's own scale.  bf16: both
# sides round to bf16 (2^-8 apart), a few parts in 1e3 over a block; a
# 128-key tile dropped at the last rows moves them by about 4%.  fp32:
# the repo's fp32 tolerance, here relative.
LONG_BLOCK = 1024
LONG_REL_TOL = {"bfloat16": 1e-2, "float32": 2e-5}
# Phase 26: the discrete-event half of the commit core, on the card's host.
# The runs of the paper's own experiment: the Fig 5 cell of
# benchmarks/paper_figs.py:43-62 (YCSB, theta 0, 10,000 keys a partition,
# half reads; 4 nodes, horizon 900 sim ms, seed 1) on Azure Redis and Blob;
# a seeded chaos run (FaultSchedule.generate(3, n0-n3, 400), cornus on
# Redis, history checked); the geo pair of paper_figs._geo_bench(p, 3)
# (R = 3 replicated-sim across regions, horizon 4,000, seed 7); the six
# Table 3 rows at a 10 ms RTT; and examples/nonblocking_demo.py's
# coordinator failure (n0 dies at 1 ms, Redis, seed 7).  Every value is
# the JAX package's, in sim ms (the same on any machine), and is held with
# ``==`` (tests/test_torch_chip_smoke.py re-derives each from the JAX
# package).  Fig 5's values are (commits, aborts, avg, p99); the chaos
# run's (commits, aborts, avg, violations); Table 3's (measured,
# predicted); the demo's (node, decision, blocked, termination ms) per
# participant.
SIM_NODES = ("n0", "n1", "n2", "n3")
SIM_GEO_PLACEMENT = {"n0": "us-east", "n1": "us-west", "n2": "eu-west",
                     "n3": "us-west"}
SIM_GEO_REPLICAS = ("us-east", "us-west", "eu-west")
SIM_PINNED = {
    "fig5/redis/cornus": (2905, 521, 9.969982874943804, 23.42329838798426),
    "fig5/redis/2pc": (2452, 500, 11.83812267881493, 26.585491424489526),
    "fig5/blob/cornus": (1305, 713, 22.366770953105608, 63.28289617442579),
    "fig5/blob/2pc": (874, 566, 33.75219101931253, 83.36193850112295),
    "chaos": (234, 73, 13.524696437294072, 0),
    "geo/cornus": (71, 0, 453.75917470598887, 506.05565946003935),
    "geo/2pc": (63, 0, 514.4906412453811, 570.404905934623),
    "table3/2pc": (50.0, 50.0),
    "table3/cornus": (30.0, 30.0),
    "table3/cornus-opt1": (25.0, 25.0),
    "table3/2pc-coloc": (30.0, 30.0),
    "table3/cornus-coloc": (20.0, 20.0),
    "table3/paxos-commit": (15.0, 15.0),
    "nonblocking/2pc": (("n1", "BLOCKED", True, None),
                        ("n2", "BLOCKED", True, None),
                        ("n3", "BLOCKED", True, None)),
    "nonblocking/cornus": (("n1", "COMMIT", False, 2.0240630164357185),
                           ("n2", "COMMIT", False, 2.3139846519887186),
                           ("n3", "COMMIT", False, 1.9872270399095306)),
}
# The 2PC-over-Cornus average-latency bands of tests/test_paper_bands.py:37-38.
SIM_FIG5_BANDS = {"redis": (1.05, 1.5), "blob": (1.2, 1.95)}
# Phase 26b: the "rot" fault mix (bit-flips, torn tails, GC truncation
# pulses and a crash-restart, with checksums, GC and scrub armed) of
# benchmarks/chaos.py on the regression cells of tests/test_gc_safety.py:118
# (protocol, R, seed; horizon 300 sim ms), each held to the JAX package's
# (commits, aborts, avg, violations, GC truncations) with ``==``
# (tests/test_torch_chip_smoke.py re-derives each from the JAX package);
# and the 2PC cells (mix, R, seed, horizon) where the reference decides
# both ways, or tells a client COMMIT while a node decided ABORT, and the
# port's 2PC must certify: tests/test_torch_gc_safety.py's REPAIRED and
# SILENT_SPLITS.
ROT_CELLS = (("cornus", 3, 0), ("cornus", 3, 3), ("cornus", 3, 5),
             ("2pc", 1, 8), ("cornus", 1, 2), ("2pc", 3, 1))
ROT_HORIZON_MS = 300.0
REPAIRED_CELLS = (("rot", 1, 4352, 200.0), ("rot", 1, 61, 200.0),
                  ("rot", 1, 129, 200.0), ("rot", 1, 548, 200.0),
                  ("rot", 3, 254, 200.0), ("rot", 1, 599, 200.0),
                  ("messages", 1, 5, 200.0), ("torn", 3, 22, 200.0),
                  ("crash", 3, 42, 200.0), ("rot", 1, 32, 200.0),
                  ("messages", 1, 4, 200.0))
ROT_PINNED = {
    "rot/cornus/r3/s0": (217, 8, 11.302681516948704, 0, 799),
    "rot/cornus/r3/s3": (213, 8, 11.419369515844915, 0, 790),
    "rot/cornus/r3/s5": (212, 15, 11.54982496319145, 0, 793),
    "rot/2pc/r1/s8": (163, 3, 15.062340290728004, 0, 644),
    "rot/cornus/r1/s2": (158, 4, 15.406721657033847, 0, 635),
    "rot/2pc/r3/s1": (156, 5, 15.615202256483949, 0, 624),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------
def attention_bound(B, Hq, Hkv, Sq, Skv, hd, *, causal, q_offset=0,
                    kv_len=None, window=0, dtype="bfloat16"):
    """(bound_ms, bound_by, bytes, flops) for one attention call: each input
    read once (of K and V, the keys some query can see: below the valid
    length and, with ``causal``, the causal limit and the ``window``), the
    output written once, and 4·hd flops (QK and PV multiply-adds) per
    visible (query, key) pair.  As in the kernels, the window applies only
    with ``causal``."""
    itemsize = 2 if dtype == "bfloat16" else 4
    valid = min(Skv, Skv if kv_len is None else kv_len)
    if causal:
        def span(pos):          # keys [lo, hi) that query position pos sees
            lo = max(0, pos - window + 1) if window > 0 else 0
            return lo, min(valid, pos + 1)
        spans = [span(q + q_offset) for q in range(Sq)]
        pairs = sum(max(0, hi - lo) for lo, hi in spans)
        seen = max(0, spans[-1][1] - spans[0][0])
    else:
        pairs = Sq * valid
        seen = valid
    nbytes = itemsize * (2 * B * Hq * Sq * hd + 2 * B * Hkv * seen * hd)
    flops = 4.0 * B * Hq * hd * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def mlstm_bound(B, S, H, hd, dtype="float32"):
    """(bound_ms, bound_by, bytes, flops) for one mlstm_scan call: q, k, v,
    i, f and c0 read once, y and c_last written once, and the flops of the
    recurrence, the least work that computes the function: per token and
    head, 2·hd² for the update C += i·k vᵀ and 2·hd² for y = q·C.  (The
    chunkwise form adds the causal c×c score and P·V terms on top.)  The
    kernel computes its products in fp32 accuracy on the tensor cores as
    3xTF32 (bf16 inputs converted to fp32), so the operations take at
    least flops / (495/3 TFLOP/s)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (4 * B * S * H * hd + 2 * B * S * H) \
        + 2 * 4 * B * H * hd * hd
    flops = 4.0 * B * S * H * hd * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32X3_FLOPS * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def mamba_bound(B, S, di, N, dtype="float32"):
    """(bound_ms, bound_by, bytes, flops) for one mamba_scan call: the
    largest of three times.  Bytes: u, dt, b, c, a and h0 read once, y and
    h_last written once.  Operations: 8 per (token, channel, state) of the
    recurrence (dt·a, its exp, exp·h, dt·b, ·u, the add, and the
    multiply-add of y = h·c) at the fp32 rate.  Special functions: one exp
    per (token, channel, state), each one MUFU.EX2 on the SM's 16
    special-function lanes (``SFU_EXPS_PER_S``)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (3 * B * S * di + 2 * B * S * N) \
        + 4 * di * N + 2 * 4 * B * di * N
    flops = 8.0 * B * S * di * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_FLOPS["float32"] * 1e3,
             "special-function": B * S * di * N / SFU_EXPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, nbytes, flops


def cold_device_ms(torch, flush, fn, iters=30, warmup=3):
    """Mean device ms of one call of ``fn`` with a cold L2 (as between
    layers), by CUDA events: before each timed call the card spins for
    about 1 ms (so the host has queued the call before the card reaches
    it, and the events bracket device time, not the wrapper's Python) and
    zeroes ``flush`` (64 MB, evicting the 50 MB L2)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def block_rel_err(got, want, block=LONG_BLOCK) -> float:
    """The largest, over blocks of ``block`` query rows (dim 1 of a
    (B, S, H, D) output; the last block may be short), of ||got - want||
    / ||want|| over the block's rows of every batch and head."""
    import torch
    S = want.shape[1]

    def per_row(t):
        return t.float().square().sum(dim=(0, 2, 3))

    pad = -S % block
    num, den = (torch.nn.functional.pad(per_row(t), (0, pad))
                .view(-1, block).sum(1)
                for t in (got.float() - want.float(), want))
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny))
                 .sqrt().max())


def ptxas_report(log_text: str):
    """{entry function: (registers, spill store bytes, spill load bytes,
    static shared-memory bytes)} from nvcc's ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, [0, 0, 0, 0])
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn][3] = int(sm.group(1)) if sm else 0
    return {k: tuple(v) for k, v in out.items()}


def sass_forms(lib: Path, opcode: str) -> Dict[str, Dict[str, int]]:
    """{function: {instruction form: count}} of the ``opcode`` instructions
    in the card's code in ``lib`` (``cuobjdump -sass``); a form is the
    opcode with its modifiers and, for HGMMA, whether B is read
    transposed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump -sass {lib.name}: {res.stderr}")
    out: Dict[str, Dict[str, int]] = {}
    fn = ""
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for m in re.finditer(rf"\b({opcode}\.[\w.]+)([^;]*);", line):
            form = m.group(1) + (" tnspB" if ".tnspB" in m.group(2) else "")
            forms = out.setdefault(fn, {})
            forms[form] = forms.get(form, 0) + 1
    return out


def wave_launches(cfg, decode_steps=NEW - 1) -> Dict[str, int]:
    """Kernel launches of one served wave of ``cfg`` (``generate``: the
    prefill, then ``decode_steps`` decode steps): each attention layer
    (global or local) launches flash_attention in the prefill and
    flash_decode in every decode step; each mLSTM and mamba layer its scan
    in every pass."""
    kinds = cfg.full_pattern
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    passes = 1 + decode_steps
    return {"flash_attention": n_attn, "flash_decode": n_attn * decode_steps,
            "mlstm_scan": kinds.count("mlstm") * passes,
            "mamba_scan": kinds.count("mamba") * passes}


def decode_floor(cfg, batch, kv_len, itemsize=2):
    """(ms, weight bytes, cache bytes): the least time of one decode step,
    the bytes it must read once over 3.35 TB/s.  The weights: every layer's
    and the head's, and an embeds model's frame projection; a step reads
    only ``batch`` rows of an untied embedding table, and a mixed model's
    step no patch, so neither is counted.  The cache: K and V of every
    attention layer up to ``kv_len``."""
    d = cfg.d_model
    n = spec_elements(cfg)
    if not cfg.tie_embeddings:
        n -= cfg.padded_vocab * d
    if cfg.input_mode == "mixed":
        n -= d * d
    n_attn = sum(k in ("attn", "attn_local") for k in cfg.full_pattern)
    weights = itemsize * n
    cache = itemsize * n_attn * 2 * batch * kv_len * cfg.n_kv_heads * cfg.hd
    return (weights + cache) / HBM_BYTES_PER_S * 1e3, weights, cache


def expert_floors(cfg, batch=BATCH, itemsize=2):
    """The weights' part of an MoE model's decode floor, two ways:
    {"every_bytes": a step's weights as ``decode_floor`` counts them, every
    expert included, as the single-shard MoE reads them (three batched
    products over all experts, as the JAX package's einsums); "picked_bytes":
    the same with only the at most ``batch`` x k experts a step picks in
    each MoE layer; "picked": that count; and both over 3.35 TB/s in ms}."""
    from repro_torch.models import layer_is_moe
    _, every, _ = decode_floor(cfg, batch, PROMPT + NEW // 2, itemsize)
    n_moe = sum(layer_is_moe(cfg, li) for li in range(cfg.n_layers))
    expert_bytes = itemsize * 3 * cfg.d_model * cfg.expert_d_ff
    picked = min(cfg.n_experts, batch * cfg.experts_per_token)
    unread = n_moe * (cfg.n_experts - picked) * expert_bytes
    return {"every_bytes": every, "every_ms": every / HBM_BYTES_PER_S * 1e3,
            "picked": picked, "picked_bytes": every - unread,
            "picked_ms": (every - unread) / HBM_BYTES_PER_S * 1e3}


def expert_floors_text(cfg) -> str:
    """``expert_floors`` of a served MoE model as a log line's text."""
    f = expert_floors(cfg)
    return (f"decode floor per token (bf16 weights / 3.35 TB/s): every "
            f"expert read {f['every_ms']:.2f} ms "
            f"({f['every_bytes'] / 1e9:.1f} GB), as the single-shard MoE "
            f"reads them; only the <= {f['picked']} picked of "
            f"{cfg.n_experts} experts per MoE layer {f['picked_ms']:.2f} ms "
            f"({f['picked_bytes'] / 1e9:.1f} GB)")


# ---------------------------------------------------------------------------
# The served wave with each input mode's batch keys
# ---------------------------------------------------------------------------
def prompt_batch(cfg, B, S, device, seed=1):
    """A prompt of S positions with the keys of ``cfg.input_mode``, drawn on
    ``device`` from ``seed``: S tokens; S frame embeddings; or the split of
    the JAX package's ``batch_specs`` (``launch/steps.py:120-123``),
    max(1, int(S · patch_frac)) patch embeddings (none at S = 1), then the
    tokens."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def randint(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=device)

    if cfg.input_mode == "tokens":
        return {"tokens": randint(B, S)}
    if cfg.input_mode == "embeds":
        return {"frame_embeds": randn(B, S, cfg.d_model)}
    n_patch = max(1, int(S * cfg.patch_frac)) if S > 1 else 0
    return {"patch_embeds": randn(B, n_patch, cfg.d_model),
            "tokens": randint(B, S - n_patch)}


def step_batch(cfg, tok, t, seed=1):
    """The inputs of decode step ``t`` after the greedy tokens ``tok`` (B,):
    the tokens, with a (B, 0, d) ``patch_embeds`` in the mixed mode, as the
    JAX package's decode steps take them; an embeds model (whose EnCodec
    frontend is a stub) takes a frame embedding drawn from (seed, t)."""
    import torch
    B = tok.shape[0]
    if cfg.input_mode == "embeds":
        gen = torch.Generator(device=tok.device)
        gen.manual_seed(seed * 1_000_003 + t)
        return {"frame_embeds": torch.randn((B, 1, cfg.d_model),
                                            generator=gen, device=tok.device)}
    out = {"tokens": tok[:, None]}
    if cfg.input_mode == "mixed":
        out["patch_embeds"] = torch.zeros((B, 0, cfg.d_model),
                                          device=tok.device)
    return out


def serve_wave(cfg, model, batch, scfg, device, seed=1):
    """One served wave, (B, max_new_tokens) int32 greedy tokens:
    ``launch.serve.generate`` for token prompts.  The stub input modes run
    its loop (the prefill, then ``max_new_tokens - 1`` decode steps, each
    fed ``step_batch``): ``generate`` takes token prompts only, as the JAX
    package's does."""
    import torch

    from repro_torch.launch.serve import generate
    if cfg.input_mode == "tokens":
        return generate(cfg, model, batch["tokens"], scfg, device=device)
    check(scfg.temperature <= 0 and scfg.eos_id is None,
          "the stub wave is greedy and has no EOS")
    logits, cache, S = model.prefill(batch, scfg.max_len)
    check(S + scfg.max_new_tokens <= scfg.max_len,
          f"prompt {S} + {scfg.max_new_tokens} exceed {scfg.max_len}")
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    out = [tok]
    for t in range(1, scfg.max_new_tokens):
        logits, cache = model.decode_step(step_batch(cfg, tok, t, seed),
                                          cache, S + t - 1)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy().astype("int32")


# ---------------------------------------------------------------------------
# Training: the FLOP count, the memory reckoning, the gradient check
# ---------------------------------------------------------------------------
def spec_elements(cfg, layers_only=False, matrices_only=False) -> int:
    """Parameter elements in the model's spec leaves (``model_specs``),
    without allocating; only the layers' with ``layers_only``, only the
    leaves of two dims or more (the ones a matrix product reads) with
    ``matrices_only``."""
    from repro_torch.models.layers import PSpec
    from repro_torch.models.lm import model_specs

    def count(tree):
        if isinstance(tree, PSpec):
            return math.prod(tree.shape) if len(tree.shape) >= 2 or \
                not matrices_only else 0
        items = tree.values() if isinstance(tree, dict) else tree
        return sum(count(t) for t in items)

    specs = model_specs(cfg)
    return count(specs["layers"] if layers_only else specs)


def train_flops(cfg, batch, seq, remat="full"):
    """The FLOPs of one training step's matrix products, by term: 6·N·T
    for the parameters' products (2 forward, 4 backward per parameter and
    token; N counts every matrix leaf, the tied embedding once, as the
    head's product); the attention's score and value products, 4·hd per
    (query, key) pair over the full S x S that the plain attention
    computes, times 3 for the forward and backward.  "model" is their sum.
    With remat "full" torch recomputes each layer's forward in the
    backward but its last product, a dense FFN's down-projection, whose
    output the backward does not need (non-reentrant checkpoint stops
    once every tensor it saved is back): "recompute", and "total" = model +
    recompute, the products the step executes (the cost pass's count,
    ``launch.dryrun.cost_pass``)."""
    from repro_torch.models.blocks import FFN_KINDS
    tokens = batch * seq
    n_attn = sum(k in ("attn", "attn_local") for k in cfg.full_pattern)
    attn_fwd = 4.0 * batch * cfg.n_heads * cfg.hd * seq * seq * n_attn
    down = sum(1 for i in range(cfg.n_layers) if not cfg.is_moe_layer(i)
               and cfg.full_pattern[i] in FFN_KINDS) \
        * cfg.d_ff * cfg.d_model
    layers = spec_elements(cfg, layers_only=True, matrices_only=True)
    out = {"params": 6.0 * spec_elements(cfg, matrices_only=True) * tokens,
           "attention": 3 * attn_fwd}
    out["model"] = out["params"] + out["attention"]
    out["recompute"] = (2.0 * (layers - down) * tokens + attn_fwd) \
        if remat == "full" else 0.0
    out["total"] = out["model"] + out["recompute"]
    return out


def train_cost(torch):
    """The dry run's cost pass (``launch.dryrun.cost_pass``, on the meta
    device) over phase 11's step: llama3.2-1b in fp32, batch TRAIN_BATCH x
    TRAIN_SEQ, remat "full"."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import ShapeConfig
    return dryrun.cost_pass(
        get_config(ARCH), ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                      "train"),
        steps.TrainSettings(remat="full", warmup=2), dtype=torch.float32)


def train_memory_gb(cfg, batch, seq):
    """Device memory of one fp32 training step, reckoned from the shapes:
    parameters, gradients, m and v (4 bytes each per element); one
    layer's fp32 attention scores, of which the recomputed layer's
    backward holds about three; the fp32 logits and their gradient."""
    state = 4 * 4 * spec_elements(cfg)
    scores = 4 * batch * cfg.n_heads * seq * seq
    logits = 4 * batch * seq * cfg.padded_vocab
    return {"state_gb": state / 1e9, "scores_gb": scores / 1e9,
            "logits_gb": logits / 1e9,
            "estimate_gb": (state + 3 * scores + 2 * logits) / 1e9}


def directional_check(loss_at, params, grads, seed=0, eps_rel=3e-3):
    """The gradient along a random unit direction d over all parameters,
    ⟨∇L, d⟩, against central differences D(h) = (L(p+hd) − L(p−hd)) / 2h.
    ``loss_at()`` evaluates the loss at the parameters' current values.
    The step ε is ``eps_rel`` times the parameters' global norm, and the
    slope compared is the Richardson extrapolation (4·D(ε/2) − D(ε)) / 3,
    which cancels D's ε² term: at this ε that term, not the fp32 loss's
    rounding, is what parts D from the slope (on the smoke llama D is off
    by 4e-4 to 1e-2 over a tenfold range of ε, the extrapolation by 2e-4 to
    7e-4).  The parameters are put back as they were.  Returns ε, the
    slopes and the extrapolation's relative difference from ⟨∇L, d⟩."""
    import torch
    dirs = []
    for i, p in enumerate(params):
        g = torch.Generator(device=p.device)
        g.manual_seed(seed * 1_000_003 + i)
        dirs.append(torch.randn(p.shape, generator=g, device=p.device))
    norm = sum(float(d.double().square().sum()) for d in dirs) ** 0.5
    dirs = [d / norm for d in dirs]
    dot = sum(float((g.float() * d).sum(dtype=torch.float64))
              for g, d in zip(grads, dirs))
    p_norm = sum(float(p.detach().double().square().sum())
                 for p in params) ** 0.5
    eps = eps_rel * p_norm
    losses = {}
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        for h in (eps, -eps, eps / 2, -eps / 2):
            for p, s, d in zip(params, saved, dirs):
                p.copy_(s + h * d)
            losses[h] = float(loss_at())
        for p, s in zip(params, saved):
            p.copy_(s)
    d_eps = (losses[eps] - losses[-eps]) / (2 * eps)
    d_half = (losses[eps / 2] - losses[-eps / 2]) / eps
    fd = (4 * d_half - d_eps) / 3
    return {"eps": eps, "param_norm": p_norm, "dot": dot, "fd": fd,
            "central_eps": d_eps, "central_half_eps": d_half,
            "rel": abs(fd - dot) / max(abs(dot), 1e-30),
            "losses": [losses[h] for h in (eps, -eps, eps / 2, -eps / 2)]}


# ---------------------------------------------------------------------------
# Phase 24: the serving engine
# ---------------------------------------------------------------------------
def engine_config(cell, decode_kwargs, protocol="cornus"):
    """The ``EngineConfig`` of one phase-24 run, on ``decode="kernel"``.

    ``"pair"`` takes the knobs of serve_bench's ``_cell_config(protocol,
    "closed", "batched", quick=True)`` without its 250 ms deadline, so that
    a drop can only mean a fault; ``"disruption"`` those of
    ``_disruption_config(quick=True)`` (replicated store, a publish window
    over the middle third, a replica killed as it opens, one step stalled
    and scavenged).  Both run ENGINE_CLIENTS clients."""
    from repro_torch.serve import AdmissionConfig, EngineConfig, SessionConfig
    if cell == "pair":
        return EngineConfig(
            session=SessionConfig(protocol=protocol, backend="memory",
                                  participants_per_txn=3,
                                  service_delay_ms=ENGINE_SERVICE_DELAY_MS,
                                  seed=7),
            admission=AdmissionConfig(max_batch=8, window_ms=1.0,
                                      queue_depth=64),
            decode="kernel", decode_kwargs=dict(decode_kwargs),
            batch_mode="batched", seed=7, clients=ENGINE_CLIENTS,
            steps_per_session=ENGINE_PAIR_STEPS)
    if cell == "disruption":
        return EngineConfig(
            session=SessionConfig(protocol="cornus", backend="replicated",
                                  replication=3, participants_per_txn=3,
                                  service_delay_ms=ENGINE_SERVICE_DELAY_MS,
                                  seed=7),
            admission=AdmissionConfig(max_batch=8, window_ms=1.0),
            decode="kernel", decode_kwargs=dict(decode_kwargs),
            seed=7, clients=ENGINE_CLIENTS,
            steps_per_session=ENGINE_DISRUPTION_STEPS,
            publish_at=0.33, publish_until=0.66, publish_hosts=2,
            publish_interval_s=0.02, kill_replica_at=0.33, stall_at=0.5)
    raise ValueError(f"unknown engine cell {cell!r}")


def engine_failures(engine, result, launches, cell):
    """The checks phase 24 holds one engine run to; returns the failed
    ones.  Every step came back from decode with nothing dropped and no
    decode error; every step committed (the disruption cell: all but the
    one stalled step, aborted by its scavenger); batches of more than one
    formed; ``flash_decode`` launched once per batch.  The disruption cell
    also needs the replica kill, the lease fast path and a committed
    publish."""
    cfg, rep, ctr = engine.cfg, result.report, result.counters
    steps = cfg.clients * cfg.steps_per_session
    stalled = int(cfg.stall_at is not None)
    batches = engine.batcher.batches
    want = [
        (rep.completed == steps, f"completed {rep.completed} of {steps}"),
        (rep.committed == steps - stalled,
         f"committed {rep.committed}, expected {steps - stalled}"),
        (rep.aborted == stalled == ctr["terminations"],
         f"aborted {rep.aborted}, terminations {ctr['terminations']}, "
         f"stalls {stalled}"),
        (rep.dropped == 0 and rep.rejected == 0,
         f"dropped {rep.dropped}, rejected {rep.rejected}"),
        (engine.batcher.last_error is None,
         f"decode raised {engine.batcher.last_error!r}"),
        (ctr["max_batch_seen"] > 1,
         f"largest batch {ctr['max_batch_seen']}"),
        (launches.get("flash_decode") == batches > 0,
         f"flash_decode launches {launches}, batches {batches}"),
    ]
    if cell == "disruption":
        committed = [p for p in result.publishes
                     if p.decision.name == "COMMIT"]
        want += [
            (ctr["replica_killed"] >= 0,
             f"replica_killed {ctr['replica_killed']}"),
            (ctr["fast_path_ops"] > 0,
             f"fast_path_ops {ctr['fast_path_ops']}"),
            (len(committed) >= 1,
             f"{len(committed)} of {len(result.publishes)} publishes "
             f"committed"),
        ]
    return [msg for ok, msg in want if not ok]


class DecodeRecorder:
    """While active, wraps ``ops.flash_decode`` so that the first batch of
    each size and the first of each ``kv_len`` leave a copy of what the
    engine gave the kernel and got back: the query, the gathered K/V rows
    below ``kv_len`` (all the kernel may read), the output, and the full
    K/V shape and strides.  ``errors`` holds each output against
    ``ref.attention_ref`` on the same inputs after the run, so the check
    adds no launch.  Only the batcher's worker thread calls the kernel."""

    def __init__(self):
        from repro_torch.kernels import ops
        self._ops, self.records = ops, []
        self._sizes, self._lens = set(), set()

    def __enter__(self):
        self._kernel = self._ops.flash_decode
        self._ops.flash_decode = self._call
        return self

    def __exit__(self, *exc):
        self._ops.flash_decode = self._kernel

    def _call(self, q, k, v, kv_len, **kw):
        out = self._kernel(q, k, v, kv_len, **kw)
        B = q.shape[0]
        if B not in self._sizes or kv_len not in self._lens:
            self._sizes.add(B)
            self._lens.add(kv_len)
            self.records.append({
                "q": q.clone(), "k": k[:, :, :kv_len].clone(),
                "v": v[:, :, :kv_len].clone(), "out": out.clone(),
                "kv_len": kv_len, "softcap": kw.get("softcap", 0.0),
                "kv_shape": tuple(k.shape), "kv_stride": tuple(k.stride()),
                "dtype": str(k.dtype).removeprefix("torch.")})
        return out

    def errors(self):
        """One row per record: B, kv_len, the K/V shape, the max abs error
        against the plain version and whether it is within TOL."""
        import torch

        from repro_torch.kernels import ref
        rows = []
        for r in self.records:
            want = ref.attention_ref(r["q"], r["k"], r["v"], causal=False,
                                     softcap=r["softcap"],
                                     kv_len=r["kv_len"])
            got, tol = r["out"], TOL[r["dtype"]]
            ok = got.dtype == want.dtype and bool(torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol))
            rows.append({"B": r["q"].shape[0], "kv_len": r["kv_len"],
                         "kv_shape": r["kv_shape"],
                         "kv_stride": r["kv_stride"],
                         "max_abs_err": max_err(got, want), "ok": ok})
        return rows


def decode_failures(rows, decode_kwargs, max_batch_seen):
    """The checks phase 24 holds the recorded ``flash_decode`` calls of
    one engine run to: every output within TOL of the plain version, every
    gathered K/V at the pool's geometry, and the largest batch recorded."""
    want_kv = (decode_kwargs["kv_heads"], decode_kwargs["max_len"],
               decode_kwargs["head_dim"])
    fails = [f"B {r['B']} kv_len {r['kv_len']}: max abs err "
             f"{r['max_abs_err']:g}" for r in rows if not r["ok"]]
    fails += [f"B {r['B']}: K/V {r['kv_shape']}, not (B, *{want_kv})"
              for r in rows if r["kv_shape"][1:] != want_kv]
    if max(r["B"] for r in rows) != max_batch_seen:
        fails.append(f"largest batch recorded "
                     f"{max(r['B'] for r in rows)}, seen {max_batch_seen}")
    return fails


def engine_summary(result):
    """The SLO numbers phase 24 prints for one run."""
    rep = result.report
    return {"protocol": rep.protocol, "completed": rep.completed,
            "committed": rep.committed, "aborted": rep.aborted,
            "dropped": rep.dropped, "elapsed_s": rep.elapsed_s,
            "p50_ms": rep.p50_ms, "p95_ms": rep.p95_ms,
            "p99_ms": rep.p99_ms, "ttft_p50_ms": rep.ttft_p50_ms,
            "throughput_tps": rep.throughput_tps,
            "goodput_tps": rep.goodput_tps, "mean_batch": rep.mean_batch,
            "publish_disruption": rep.publish_disruption,
            "publishes": len(result.publishes),
            "batches": result.counters["batches"],
            "max_batch_seen": result.counters["max_batch_seen"],
            "fast_path_ops": result.counters["fast_path_ops"],
            "replica_killed": result.counters["replica_killed"]}


def p99_gate(p99s):
    """serve_bench's tail gate (``check_serve``) over runs of each protocol:
    the best (least) p99 of each, and whether cornus's is within
    ``P99_SLACK`` of 2pc's ("ok") or not ("TAIL-INVERTED")."""
    best = {p: min(v) for p, v in p99s.items()}
    limit = best["2pc"] * P99_SLACK
    return {"p99_ms": p99s, "best_p99_ms": best, "slack": P99_SLACK,
            "cornus_over_2pc": best["cornus"] / best["2pc"],
            "limit_ms": limit,
            "verdict": "ok" if best["cornus"] <= limit else "TAIL-INVERTED"}


def device_ms_by_role(acts):
    """Device ms of one profiled engine run by role: the ``flash_decode``
    kernel, the ``index_select`` gathers of the sessions' cache rows that
    ``KernelDecode`` runs before it, and everything else."""
    out = {"flash_decode": 0.0, "index_select": 0.0, "other": 0.0}
    for e in acts:
        name = e.name.lower()
        role = ("flash_decode" if "decode_kernel" in name else
                "index_select" if "indexselect" in name
                or "index_select" in name else "other")
        out[role] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def engine_phase(torch, dev, by_path):
    """Phase 24: ``ServeEngine`` on the card, each run's launches added to
    ``by_path`` under "serving engine <run>".  Every decode batch is one
    flash_decode launch over the sessions' gathered cache rows; every step
    commits its KV-cache update through the session's protocol before it
    is acknowledged.  24a runs cornus
    and 2pc three times each (cornus first in the first and third pair),
    24b the disruption cell, 24c a cornus run once more under
    torch.profiler.  The two comparisons (the best p99s through
    ``p99_gate``, the publish window) are printed with their verdicts, not
    gated: host-clock numbers spread between calls.  Returns
    the largest error of the recorded ``flash_decode`` outputs against the
    plain version (``DecodeRecorder``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.profile import _busy_ms
    from repro_torch.serve import ServeEngine
    t_engine = time.perf_counter()
    ekw = dict(ENGINE_DECODE, dtype=torch.bfloat16, device=dev)
    decode_err = [0.0]      # over the recorded flash_decode calls

    def engine_run(tag, cfg, cell, prof=None, counted=True):
        """One engine run (launch counters from 0), checked by
        ``engine_failures``; with ``prof``, under that profiler.  A counted
        run's launches join ``by_path``."""
        engine = ServeEngine(cfg)
        rec = DecodeRecorder()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if prof is None:
            with rec:
                res = engine.run()
        else:
            with prof:
                res = engine.run()
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        fails = engine_failures(engine, res, launches, cell)
        check(not fails, f"[engine {tag}] {fails}")
        if counted:
            by_path[f"serving engine {tag}"] = launches
        out = {"run": tag, **engine_summary(res), "wall_ms": wall_ms,
               "launches": launches}
        if rec.records:
            rows = rec.errors()
            fails = decode_failures(rows, ekw, res.counters["max_batch_seen"])
            check(not fails, f"[engine {tag}] flash_decode: {fails}")
            out["decode_cases"] = [(r["B"], r["kv_len"]) for r in rows]
            out["decode_max_abs_err"] = max(r["max_abs_err"] for r in rows)
            decode_err[0] = max(decode_err[0], out["decode_max_abs_err"])
        log(f"[engine] {json.dumps(out)}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # A short run first: on the H100 the first engine run of a process paid
    # about half a second of one-time host costs in its first steps, which
    # would land in the tail of whichever protocol ran first.
    engine_run("warm-up", dataclasses.replace(engine_config("pair", ekw),
                                              steps_per_session=2),
               "pair", counted=False)
    trials = {"cornus": [], "2pc": []}
    for t in range(ENGINE_TRIALS):                                   # 24a
        for proto in (("cornus", "2pc") if t % 2 == 0 else
                      ("2pc", "cornus")):
            trials[proto].append(engine_run(
                f"{proto} {t + 1}", engine_config("pair", ekw, proto),
                "pair"))
    gate = p99_gate({p: [r["p99_ms"] for r in runs]
                     for p, runs in trials.items()})
    log(f"[engine] serve_bench's tail gate over the best of "
        f"{ENGINE_TRIALS} (printed, not gated): {json.dumps(gate)}")
    dis = engine_run("disruption", engine_config("disruption", ekw),
                     "disruption")                                   # 24b
    ratio = dis["publish_disruption"]
    log(f"[engine] publish_disruption {ratio} against "
        f"{ENGINE_PUBLISH_RATIO} (printed, not gated): "
        f"{ratio is not None and ratio >= ENGINE_PUBLISH_RATIO}")
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof_run = engine_run("cornus profiled",
                          engine_config("pair", ekw, "cornus"), "pair",
                          prof=prof)                                 # 24c
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(acts)
    roles = device_ms_by_role(acts)
    by_name = {}
    for e in acts:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    check(roles["flash_decode"] > 0, "the profile shows no flash_decode")
    # The idle share over the engine's own run (batcher start to stop), not
    # the profiler's start and stop around it.
    run_ms = prof_run["elapsed_s"] * 1e3
    profiled = {"run_ms": run_ms, "wall_ms": prof_run["wall_ms"],
                "device_busy_ms": busy, "idle_share": 1 - busy / run_ms,
                "device_activities": len(acts), "device_ms_by_role": roles,
                "batches": prof_run["batches"],
                "top_device_ms": sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:8]}
    log(f"[engine profile] {json.dumps(profiled)}")
    log(f"[engine] phase 24 {time.perf_counter() - t_engine:.1f} s")
    return decode_err[0]


def layer_parity(name, model, prompts, tol=MODEL_TOL):
    """``_layer_parity`` under ``torch.inference_mode()``: the parameters
    require grad, and the kernels refuse to record a graph."""
    import torch
    with torch.inference_mode():
        return _layer_parity(name, model, prompts, tol)


def _layer_parity(name, model, prompts, tol=MODEL_TOL):
    """The kernel path against the plain path layer by layer: every
    layer's mixer on both paths is fed the plain path's input (and each
    path keeps its own cache), and the layer's FFN or MoE, which has no
    kernel, runs once on the plain path's residual; over the prefill and
    FP32_DECODE_STEPS decode steps on the plain path's greedy tokens.
    Each mixer output must agree within ``tol`` relative to its largest
    value (the mixer output, not the layer's x + mixer output, in which a
    bf16 residual would hide a wrong mixer), and after the prefill and the
    last step every cache leaf in its own dtype: fp32 leaves within
    MODEL_TOL, the others (attention K/V, the mamba conv window) within
    that dtype's kernel tolerance.  For a model whose free-running paths
    part by more than rounding (the sLSTM recurrence at random full-width
    init amplifies 1e-6 differences over 256 tokens), this holds the
    kernel inside the model where the end-to-end logits cannot.  Returns
    the largest errors."""
    import torch

    from repro_torch.models import init_cache, layer_cache, layer_is_moe
    from repro_torch.models.blocks import _scaled, ffn_apply, mixer
    from repro_torch.models.layers import text_positions
    cfg = model.cfg
    B, S = prompts.shape
    dtype = next(model.parameters()).dtype
    caches = {plain: init_cache(cfg, B, MAX_LEN, dtype=dtype,
                                device=prompts.device)
              for plain in (False, True)}
    worst = {"mixer_rel": 0.0, "cache": 0.0}

    def one_pass(tokens, mode, pos):
        x = model.embed_inputs({"tokens": tokens})
        ropes = model.rope(text_positions(B, tokens.shape[1], pos,
                                          device=tokens.device))
        for li, kind in enumerate(cfg.full_pattern):
            out = {}
            for plain in (False, True):
                ctx = model.layer_ctx(kind, ropes, mode=mode,
                                      cache=layer_cache(cfg, caches[plain],
                                                        li),
                                      pos_offset=pos, max_len=MAX_LEN,
                                      plain=plain)
                out[plain], _ = mixer(kind)[1](
                    cfg, model.layers[li]["mixer"], x, ctx)
            e = max_err(out[False], out[True]) / max(
                float(out[True].float().abs().max()), 1e-30)
            check(e <= tol, f"{name} {mode} layer {li} ({kind}) mixer "
                  f"output relative err {e:g} > {tol}")
            worst["mixer_rel"] = max(worst["mixer_rel"], e)
            x = x + _scaled(out[True], cfg.residual_scale)
            if "ffn" in model.layers[li]:
                f, _ = ffn_apply(cfg, model.layers[li]["ffn"], x,
                                 layer_is_moe(cfg, li))
                x = x + _scaled(f, cfg.residual_scale)
        return model._head(x[:, -1:])

    def same_caches(when):
        for li in range(cfg.n_layers):
            got = layer_cache(cfg, caches[False], li)
            want = layer_cache(cfg, caches[True], li)
            for n, t in got.items():
                e = max_err(t, want[n])
                leaf_tol = MODEL_TOL if t.dtype == torch.float32 else \
                    TOL[str(t.dtype).split(".")[-1]]
                check(t.dtype == want[n].dtype and e <= leaf_tol,
                      f"{name} cache layer {li} {n} {t.dtype} err {e:g} "
                      f"(tol {leaf_tol}) {when}")
                worst["cache"] = max(worst["cache"], e)

    logits = one_pass(prompts, "prefill", 0)
    same_caches("after the prefill")
    for t in range(FP32_DECODE_STEPS):
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
        logits = one_pass(tok[:, None], "decode", S + t)
        check(bool(torch.isfinite(logits).all()), "logits finite")
    same_caches(f"after {FP32_DECODE_STEPS} decode steps")
    log(f"[{str(dtype).split('.')[-1]}] {name} kernel vs plain path, layer "
        f"by layer on the plain path's inputs: prefill + "
        f"{FP32_DECODE_STEPS} decode steps, mixer outputs max relative err "
        f"{worst['mixer_rel']:g} (tol {tol}), cache leaves max abs err "
        f"{worst['cache']:g} (fp32 leaves tol {MODEL_TOL})")
    return worst


class recorded_routes:
    """Within the block, record the expert ids every MoE router picks, per
    path (``model.plain_kernels``), so two paths' routing can be compared."""

    def __init__(self, model):
        from repro_torch.models import moe
        self.model, self.moe, self.ids = model, moe, {False: [], True: []}

    def __enter__(self):
        real = self.real = self.moe._route

        def route(cfg, router_w, x):
            gates, ids, aux = real(cfg, router_w, x)
            self.ids[self.model.plain_kernels].append(ids)
            return gates, ids, aux

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real

    def differ(self):
        """(choices that differ between the paths, choices compared): a
        token's top-k set at one router call."""
        n = total = 0
        for a, b in zip(self.ids[False], self.ids[True]):
            a, b = a.sort(-1).values, b.sort(-1).values
            n += int((a != b).any(-1).sum())
            total += a.shape[0]
        return n, total


def train_phase(torch, dev):
    """Phase 11: llama3.2-1b trained at full width through
    ``launch.train.train`` (see the module docstring).  Returns the
    numbers it prints and the kernel launches of the training runs."""
    from repro_torch.ckpt import latest_committed
    from repro_torch.ckpt.commit import CornusCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core.state import Decision
    from repro_torch.core.storage import FileStore
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import (MidCheckpointCrash, RunConfig,
                                          _hosts, train)
    from repro_torch.models import init_model

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    store_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    free_gb = shutil.disk_usage(store_dir).free / 1e9
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mem = train_memory_gb(cfg, TRAIN_BATCH, TRAIN_SEQ)
    # The products the step executes, counted by the dry run's meta pass
    # (phase 25b holds the card's own count to it).
    cost = train_cost(torch)
    executed = cost["flops"]
    check(flops["total"] == executed,
          f"train_flops {flops['total']} != the cost pass's {executed}")
    log(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, "
        f"{spec_elements(cfg)} parameter elements, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, fp32, remat full; FLOPs a step (model = "
        f"params + attention, total = model + recompute, executed) "
        f"{json.dumps(flops)}; memory reckoned {json.dumps(mem)}; disk free "
        f"under build/ {free_gb:.1f} GB")
    run = RunConfig(arch=ARCH, use_smoke=False, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    ckpt_every=TRAIN_STEPS + 1, ckpt_dir=str(store_dir),
                    n_hosts=TRAIN_HOSTS, warmup=2, remat="full", log_every=0,
                    device=str(dev))
    torch.use_deterministic_algorithms(True)
    try:
        # -- checks 1 and 2 on the model at step 0 -----------------------
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, run.seed, device=dev)
        nb = make_pipeline(DataConfig(
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
            seed=run.seed)).batch_at(0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        ops.reset_launch_counts()
        with torch.inference_mode():
            served, _ = model.forward(batch)
        served = float(served)
        served_launches = ops.launch_counts()
        check(served_launches["flash_attention"] == cfg.n_layers,
              f"served forward launches {served_launches}")
        loss0, grads = steps.loss_and_grads(model, batch, remat="full")
        loss0 = float(loss0)
        step0_peak = torch.cuda.max_memory_allocated() / 1e9
        e = abs(loss0 - served) / abs(served)
        log(f"[train] check 1: training forward (plain, with grad) loss "
            f"{loss0!r} vs served forward (kernels, inference_mode) "
            f"{served!r}: relative {e:g} (tol {TRAIN_FWD_TOL})")
        check(e <= TRAIN_FWD_TOL, f"training vs served forward {e:g}")

        params = list(model.parameters())
        gl = [grads[n] for n, _ in model.named_parameters()]

        def loss_at():
            with torch.no_grad():
                return model.forward(batch, plain=True)[0]

        fd = directional_check(loss_at, params, gl, seed=1)
        log(f"[train] check 2: along a random unit direction, eps "
            f"{fd['eps']!r} (3e-3 of the parameters' norm "
            f"{fd['param_norm']:.2f}): <grad, d> {fd['dot']!r}, central "
            f"differences {fd['central_eps']!r} (eps) and "
            f"{fd['central_half_eps']!r} (eps/2), extrapolated {fd['fd']!r}: "
            f"relative {fd['rel']:g} (tol {TRAIN_FD_TOL}); L at +eps, -eps, "
            f"+eps/2, -eps/2: {fd['losses']}")
        check(fd["rel"] <= TRAIN_FD_TOL,
              f"directional derivative off by {fd['rel']:g}")
        del model, grads, gl, params, batch
        gc.collect()
        torch.cuda.empty_cache()

        # -- check 3: the golden run ---------------------------------------
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        golden = train(run)
        train_launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        check(not any(train_launches.values()),
              f"the training path launched kernels: {train_launches}")
        L = golden.losses
        log(f"[train] check 3: golden run losses {L}")
        check(len(L) == TRAIN_STEPS and all(map(math.isfinite, L)),
              "golden losses finite")
        check(golden.losses[0] == loss0,
              f"golden step-0 loss {L[0]!r} != the model's {loss0!r}")
        check(L[5] < L[1], f"step-5 loss {L[5]} not below step-1 {L[1]}")

        # -- check 4: crash mid-checkpoint, then resume through Cornus -----
        crash_run = dataclasses.replace(run, ckpt_every=TRAIN_CKPT_EVERY,
                                        die_mid_checkpoint_at=TRAIN_CRASH_AT)
        crashed = None
        try:
            train(crash_run)
        except MidCheckpointCrash as exc:
            crashed = exc.result
        gc.collect()
        torch.cuda.empty_cache()
        check(crashed is not None, "the crash run did not crash")
        check([o.epoch for o in crashed.ckpt_outcomes] == [TRAIN_CKPT_EVERY]
              and crashed.ckpt_outcomes[0].decision == Decision.COMMIT,
              f"epoch {TRAIN_CKPT_EVERY} did not commit")
        hosts = _hosts(TRAIN_HOSTS)
        store = FileStore(str(store_dir))
        resolver = CornusCheckpointer(store, "restore", hosts)
        states = resolver.read_states(TRAIN_CRASH_AT)
        log(f"[train] after the crash, epoch {TRAIN_CRASH_AT}'s votes "
            f"{ {h: v and v.value for h, v in states.items()} }")
        check(resolver.global_decision(TRAIN_CRASH_AT)
              == Decision.UNDETERMINED, "epoch 6 is not left in flight")
        payload_gb = {h: os.path.getsize(store.data_path(
            h, f"e{TRAIN_CKPT_EVERY:012d}")) / 1e9 for h in hosts}
        t0 = time.perf_counter()
        resumed = train(dataclasses.replace(crash_run, resume=True,
                                            die_mid_checkpoint_at=None))
        resume_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        check(resumed.restored_from == TRAIN_CKPT_EVERY,
              f"resumed from {resumed.restored_from}")
        check(resolver.global_decision(TRAIN_CRASH_AT) == Decision.ABORT,
              "the resume did not force-abort epoch 6")
        check(latest_committed(store, hosts) == TRAIN_CKPT_EVERY,
              "latest committed epoch is not 3")
        want = golden.losses[TRAIN_CKPT_EVERY:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, want))
        log(f"[train] check 4: resumed losses {resumed.losses} vs golden "
            f"{want}: max relative {rel:g} (rtol {TRAIN_RESUME_RTOL})")
        check(len(resumed.losses) == len(want) and rel <= TRAIN_RESUME_RTOL,
              "the resumed run does not reproduce the golden curve")
        check([(o.epoch, o.decision) for o in resumed.ckpt_outcomes]
              == [(TRAIN_CRASH_AT, Decision.ABORT)],
              f"resumed outcomes {resumed.ckpt_outcomes}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store_dir, ignore_errors=True)

    step_s = sorted(golden.step_s[1:])[len(golden.step_s[1:]) // 2]
    epochs = crashed.ckpt_outcomes + resumed.ckpt_outcomes
    out = {
        "arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "dtype": "float32", "remat": "full", "steps": TRAIN_STEPS,
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in golden.step_s],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "model_tflop_per_step": flops["model"] / 1e12,
        "mfu_fp32_67tflops": flops["model"] / step_s / PEAK_FLOPS["float32"],
        "executed_tflop_per_step": executed / 1e12,
        "hfu_fp32_67tflops": executed / step_s / PEAK_FLOPS["float32"],
        "bound_ms": executed / PEAK_FLOPS["float32"] * 1e3,
        "cost_pass": cost,
        "peak_gb": peak_gb, "step0_checks_peak_gb": step0_peak,
        "reckoned_gb": mem["estimate_gb"],
        "payload_gb_per_host": payload_gb,
        "epochs": [{"epoch": o.epoch, "decision": o.decision.value,
                    "vote_ms": o.vote_ms, "resolve_ms": o.resolve_ms,
                    "forced_aborts": o.forced_aborts} for o in epochs],
        "golden_wall_s": golden.wall_s, "crash_run_steps": len(
            crashed.losses), "resume_wall_s": resume_s,
        "check1_rel": e, "check2": fd, "check4_max_rel": rel,
        "served_forward_launches": served_launches,
        "train_launches": train_launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[train] {json.dumps(out)}")
    return out, train_launches


# ---------------------------------------------------------------------------
# Phase 11b: int8 gradient compression in the train step, and the host mesh
# ---------------------------------------------------------------------------
class CompressRecorder:
    """While active, keeps references to what the train step's compression
    was given and made: the gradients handed to
    ``steps._compressed_allreduce`` and each leaf's codes and scale from
    ``steps.compress_gradients``, on the card; and names in ``misplaced``
    each gradient handed to ``steps.adamw_update`` that is not placed as
    its parameter (a DTensor's placements, or a plain tensor beside a
    DTensor).  Nothing is copied during the step; the gradients live on
    past it until the recorder is dropped (through the AdamW update, which
    holds less than the backward)."""

    def __init__(self):
        from repro_torch.launch import steps
        self._steps, self.grads, self.codes = steps, None, {}
        self.misplaced = None

    def __enter__(self):
        self._allreduce = self._steps._compressed_allreduce
        self._compress = self._steps.compress_gradients
        self._adamw = self._steps.adamw_update
        self._steps._compressed_allreduce = self._allreduce_call
        self._steps.compress_gradients = self._compress_call
        self._steps.adamw_update = self._adamw_call
        return self

    def __exit__(self, *exc):
        self._steps._compressed_allreduce = self._allreduce
        self._steps.compress_gradients = self._compress
        self._steps.adamw_update = self._adamw

    def _allreduce_call(self, cfg, grads, ccfg, rules):
        self.grads = grads
        return self._allreduce(cfg, grads, ccfg, rules)

    def _compress_call(self, tree, ccfg, error_buf=None):
        q, s, pre = self._compress(tree, ccfg, error_buf)
        self.codes.update({k: (q[k], s[k]) for k in q})
        return q, s, pre

    def _adamw_call(self, grads, opt_state, params, *args, **kwargs):
        def placed(t):
            return tuple(t.placements) if hasattr(t, "placements") else None
        self.misplaced = [n for n, g in grads.items()
                          if placed(g) != placed(params[n])]
        return self._adamw(grads, opt_state, params, *args, **kwargs)


def whole(t):
    """A DTensor's global value (``full_tensor``); a plain tensor as it
    is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def same_bits(a, b) -> bool:
    """Whether two tensors of one dtype and shape hold the same bits."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return torch.equal(a.reshape(-1).view(ints), b.reshape(-1).view(ints))


def compression_rows(cfg, grads, codes, ccfg):
    """One row per leaf of the JAX package's tree (``convert.jax_layout``:
    a leaf stacked over periods has one scale): whether the codes and scale
    the step made equal, bit for bit, the ones ``compress_gradients``
    makes on the CPU from the same gradients copied to the host, and the
    leaf's largest dequantization error (``q.float() * scale`` against the
    gradient, in float64) beside its scale.  DTensor gradients, codes and
    scales are gathered whole first (``full_tensor``)."""
    import torch

    from repro_torch.convert import jax_layout
    from repro_torch.optim import compress_gradients
    rows = []
    for key, (stacked, names) in jax_layout(cfg, grads).items():
        g = torch.stack([whole(grads[n]) for n in names]) if stacked \
            else whole(grads[names[0]])
        q, s = (whole(t) for t in codes[key])
        hq, hs, _ = compress_gradients({key: g.cpu()}, ccfg)
        err = float((q.float() * s).double().sub_(g.double()).abs_().max())
        scale = float(s)
        rows.append({
            "leaf": key, "elements": g.numel(), "scale": scale,
            "codes_equal": bool(torch.equal(q.cpu(), hq[key])),
            "scale_equal": same_bits(s.cpu(), hs[key]),
            "max_err": err, "err_over_scale": err / scale})
        del g
    return rows


def compression_failures(rows, leaves):
    """The checks phase 11b holds the rows of ``compression_rows`` to:
    every JAX leaf was compressed once, on the card as on the CPU, and each
    leaf's error is within half its scale (``COMPRESS_ERR_SLACK``)."""
    fails = [] if sorted(r["leaf"] for r in rows) == sorted(leaves) else \
        [f"leaves compressed {sorted(leaves)}, rows "
         f"{sorted(r['leaf'] for r in rows)}"]
    fails += [f"{r['leaf']}: the card's codes differ from the CPU's"
              for r in rows if not r["codes_equal"]]
    fails += [f"{r['leaf']}: the card's scale differs from the CPU's"
              for r in rows if not r["scale_equal"]]
    fails += [f"{r['leaf']}: dequantization error {r['max_err']!r} over "
              f"half the scale {r['scale']!r}" for r in rows
              if not r["err_over_scale"] <= 0.5 + COMPRESS_ERR_SLACK]
    return fails


def compress_phase(torch, dev, card):
    """Phase 11b: llama3.2-1b at phase 11's shape (fp32, batch 1 x 4,096,
    remat full, deterministic algorithms), uncompressed and int8-compressed
    steps of ``steps.make_train_step`` from the same start state
    (``init_model`` seed 0, fresh moments) at step index COMPRESS_STEP,
    two of each in the order plain, compressed, compressed, plain, each
    timed (host clock around a synchronized step) with its peak memory.
    The second compressed step's codes and scales are held against the
    CPU's (``compression_rows``) before the last step.  Returns the
    numbers and the kernel launches of the four steps (the training path
    launches none)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import jax_layout
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    nb = make_pipeline(DataConfig(
        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
        seed=0)).batch_at(COMPRESS_STEP)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    ccfg = CompressionConfig()
    # The trainer's settings (launch/train.py: AdamW lr 1e-3, decay 0.01).
    base = steps.TrainSettings(remat="full", opt=AdamWConfig(
        lr=1e-3, weight_decay=0.01), warmup=2, stable=10**6, decay=1)

    def one_step(compress, recorder=None):
        model = init_model(cfg, 0, device=dev)
        opt = adamw_init(dict(model.named_parameters()), base.opt)
        step = steps.make_train_step(cfg, dataclasses.replace(
            base, compress=ccfg if compress else None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if recorder is None:
            _, _, loss = step(model, opt, batch, COMPRESS_STEP)
        else:
            with recorder:
                _, _, loss = step(model, opt, batch, COMPRESS_STEP)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, opt
        return float(loss), ms, peak

    def held_against_the_cpu(rec):
        """The recorded step's codes against the CPU's; the recorder's
        gradients and codes (6.2 GB) are freed before the next step."""
        check(rec.grads is not None and all(
            g.device.type == "cuda" and g.dtype == torch.float32
            for g in rec.grads.values()), "the step's gradients are not "
              "fp32 on the card")
        check(all(q.device.type == "cuda" and q.dtype == torch.int8
                  for q, _ in rec.codes.values()),
              "the step's codes are not int8 on the card")
        t_check = time.perf_counter()
        rows = compression_rows(cfg, rec.grads, rec.codes, ccfg)
        leaves = list(jax_layout(cfg, rec.grads))
        rec.grads, rec.codes = None, {}
        gc.collect()
        torch.cuda.empty_cache()
        return rows, leaves, time.perf_counter() - t_check

    # Plain, compressed, compressed (recorded, then checked), plain: each
    # kind's two steps bracket the other's, so that drift over the four
    # falls on both.
    order = ((False, None), (True, None), (True, CompressRecorder()),
             (False, None))
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launch_counts()
        for compress, rec in order:
            runs.append((compress,) + one_step(compress, rec))
            if rec is not None:
                rows, leaves, check_s = held_against_the_cpu(rec)
        launches = ops.launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    check(not any(launches.values()),
          f"the compressed training path launched kernels: {launches}")
    losses = [r[1] for r in runs]
    check(len(set(losses)) == 1, f"the steps' losses differ from one start "
          f"state: {losses}")
    ms = {c: [r[2] for r in runs if r[0] == c] for c in (False, True)}
    peak = {c: [r[3] for r in runs if r[0] == c] for c in (False, True)}
    n_elem = sum(r["elements"] for r in rows)
    worst = max(rows, key=lambda r: r["err_over_scale"])
    out = {
        "card": card, "arch": cfg.name, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "dtype": "float32", "remat": "full",
        "step_index": COMPRESS_STEP, "loss": losses[0],
        "uncompressed_step_ms": ms[False], "compressed_step_ms": ms[True],
        "compressed_over_uncompressed": sum(ms[True]) / sum(ms[False]),
        "uncompressed_peak_gb": peak[False],
        "compressed_peak_gb": peak[True],
        "leaves": len(rows), "elements": n_elem,
        "codes_equal_leaves": sum(r["codes_equal"] and r["scale_equal"]
                                  for r in rows),
        "max_err_over_scale": worst["err_over_scale"],
        "max_err_leaf": worst["leaf"], "cpu_check_s": check_s,
        "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(f"[compress] {json.dumps(out)}")
    log(f"[compress] per leaf: {json.dumps(rows)}")
    fails = compression_failures(rows, leaves)
    check(not fails, f"[compress] {fails}")
    return out, launches


def tree_leaves(tree):
    """The leaves of a nested dict / list tree, in order (a tuple is a
    leaf)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def host_mesh_phase(torch, dev):
    """Phase 11b, second half: ``make_host_mesh()`` over a one-rank group
    on ``dev`` (NCCL on the card, gloo on the CPU; a ``file://``
    rendezvous in a temporary directory): a (1, 1) ("data", "model") mesh;
    llama3.2-1b's specs placed on it by ``param_shardings`` and
    ``param_structs`` under each profile; one real leaf distributed over
    it and redistributed by ``constrain`` under the fsdp profile, through
    the group's collectives.  The group is destroyed after."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (PROFILES, constrain,
                                             make_rules, use_rules)
    from repro_torch.models import model_specs
    from repro_torch.models.layers import param_shardings, param_structs

    cfg = get_config(ARCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdzv", rank=0, world_size=1)
        try:
            mesh = make_host_mesh(device_type=str(dev))
            out["mesh"] = {"shape": list(mesh.shape),
                           "names": list(mesh.mesh_dim_names),
                           "device_type": mesh.device_type,
                           "backend": dist.get_backend()}
            check(tuple(mesh.shape) == (1, 1)
                  and mesh.mesh_dim_names == ("data", "model")
                  and mesh.device_type == dev.type,
                  f"host mesh {out['mesh']}")
            specs = model_specs(cfg)
            for profile in PROFILES:
                rules = make_rules(mesh, profile)
                placed = tree_leaves(param_shardings(specs, rules))
                structs = tree_leaves(param_structs(specs, rules))
                check(all(tuple(st.to_local().shape) == tuple(st.shape)
                          and st.device.type == "meta" for st in structs),
                      f"{profile}: a leaf's shard is not the whole leaf on "
                      f"one rank")
                out[profile] = {
                    "leaves": len(placed),
                    "sharded_mesh_dims": sum(
                        isinstance(p, Shard) for pl in placed for p in pl),
                    "fallbacks": len(rules.fallbacks)}
            x = torch.randn(4096, 2048, device=dev)
            dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            with use_rules(make_rules(mesh, "fsdp")):
                y = constrain(dx, ("fsdp", None))
            check(tuple(y.placements) == (Shard(0), Shard(0)),
                  f"constrain placed {y.placements}")
            check(torch.equal(y.full_tensor(), x),
                  "the redistributed leaf differs from the original")
            out["constrain"] = [str(p) for p in y.placements]
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived the phase")
    log(f"[host mesh] {json.dumps(out)}")
    return out


def sharded_step_phase(torch, dev, cfg=None, *, serve_cfg=None,
                       serve_dtype="bfloat16", compress=False):
    """Phase 11c: ``cfg`` (default llama3.2-1b at full width) on DTensor
    parameters over the (1, 1) mesh of ``make_host_mesh()`` (NCCL on the
    card, gloo on the CPU; a ``file://`` rendezvous), under each profile of
    ``PROFILES``, against the same weights as plain tensors (see the module
    docstring): the fp32 train step on ``cfg``, the prefill and decode
    steps on ``serve_cfg`` (default ``cfg``) in ``serve_dtype``.  Each
    plain run is freed before the DTensor runs start.  Where its updated
    leaves, three times over, would not fit the card beside a DTensor
    run's (phase 11d: a model and its optimizer fill most of the card),
    they wait on the host and come back one at a time to be compared.
    With ``compress`` (phase 11c), an int8-compressed train step
    (``CompressionConfig()``) follows each uncompressed one, plain and
    under each profile, from the same start state; each DTensor step's
    loss and leaves are held to the plain compressed step's, its codes and
    scales (``CompressRecorder``) to the plain step's bit for bit, and
    every gradient it hands AdamW must be placed as its parameter.  Every
    train step is timed (host clock around a synchronized step) with its
    peak memory on the card, and the uncompressed DTensor step is run
    once more after the compressed one (timed only).  Returns the numbers
    it prints and
    the kernel launches of the DTensor runs (counters set to 0 before the
    first, read after the last; the plain runs they are held to are not
    counted)."""
    import contextlib
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import PROFILES, make_rules
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init

    t_phase = time.perf_counter()
    cfg = cfg or get_config(ARCH)
    serve_cfg = serve_cfg or cfg
    tag = f"sharded {cfg.name}"
    card_bytes = (torch.cuda.get_device_properties(dev).total_memory
                  if dev.type == "cuda" else math.inf)
    serve_dt = getattr(torch, serve_dtype)
    B, S = SHARDED_TRAIN
    nb = make_pipeline(DataConfig(batch=B, seq_len=S,
                                  vocab_size=cfg.vocab_size,
                                  seed=0)).batch_at(COMPRESS_STEP)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    # The trainer's settings (launch/train.py: AdamW lr 1e-3, decay 0.01),
    # at step index 1, where the learning rate is above 0.
    settings = steps.TrainSettings(remat="none", opt=AdamWConfig(
        lr=1e-3, weight_decay=0.01), warmup=2, stable=10**6, decay=1)

    def train(rules, recorder=None):
        """One train step from the start state, under deterministic
        algorithms; compressed when a ``CompressRecorder`` records it.
        Returns (loss, leaves, step ms, peak GB on the card)."""
        torch.use_deterministic_algorithms(True)
        try:
            model = init_model(cfg, 0, device=dev, rules=rules)
            opt = adamw_init(dict(model.named_parameters()), settings.opt)
            step = steps.make_train_step(cfg, dataclasses.replace(
                settings, compress=None if recorder is None else
                CompressionConfig()), rules)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with recorder or contextlib.nullcontext():
                _, _, loss = step(model, opt, batch, COMPRESS_STEP)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.use_deterministic_algorithms(False)
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        if recorder is not None:
            recorder.grads = None
        leaves = {f"params/{n}": p.detach()
                  for n, p in model.named_parameters()}
        leaves.update({f"{k}/{n}": t for k in ("m", "v")
                       for n, t in opt[k].items()})
        if rules is None and 3 * sum(t.numel() * t.element_size()
                                     for t in leaves.values()) > card_bytes:
            leaves = {n: t.cpu() for n, t in leaves.items()}
        return loss, leaves, ms, peak

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def served(model, rules):
        """Prefill of BATCH x PROMPT and SHARDED_DECODE_STEPS decode steps,
        each fed the plain run's greedy token: the logits, on the host."""
        prompt = prompt_batch(serve_cfg, BATCH, PROMPT, dev)
        logits, cache = steps.make_prefill_step(serve_cfg, MAX_LEN, rules)(
            model, prompt)
        out = [local(logits).float().cpu()]
        decode = steps.make_decode_step(serve_cfg, rules)
        for i in range(SHARDED_DECODE_STEPS):
            logits, cache = decode(model, {"tokens": tokens[i]}, cache,
                                   PROMPT + i)
            out.append(local(logits).float().cpu())
        return out

    def held(what, got, want, tol):
        """Bit for bit, or the largest difference, held to ``tol``; each
        wanted tensor is brought to its counterpart's device in turn.  A
        value that is not finite, on either side, fails."""
        err, exact, finite = 0.0, True, True
        for g, w in zip(got, want):
            w = w.to(g.device)
            finite = finite and bool(torch.isfinite(g).all()
                                     and torch.isfinite(w).all())
            err = max(err, float((g.float() - w.float()).abs().max()))
            exact = exact and torch.equal(g, w)
            del w
        check(finite, f"[{tag}] {what}: a value is not finite")
        check(err <= tol, f"[{tag}] {what}: {err} > {tol}")
        return {"exact": exact, "max_abs_err": err}

    def train_held(what, loss, got, want_loss, want):
        """A train step's loss and updated leaves against the plain
        step's (``held``)."""
        names = sorted(want)
        check(sorted(got) == names, f"[{tag}] {what}: leaves")
        return held(what, [local(loss).cpu()] + [local(got[n])
                                                 for n in names],
                    [torch.tensor(want_loss)] + [want[n] for n in names],
                    TOL["float32"])

    def codes_held(what, rec, want_codes):
        """The recorded codes and scales, gathered whole, against the
        plain compressed step's, bit for bit; a scale that is not finite
        fails, and so does a gradient handed to AdamW placed otherwise
        than its parameter."""
        check(sorted(rec.codes) == sorted(want_codes),
              f"[{tag}] {what}: leaves quantized {sorted(rec.codes)}")
        equal = 0
        for key, (q, s) in rec.codes.items():
            q, s = whole(q), whole(s)
            check(bool(torch.isfinite(s).all()),
                  f"[{tag}] {what}: {key}'s scale {s} is not finite")
            wq, ws = want_codes[key]
            equal += bool(torch.equal(q, wq)) and same_bits(s, ws)
            del q
        check(equal == len(want_codes), f"[{tag}] {what}: codes or scales "
              f"of {len(want_codes) - equal} of {len(want_codes)} leaves "
              f"differ from the plain step's")
        check(rec.misplaced == [], f"[{tag}] {what}: gradients handed to "
              f"AdamW not placed as their parameters: {rec.misplaced}")
        return {"leaves": len(want_codes), "equal": equal}

    out = {"arch": cfg.name, "train_layers": cfg.n_layers,
           "train_batch": [B, S], "serve_layers": serve_cfg.n_layers,
           "serve_dtype": serve_dtype, "profiles": {}}
    want_loss, want, ms, peak = train(None)
    want_loss = float(want_loss)
    out["plain"] = {"step_ms": ms, "peak_gb": peak}
    release_cuda()
    if compress:
        rec = CompressRecorder()
        want_closs, want_c, ms, peak = train(None, rec)
        want_closs = float(want_closs)
        want_codes = rec.codes
        del rec
        check(all(bool(torch.isfinite(s).all())
                  for _, s in want_codes.values()),
              f"[{tag}] plain compressed step: a scale is not finite")
        out["plain"].update(compressed_step_ms=ms, compressed_peak_gb=peak,
                            leaves=len(want_codes))
        release_cuda()
    # The plain kernel run, and the greedy tokens both runs are fed.
    plain = init_model(serve_cfg, 0, dtype=serve_dt, device=dev)
    tokens = []
    prompt = prompt_batch(serve_cfg, BATCH, PROMPT, dev)
    with torch.inference_mode():
        logits, cache, _ = plain.prefill(prompt, MAX_LEN)
        want_served = [logits.float().cpu()]
        for i in range(SHARDED_DECODE_STEPS):
            tokens.append(logits[:, -1:, :serve_cfg.vocab_size].argmax(-1))
            logits, cache = plain.decode_step({"tokens": tokens[i]}, cache,
                                              PROMPT + i)
            want_served.append(logits.float().cpu())
    del plain, cache, logits
    release_cuda()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdzv", rank=0, world_size=1)
        try:
            mesh = make_host_mesh(device_type=str(dev))
            ops.reset_launch_counts()
            for profile in PROFILES:
                rules = make_rules(mesh, profile)
                t0 = time.perf_counter()
                loss, got, ms, peak = train(rules)
                row = {"train_s": time.perf_counter() - t0, "step_ms": ms,
                       "peak_gb": peak}
                row["loss"] = [float(local(loss)), want_loss]
                row["train"] = train_held(f"{profile} train", loss, got,
                                          want_loss, want)
                del got, loss
                release_cuda()
                if compress:
                    rec = CompressRecorder()
                    loss, got, ms, peak = train(rules, rec)
                    row.update(compressed_step_ms=ms,
                               compressed_peak_gb=peak)
                    row["compressed_loss"] = [float(local(loss)),
                                              want_closs]
                    row["compressed_train"] = train_held(
                        f"{profile} compressed train", loss, got,
                        want_closs, want_c)
                    row["codes"] = codes_held(f"{profile} compressed train",
                                              rec, want_codes)
                    del got, loss, rec
                    release_cuda()
                    # The uncompressed step again, timed only: the first
                    # step of a profile also pays a warm-up.
                    loss, got, ms, peak = train(rules)
                    check(float(local(loss)) == want_loss,
                          f"[{tag}] {profile}: the repeated step's loss")
                    row["step_again_ms"] = ms
                    del loss, got
                    release_cuda()
                    log(f"[{tag}] {profile}: train step ms "
                        f"{row['step_ms']:.1f}, compressed "
                        f"{row['compressed_step_ms']:.1f}, uncompressed "
                        f"again {ms:.1f}; peak GB {row['peak_gb']}, "
                        f"compressed {row['compressed_peak_gb']}")
                t0 = time.perf_counter()
                model = init_model(serve_cfg, 0, dtype=serve_dt, device=dev,
                                   rules=rules)
                row["serve"] = held(f"{profile} prefill + decode",
                                    served(model, rules), want_served,
                                    TOL[serve_dtype])
                row["serve_s"] = time.perf_counter() - t0
                del model
                release_cuda()
                out["profiles"][profile] = row
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived the phase")
    if dev.type == "cuda":
        want_launches = {k: len(PROFILES) * n for k, n in wave_launches(
            serve_cfg, SHARDED_DECODE_STEPS).items()}
        check(launches == want_launches,
              f"[{tag}] launches {launches}, not {want_launches}: the "
              f"DTensor runs did not go through the kernels once a layer a "
              f"pass")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] {json.dumps(out)}")
    return out, launches


def release_cuda():
    """Collect the garbage, and return the card's cached blocks."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def moe_sharded_step_phase(torch, dev, cfg=None):
    """Phase 11d: qwen3-moe-235b-a22b at full width (``cfg`` replaces it,
    as the CPU test gives a smoke config) on DTensor parameters over the
    (1, 1) mesh under each profile (``sharded_step_phase``): the fp32 train
    step cut to MOE_SHARDED_TRAIN_LAYERS layer(s) (the plain run's leaves
    wait on the host), and an fp32 prefill and decode steps at phase 21's
    QWEN3MOE_FP32_LAYERS layers through the kernel path.  One rank holds
    every expert: ep = 1, the single-shard MoE on DTensors."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(QWEN3MOE)
    train_cfg = dataclasses.replace(cfg, n_layers=min(
        cfg.n_layers, MOE_SHARDED_TRAIN_LAYERS))
    serve_cfg = dataclasses.replace(cfg, n_layers=min(
        cfg.n_layers, QWEN3MOE_FP32_LAYERS))
    log(f"[sharded] {cfg.name}: train {train_cfg.n_layers} of "
        f"{cfg.n_layers} layers in fp32 ({spec_elements(train_cfg)} "
        f"parameter elements), serve {serve_cfg.n_layers} in fp32; widths "
        f"as published (d_model {cfg.d_model}, {cfg.n_experts} experts "
        f"top-{cfg.experts_per_token} of d_ff {cfg.expert_d_ff})")
    return sharded_step_phase(torch, dev, train_cfg, serve_cfg=serve_cfg,
                              serve_dtype="float32")


def recurrent_sharded_step_phase(torch, dev, cfgs=None):
    """Phase 11e: jamba-v0.1-52b and xlstm-125m at full width (``cfgs``,
    {name: config}, replaces them, as the CPU test gives smoke configs) on
    DTensor parameters over the (1, 1) mesh under each profile
    (``sharded_step_phase``).  Jamba: the fp32 train step cut to its first
    JAMBA_SHARDED_TRAIN_LAYERS layers (a mamba mixer with a dense FFN,
    then one with an MoE; the plain run's leaves wait on the host), an
    fp32 prefill and decode steps at phase 9's JAMBA_FP32_LAYERS (one
    period, its attention layer included).  xLSTM whole: the fp32 train
    step, a bf16 prefill and decode steps.  The mamba and mLSTM scans run
    on the DTensors' local shards.  Returns [(out, launches)] for Jamba,
    then xLSTM."""
    from repro_torch.configs import get_config
    cfgs = cfgs or {a: get_config(a) for a in (JAMBA, XLSTM)}
    jcfg, xcfg = cfgs[JAMBA], cfgs[XLSTM]
    train_cfg = dataclasses.replace(jcfg, n_layers=min(
        jcfg.n_layers, JAMBA_SHARDED_TRAIN_LAYERS))
    serve_cfg = dataclasses.replace(jcfg, n_layers=min(
        jcfg.n_layers, JAMBA_FP32_LAYERS))
    log(f"[sharded] {jcfg.name}: train {train_cfg.n_layers} of "
        f"{jcfg.n_layers} layers in fp32 ({spec_elements(train_cfg)} "
        f"parameter elements), serve {serve_cfg.n_layers} in fp32; "
        f"{xcfg.name} whole (train fp32, serve bf16); widths as published")
    return [sharded_step_phase(torch, dev, train_cfg, serve_cfg=serve_cfg,
                               serve_dtype="float32"),
            sharded_step_phase(torch, dev, xcfg)]


# ---------------------------------------------------------------------------
# Phase 25: flash_attention at 32,768 query tokens; the cost pass on the card
# ---------------------------------------------------------------------------
class chunk_calls:
    """Within the block, count the calls of ``layers._chunked_attention``
    (``layers.attention`` looks it up at call time)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.calls = layers, 0

    def __enter__(self):
        real = self.real = self.layers._chunked_attention

        def counted(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        self.layers._chunked_attention = counted
        return self

    def __exit__(self, *exc):
        self.layers._chunked_attention = self.real


def oracle_failures(err, tol, rel_err, rel_tol, seq, chunked_calls,
                    peak_bytes, full_scores_bytes):
    """What phase 25a holds one long-prefill comparison to: the kernel
    within ``tol`` of the oracle, and within ``rel_tol`` of it in
    ``block_rel_err``'s measure (``rel_err``), the oracle's sequence above
    the plain attention's threshold, the switch taken once to the chunked
    path, and the oracle's peak device memory below the whole fp32 score
    tensor the unchunked path would build.  Returns the failed checks."""
    from repro_torch.models import layers
    out = []
    if not err <= tol:
        out.append(f"max abs err {err:g} against the oracle (tol {tol})")
    if not rel_err <= rel_tol:
        out.append(f"block relative err {rel_err:g} against the oracle "
                   f"(tol {rel_tol})")
    if seq <= layers.CHUNK_THRESHOLD:
        out.append(f"{seq} query tokens do not pass the threshold "
                   f"{layers.CHUNK_THRESHOLD}")
    if chunked_calls != 1:
        out.append(f"layers.attention took the chunked path "
                   f"{chunked_calls} times, not once")
    if not peak_bytes < full_scores_bytes:
        out.append(f"the oracle's peak {peak_bytes} B is not below the "
                   f"whole score tensor's {full_scores_bytes} B")
    return out


def flop_failures(card: int, meta: int, what: str):
    """Phase 25b: the card's count of the step's products must equal the
    meta pass's exactly."""
    if card == meta and meta > 0:
        return []
    return [f"{what}: {card} FLOPs counted on the card, {meta} on meta"]


def long_attention_phase(torch, dev, randn):
    """Phase 25a: one ``ops.attention`` call (the model's entry to
    ``flash_attention``) per case of LONG_CASES at LONG_SEQ causal query
    tokens, counted, each held against ``layers.attention``, which takes
    ``_chunked_attention`` above its threshold (``oracle_failures``);
    then each case's kernel, oracle and SDPA times with a cold L2 beside
    its bound.  Returns (the counted launches, the kernels line's keys)."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ops
    from repro_torch.models import layers

    keys, inputs = {}, {}
    ops.reset_launch_counts()
    for i, (tag, hq, hkv, hd, dtype) in enumerate(LONG_CASES):
        q, k, v = (randn(400 + 10 * i + j, (1, LONG_SEQ, h, hd), dtype)
                   for j, h in enumerate((hq, hkv, hkv)))
        inputs[tag] = (q, k, v)
        with torch.inference_mode():
            got = ops.attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with chunk_calls() as calls:
                want = layers.attention(q, k, v, causal=True)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        err = max_err(got, want)
        rel = block_rel_err(got, want)
        full = 4 * hq * LONG_SEQ * LONG_SEQ
        failed = oracle_failures(err, TOL[dtype], rel, LONG_REL_TOL[dtype],
                                 LONG_SEQ, calls.calls, peak, full)
        log(f"[long] {tag}: q (1,{LONG_SEQ},{hq},{hd}) k,v (1,{LONG_SEQ},"
            f"{hkv},{hd}) {dtype} causal: kernel vs chunked oracle max abs "
            f"err {err:g} (tol {TOL[dtype]}), block relative err {rel:g} "
            f"(tol {LONG_REL_TOL[dtype]}, blocks of {LONG_BLOCK} rows); "
            f"oracle peak {peak / 1e9:.3f} GB against {full / 1e9:.1f} GB "
            f"of whole fp32 scores; {calls.calls} chunked call")
        check(not failed and got.dtype == want.dtype,
              f"{tag} at {LONG_SEQ} tokens: {failed}")
        keys[f"q32k_{tag.replace(' ', '_')}_max_abs_err"] = err
        keys[f"q32k_{tag.replace(' ', '_')}_block_rel_err"] = rel
        del got, want
    launches = ops.launch_counts()
    check(launches["flash_attention"] == len(LONG_CASES)
          and sum(launches.values()) == len(LONG_CASES),
          f"phase 25a launches {launches}")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for tag, hq, hkv, hd, dtype in LONG_CASES:
        q, k, v = inputs.pop(tag)
        g = hq // hkv
        key = f"q32k_{tag.replace(' ', '_')}"
        bound = attention_bound(1, hq, hkv, LONG_SEQ, LONG_SEQ, hd,
                                causal=True, dtype=dtype)
        with torch.inference_mode():
            ms = cold_device_ms(torch, flush, lambda: ops.attention(
                q, k, v, causal=True), iters=10, warmup=2)
            plain_ms = cold_device_ms(torch, flush, lambda: layers.attention(
                q, k, v, causal=True), iters=2, warmup=1)
            # SDPA on the kv heads expanded to q's; in fp32 its
            # memory-efficient backend, which takes fp32 (never the math
            # backend's 32 x 32,768^2 score tensor).
            qh = q.transpose(1, 2).contiguous()
            kh, vh = (t.transpose(1, 2).repeat_interleave(g, dim=1)
                      .contiguous() for t in (k, v))
            with (contextlib.nullcontext() if dtype == "bfloat16" else
                  sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)):
                lib_ms = cold_device_ms(
                    torch, flush, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True), iters=10, warmup=2)
            del qh, kh, vh
        keys.update({
            f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
            f"{key}_library_ms": lib_ms, f"{key}_bound_ms": bound[0],
            f"{key}_bound_by": bound[1], f"{key}_bytes": bound[2],
            f"{key}_flops": bound[3],
            f"{key}_shape": f"q (1,{hq},{LONG_SEQ},{hd}) k,v (1,{hkv},"
                            f"{LONG_SEQ},{hd}) {dtype} causal"})
        log(f"[long] {tag}: flash_attention {ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), chunked oracle {plain_ms:.1f} "
            f"ms, SDPA {lib_ms:.4f} ms")
        del q, k, v
    del flush
    return launches, keys


def on_card(torch, tree, cfg, dev, gen):
    """A struct tree of ``launch.dryrun.step_specs`` as tensors on the
    card: token ids drawn below the vocabulary, the rest zeros (the
    optimizer's moments and the cache start at zero); ints stay."""
    if isinstance(tree, dict):
        return {k: on_card(torch, v, cfg, dev, gen) for k, v in tree.items()}
    if isinstance(tree, int):
        return tree
    if tree.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, tuple(tree.shape),
                             generator=gen, device=dev, dtype=torch.int32)
    return torch.zeros(tuple(tree.shape), dtype=tree.dtype, device=dev)


def card_cost(torch, dev, cfg, shape, settings, dtype, meta=None):
    """(the products the step counts on ``dev``, the meta pass): the
    step of ``shape``'s kind run once on the card under FlopCounterMode,
    on a seeded model in ``dtype`` on the plain path, with inputs of
    ``input_specs``' shapes; and ``dryrun.cost_pass`` of the same, unless
    the caller has it (``meta``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.models import init_model
    if meta is None:
        meta = dryrun.cost_pass(cfg, shape, settings, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_model(cfg, 0, dtype=dtype, device=dev)
    model.plain_kernels = True
    specs = on_card(torch, dryrun.step_specs(cfg, shape, settings, dtype),
                    cfg, dev, gen)
    specs.pop("params")
    fn, args = dryrun.step_call(cfg, shape, settings, specs, model)
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in out
              if isinstance(t, torch.Tensor)), f"{shape.name} outputs finite")
    card = int(counter.get_total_flops())
    del model, specs, args, out
    gc.collect()
    torch.cuda.empty_cache()
    return card, meta


def cost_vs_card_phase(torch, dev, card_name, train_out, served):
    """Phase 25b: phase 11's step and phase 5's served shapes counted on
    the card and on meta (``flop_failures``), each cost pass's compute and
    memory terms over the peaks beside the measured ms.  The train row
    takes phase 11's own cost pass (``train_out["cost_pass"]``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import ShapeConfig
    cfg = get_config(ARCH)
    rows = []
    for what, shape, settings, dtype, measured, meta in (
            ("train (phase 11)", ShapeConfig("train", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"),
             steps.TrainSettings(remat="full", warmup=2), "float32",
             ("step_ms", train_out["step_ms"]), train_out["cost_pass"]),
            ("prefill (phase 5)", ShapeConfig("prefill", PROMPT, BATCH,
                                              "prefill"),
             steps.TrainSettings(), "bfloat16",
             ("prefill_ms", served[ARCH]["prefill_ms"]), None),
            ("decode (phase 5)", ShapeConfig("decode", MAX_LEN, BATCH,
                                             "decode"),
             steps.TrainSettings(), "bfloat16",
             ("decode_ms_per_token", served[ARCH]["decode_ms_per_token"]),
             None)):
        card, meta = card_cost(torch, dev, cfg, shape, settings,
                               getattr(torch, dtype), meta)
        failed = flop_failures(card, meta["flops"], what)
        row = {"what": what, "shape": f"{shape.global_batch} x "
               f"{shape.seq_len} {shape.kind}", "dtype": dtype,
               "card_flops": card, "meta_flops": meta["flops"],
               "meta_flops_by_op": meta["flops_by_op"],
               "meta_unfused_bytes": meta["bytes"],
               "meta_temp_bytes": meta["temp_bytes"],
               "compute_ms": meta["flops"] / PEAK_FLOPS[dtype] * 1e3,
               "memory_ms": meta["bytes"] / HBM_BYTES_PER_S * 1e3,
               measured[0]: measured[1], "meta_pass_s": meta["seconds"]}
        rows.append(row)
        log(f"[cost] {json.dumps(row)}")
        check(not failed, f"{failed}")
    log(f"[cost] terms over {card_name}'s published peaks (989 TFLOP/s "
        f"bf16, 67 TFLOP/s fp32, 3.35 TB/s); memory_ms counts every aten "
        f"op's unfused bytes")
    return rows


def dryrun_layout_phase(torch):
    """Phase 25c: ``launch.dryrun`` for llama3.2-1b at the four shapes on
    the (16, 16) layout (records under build/dryrun_torch), and
    ``launch.roofline.table`` of them.  It needs no card, and leaves no
    process group behind."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, roofline
    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    rc = dryrun.main(["--arch", ARCH, "--mesh", "single", "--out", str(out)])
    check(rc == 0 and not dist.is_initialized(),
          f"the dry run of {ARCH} failed or left a process group")
    log(f"[dryrun] {ARCH} on the (16, 16) layout, bf16 peak:\n"
        f"{roofline.table(str(out))}")


# ---------------------------------------------------------------------------
# Phase 26: the discrete-event half of the commit core
# ---------------------------------------------------------------------------
def sim_values(core, txn) -> Dict[str, tuple]:
    """Phase 26's runs on one package's commit core (``core`` and ``txn``
    are its ``core`` and ``txn`` packages), keyed as ``SIM_PINNED``.  Each
    ``run_bench`` runs in this process: no trial pool, no fork."""
    nodes = list(SIM_NODES)
    out: Dict[str, tuple] = {}

    def summary(r):
        return (r.commits, r.aborts, r.avg_latency_ms, r.p99_latency_ms)

    def ycsb(nodes, seed):
        return txn.YCSBWorkload(nodes, theta=0.0, keys_per_partition=10_000,
                                read_ratio=0.5, seed=seed)

    for tag, model in (("redis", core.AZURE_REDIS),
                       ("blob", core.AZURE_BLOB)):
        for proto in ("cornus", "2pc"):
            out[f"fig5/{tag}/{proto}"] = summary(txn.run_bench(
                ycsb, model, txn.BenchConfig(protocol=proto, n_nodes=4,
                                             horizon_ms=900.0, seed=1)))
    sched = core.FaultSchedule.generate(seed=3, nodes=nodes,
                                        horizon_ms=400.0)
    r = txn.run_bench(ycsb, core.AZURE_REDIS, txn.BenchConfig(
        protocol="cornus", n_nodes=4, horizon_ms=400.0, seed=3, chaos=sched,
        record_history=True))
    out["chaos"] = (r.commits, r.aborts, r.avg_latency_ms, r.violations)

    def geo(nodes, seed):
        return txn.GeoYCSBWorkload(nodes, SIM_GEO_PLACEMENT, "us-east",
                                   accesses_per_txn=4, seed=seed)

    for proto in ("cornus", "2pc"):
        out[f"geo/{proto}"] = summary(txn.run_bench(
            geo, core.AZURE_REDIS, txn.BenchConfig(
                protocol=proto, n_nodes=4, horizon_ms=4000.0, replication=3,
                topology=core.CROSS_REGION, placement=SIM_GEO_PLACEMENT,
                replica_regions=list(SIM_GEO_REPLICAS),
                coordinator_nodes=["n0"], seed=7)))
    for row in core.SIMULATED_RTT_ROWS:
        out[f"table3/{row}"] = (core.measured_caller_latency_ms(row, 10.0),
                                core.predicted_caller_latency_ms(row, 10.0))
    for proto in ("2pc", "cornus"):
        sim = core.Sim()
        cluster = core.Cluster(
            sim, core.SimStorage(sim, core.AZURE_REDIS, seed=7), nodes,
            core.ProtocolConfig(protocol=proto))
        cluster.fail("n0", 1.0)
        cluster.run_txn(core.TxnSpec(txn_id="t", coordinator="n0",
                                     participants=nodes))
        sim.run(until=120_000)
        rows = []
        for n in nodes[1:]:
            d = cluster.local.get((n, "t"), {}).get("decision")
            o = cluster.outcomes.get(("t", n))
            rows.append((n, d.name if d else "BLOCKED",
                         cluster.blocked.get(("t", n), False),
                         o.termination_ms if o and o.ran_termination
                         else None))
        out[f"nonblocking/{proto}"] = tuple(rows)
    return out


def sim_phase(card: str) -> Dict[str, tuple]:
    """Phase 26: ``sim_values`` on the port, each value held to
    ``SIM_PINNED`` with ``==``; prints the Fig 5 speedups with their band
    verdicts and the phase's wall seconds beside the card."""
    from repro_torch import core, txn
    t0 = time.perf_counter()
    got = sim_values(core, txn)
    wall = time.perf_counter() - t0
    check(sorted(got) == sorted(SIM_PINNED),
          f"phase 26 ran {sorted(got)}, pinned {sorted(SIM_PINNED)}")
    for key, want in SIM_PINNED.items():
        check(got[key] == want, f"phase 26 {key}: {got[key]!r} != {want!r}")
    for tag, (lo, hi) in SIM_FIG5_BANDS.items():
        sp = got[f"fig5/{tag}/2pc"][2] / got[f"fig5/{tag}/cornus"][2]
        verdict = "within" if lo < sp < hi else "OUTSIDE"
        log(f"[sim] fig5 {tag}: cornus {got[f'fig5/{tag}/cornus'][2]!r} "
            f"sim ms, 2pc {got[f'fig5/{tag}/2pc'][2]!r} sim ms, speedup "
            f"{sp!r} ({verdict} ({lo}, {hi}))")
    geo = {p: got[f"geo/{p}"][2] for p in ("cornus", "2pc")}
    table3 = {k[len("table3/"):]: v[0] for k, v in got.items()
              if k.startswith("table3/")}
    log(f"[sim] geo R=3: cornus {geo['cornus']!r} sim ms, 2pc "
        f"{geo['2pc']!r} sim ms, speedup {geo['2pc'] / geo['cornus']!r}; "
        f"chaos {got['chaos']}; table3 {table3}")
    log(f"[sim] nonblocking: 2pc {got['nonblocking/2pc']}; cornus "
        f"{got['nonblocking/cornus']}")
    log(f"[sim] phase 26: {len(SIM_PINNED)} values equal to the JAX "
        f"package's; {wall:.3f} s wall on the host of {card}")
    return got


def chaos_cell(core, txn, proto: str, mix: str, replication: int,
               seed: int, horizon_ms: float):
    """One chaos cell on one package's commit core, as
    benchmarks/chaos.run_one builds it (4 nodes, 2 clients a node, fresh
    retry ids, history checked; checksums + GC + scrub armed under the
    "rot" mix): (commits, aborts, avg caller latency in sim ms,
    violations, GC truncations)."""
    nodes = list(SIM_NODES)
    sched = core.FaultSchedule.generate(
        seed, nodes, horizon_ms, replication if replication > 1 else 0, mix)
    cfg = txn.BenchConfig(
        protocol=proto, n_nodes=4, threads_per_node=2, horizon_ms=horizon_ms,
        seed=seed, replication=replication, retry_fresh_ids=True,
        chaos=sched, record_history=True,
        lifecycle=(dict(checksums=True, gc=True, scrub=True,
                        gc_interval_ms=25.0, scrub_interval_ms=40.0)
                   if mix == "rot" else None))
    r = txn.run_bench(lambda nodes, seed: txn.YCSBWorkload(nodes,
                                                           seed=seed),
                      core.AZURE_REDIS, cfg)
    return (r.commits, r.aborts, r.avg_latency_ms, r.violations,
            r.gc_truncations)


def rot_values(core, txn) -> Dict[str, tuple]:
    """Phase 26b's ``ROT_CELLS`` on one package, keyed as ``ROT_PINNED``."""
    return {f"rot/{proto}/r{replication}/s{seed}":
            chaos_cell(core, txn, proto, "rot", replication, seed,
                       ROT_HORIZON_MS)
            for proto, replication, seed in ROT_CELLS}


def rot_phase(card: str) -> Dict[str, tuple]:
    """Phase 26b: ``rot_values`` on the port, each held to ``ROT_PINNED``
    with ``==``, then the repaired 2PC cells; every cell must have no
    violation and commits, and under "rot" GC truncations.  Prints each
    cell and the phase's wall seconds beside the card."""
    from repro_torch import core, txn
    t0 = time.perf_counter()
    got = rot_values(core, txn)
    for mix, replication, seed, horizon in REPAIRED_CELLS:
        got[f"repaired/2pc/{mix}/r{replication}/s{seed}"] = chaos_cell(
            core, txn, "2pc", mix, replication, seed, horizon)
    wall = time.perf_counter() - t0
    for key, want in ROT_PINNED.items():
        check(got[key] == want, f"phase 26b {key}: {got[key]!r} != {want!r}")
    for key, (commits, _aborts, _avg, violations, gc_n) in got.items():
        rot = key.startswith("rot/") or "/rot/" in key
        check(violations == 0 and commits > 0 and (gc_n > 0 or not rot),
              f"phase 26b {key}: {violations} violations, {commits} "
              f"commits, {gc_n} GC truncations")
        log(f"[rot] {key}: commits {commits}, violations {violations}, "
            f"gc truncations {gc_n}")
    log(f"[rot] phase 26b: {len(ROT_PINNED)} cells equal to the JAX "
        f"package's, {len(REPAIRED_CELLS)} repaired 2PC cells "
        f"certified; {wall:.3f} s wall on the host of {card}")
    return got


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # cuBLAS is deterministic only with a fixed workspace, which must be set
    # before its first call; the training phase needs it (phase 11).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 3
    return run(torch)


def run(torch) -> int:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.serve import ServeConfig
    from repro_torch.models import init_model
    from repro_torch.serve import (AdmissionConfig, ContinuousBatcher,
                                   KernelDecode, StepRequest)

    dev = torch.device("cuda")
    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    build_s = _build.build_all()
    log(f"[build] {list(_build.KERNELS)} in {build_s:.1f} s")
    # The four kernels redesigned for Hopper: per entry function its
    # registers, spills and shared memory (dynamic, from the wrappers'
    # reckoning, beside ptxas's static), no spills allowed; the bf16
    # attention's products on the tensor cores (HGMMA in its SASS), and the
    # mLSTM prefill's on them as 3xTF32 (HMMA .TF32).
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     mamba_scan, mlstm_scan)
    def wide_smem(group, hd, item):
        return decode_attention.plan(4, group, 1, hd, 8000, item).smem

    for name in _build.KERNELS:
        for fn, (regs, st, ld, smem) in ptxas_report(
                _build.build_log(name)).items():
            dyn = ""
            param = re.search(r"Li(\d+)E", fn)
            if "attn_wgmma_kernel" in fn:
                hp = int(fn.split("attn_wgmma_kernelILi")[1].split("E")[0])
                dyn = f", {flash_attention.wgmma_smem_bytes(hp)} B dynamic"
            elif "decode_kernel" in fn:
                item = 2 if "bfloat16" in fn else 4
                dyn = (f", {decode_attention.smem_bytes(4, 128, item)} B "
                       f"dynamic at g 4, hd 128, "
                       f"{decode_attention.smem_bytes(2, 256, item)} B at "
                       f"g 2, hd 256, "
                       f"{decode_attention.smem_bytes(16, 128, item)} B at "
                       f"g 16, hd 128, "
                       f"{decode_attention.smem_bytes(8, 112, item)} B at "
                       f"g 8, hd 112, "
                       f"{wide_smem(48, 128, item)} B at g 48, hd 128 (3 "
                       f"group slices), {wide_smem(8, 512, item)} B at g 8, "
                       f"hd 512")
            elif name == "mlstm_scan" and "scan_kernel" in fn and param:
                et = int(param.group(1))
                dyn = (f", {mlstm_scan.scan_smem_bytes(MLSTM_HD, et)} B "
                       f"dynamic at hd {MLSTM_HD}, slab {et}")
            elif name == "mamba_scan" and "scan_kernel" in fn and param:
                smem_dyn = mamba_scan.scan_smem_bytes(
                    int(param.group(1)), 2 if "bfloat16" in fn else 4)
                dyn = f", {smem_dyn} B dynamic"
            log(f"[ptxas {name}] {fn}: {regs} registers, spill stores {st} "
                f"B, spill loads {ld} B, {smem} B static shared{dyn}")
            check(st == 0 and ld == 0, f"{fn} spills ({st} B, {ld} B)")
    # Both products of the bf16 kernel on the tensor cores at every padded
    # width: S = QK^T (B K-major) and O += PV (B transposed).
    hgmma = sass_forms(_build.lib_path("flash_attention"), "HGMMA")
    for hp in flash_attention.WGMMA_WIDTHS:
        ow = flash_attention.out_width(hp)
        for aligned in (1, 0):      # the 16-byte copies' and the others'
            forms = next((f for fn, f in hgmma.items()
                          if f"attn_wgmma_kernelILi{hp}ELi{ow}ELb{aligned}E"
                          in fn), {})
            log(f"[sass flash_attention] width {hp} (output {ow} a block, "
                f"aligned {aligned}): {sum(forms.values())} HGMMA "
                f"instructions: {json.dumps(forms)}")
            check(any("tnspB" in f for f in forms) and
                  any("tnspB" not in f for f in forms),
                  f"flash_attention's bf16 kernel at width {hp} (aligned "
                  f"{aligned}) runs no HGMMA for one product")
    hmma = {}
    for forms in sass_forms(_build.lib_path("mlstm_scan"), "HMMA").values():
        for f, n in forms.items():
            hmma[f] = hmma.get(f, 0) + n
    log(f"[sass mlstm_scan] {sum(hmma.values())} HMMA instructions: "
        f"{json.dumps(hmma)}")
    check(any(".TF32" in f for f in hmma),
          "mlstm_scan's prefill issues no TF32 HMMA")

    def randn(seed, shape, dtype):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(DT[dtype])

    # -- 3. kernels against their plain versions -------------------------------
    errs = {"flash_attention": {}, "flash_decode": {}, "mlstm_scan": {},
            "mlstm_scan_state": {}, "mlstm_scan_n": {},
            "flash_attention_hd128": {},
            "flash_decode_hd128": {}, "flash_attention_hd256": {},
            "flash_decode_hd256": {}, "mamba_scan": {},
            "mamba_scan_state": {}}
    # The attention shapes of the stub-mode and MoE models (phases 17-23):
    # {tag: (Hq, Hkv, hd)}, qwen2-vl g 8 and qwen3-moe g 16 at hd 128,
    # musicgen MHA at hd 64, kimi-k2 g 8 at hd 112.
    model_shapes = {name: (c.n_heads, c.n_kv_heads, c.hd) for name, c in (
        (n, get_config(n)) for n in (QWEN2VL, QWEN3MOE, MUSICGEN, KIMI))}
    for name in model_shapes:
        errs[f"flash_attention {name}"] = {}
        errs[f"flash_decode {name}"] = {}

    # The largest error over the cases past each sweep's first ones (the
    # head dims, groups, state sizes and chunks of the widened kernels) and
    # over the public models' full widths.
    wide_errs = {}

    def hold(name, got, want, dtype, what, main_shape=False, tol=None,
             wide=False):
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = TOL[dtype] if tol is None else tol
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        check(ok and got.dtype == want.dtype,
              f"{name} {what} {dtype}: max abs err {err:g} (tol {tol})")
        if main_shape:
            errs[name][dtype] = max(errs[name].get(dtype, 0.0), err)
        if wide:
            at = wide_errs.setdefault(name, {})
            at[dtype] = max(at.get(dtype, 0.0), err)
        return err

    def mlstm_inputs(seed, B, S, H, hd, dtype, k_scale=1.0):
        """q, k, v, i, f as the model makes them: gates in (0, 1), the
        forget gate biased toward remembering."""
        q = randn(seed, (B, S, H, hd), dtype)
        k = randn(seed + 1, (B, S, H, hd), "float32") * k_scale
        v = randn(seed + 2, (B, S, H, hd), dtype)
        i = torch.sigmoid(randn(seed + 3, (B, S, H), "float32"))
        f = torch.sigmoid(randn(seed + 4, (B, S, H), "float32") + 2.0)
        return (q, k.to(DT[dtype]), v, i.to(DT[dtype]), f.to(DT[dtype]))

    def hold_mlstm(inp, c0, n0, dtype, what, chunk=128, main_shape=False,
                   in_place=False, wide=False):
        """One mlstm_scan call that carries the normalizer, against
        ref.mlstm_ref: y at TOL, C and n at MLSTM_C_TOL.  ``in_place``
        passes out=c0 and n_out=n0, as the decode step does."""
        want_y, want_c, want_n = ref.mlstm_ref(*inp, c0, n0)
        c_in, n_in = (c0.clone(), n0.clone()) if in_place else (c0, n0)
        y, c_last, n_last = ops.mlstm(
            *inp, c_in, n0=n_in, chunk=chunk, out=c_in if in_place else None,
            n_out=n_in if in_place else None)
        check((c_last is c_in and n_last is n_in) or not in_place,
              "mlstm_scan out= and n_out= are the returned states")
        hold("mlstm_scan", y, want_y.to(y.dtype), dtype, what, main_shape,
             wide=wide)
        hold("mlstm_scan_state", c_last, want_c, dtype, what, main_shape,
             tol=MLSTM_C_TOL[dtype], wide=wide)
        hold("mlstm_scan_n", n_last, want_n, dtype, what, main_shape,
             tol=MLSTM_C_TOL[dtype], wide=wide)
        return y, c_last

    def mamba_inputs(seed, B, S, di, N, dtype, h0_scale=0.0):
        """u, dt, a, b, c, h0 as the repo's kernel tests make them: dt a
        softplus, a = -exp(0.5 normal), the state fp32."""
        u = randn(seed, (B, S, di), dtype)
        dt = F.softplus(randn(seed + 1, (B, S, di), "float32"))
        a = -torch.exp(randn(seed + 2, (di, N), "float32") * 0.5)
        b = randn(seed + 3, (B, S, N), dtype)
        c = randn(seed + 4, (B, S, N), dtype)
        h0 = randn(seed + 5, (B, di, N), "float32") * h0_scale
        return u, dt.to(DT[dtype]), a, b, c, h0

    def hold_mamba(inp, dtype, what, main_shape=False, in_place=False,
                   wide=False):
        """One mamba_scan call against ref.mamba_scan_ref: y at TOL, the
        state at MAMBA_H_TOL.  ``in_place`` passes out=h0, as the decode
        step does."""
        want_y, want_h = ref.mamba_scan_ref(*inp)
        h0 = inp[-1].clone() if in_place else inp[-1]
        y, h = ops.selective_scan(*inp[:-1], h0, out=h0 if in_place
                                  else None)
        check(h is h0 or not in_place, "mamba_scan out= is the state")
        hold("mamba_scan", y, want_y.to(y.dtype), dtype, what, main_shape,
             wide=wide)
        hold("mamba_scan_state", h, want_h, dtype, what, main_shape,
             tol=MAMBA_H_TOL, wide=wide)
        return y, h

    jcfg = get_config(JAMBA)
    JDI, JN, JHD = jcfg.ssm_expand * jcfg.d_model, jcfg.ssm_state, jcfg.hd
    g2cfg = get_config(GEMMA2)
    G_HQ, G_HKV, G_CAP = g2cfg.n_heads, g2cfg.n_kv_heads, g2cfg.attn_softcap
    n_checks = 0
    t_phase3 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        # The sweeps' cases past their first 16, 14, 3 and 3 (and the
        # public full widths) take the widened kernels' shapes: each must
        # launch its kernel once, with no copy of a padded tensor.
        for i, case in enumerate(ATTN_SWEEP + ATTN_FULL_WIDTH):
            B, Hq, Hkv, Sq, Skv, hd, causal, window, cap = case
            q = randn(1, (B, Hq, Sq, hd), dtype)
            k = randn(2, (B, Hkv, Skv, hd), dtype)
            v = randn(3, (B, Hkv, Skv, hd), dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            ops.reset_launch_counts()
            got = ops.flash_attention(q, k, v, **kw)
            check(ops.launch_counts()["flash_attention"] == 1,
                  f"flash_attention {case} launched no kernel")
            hold("flash_attention", got, ref.attention_ref(q, k, v, **kw),
                 dtype, str(case), wide=i >= 16)
            n_checks += 1
        q = randn(4, (1, 2, 16, 32), dtype)
        k = randn(5, (1, 2, 64, 32), dtype)
        v = randn(6, (1, 2, 64, 32), dtype)
        for kw in (dict(causal=True, q_offset=48),
                   dict(causal=False, q_offset=48, kv_len=40),
                   dict(causal=True, window=8, q_offset=48, kv_len=60)):
            hold("flash_attention", ops.flash_attention(q, k, v, **kw),
                 ref.attention_ref(q, k, v, **kw), dtype, str(kw))
            n_checks += 1
        # The same at head dims 256 (g = 2) and 112 (kimi-k2's g = 8), in
        # the model's layouts: 80 ragged queries at an offset, kv_len past
        # the causal limit of some rows, a window.
        for hd, hq, seed in ((256, 4, 16), (112, 16, 19)):
            q = randn(seed, (1, 80, hq, hd), dtype).transpose(1, 2)
            k = randn(seed + 1, (1, 256, 2, hd), dtype).transpose(1, 2)
            v = randn(seed + 2, (1, 256, 2, hd), dtype).transpose(1, 2)
            for kw in (dict(causal=True, q_offset=100, kv_len=170),
                       dict(causal=False, q_offset=100, kv_len=170),
                       dict(causal=True, window=40, softcap=50.0,
                            q_offset=100, kv_len=170)):
                hold("flash_attention", ops.flash_attention(q, k, v, **kw),
                     ref.attention_ref(q, k, v, **kw), dtype,
                     f"hd {hd} {kw}")
                n_checks += 1
        for i, case in enumerate(DECODE_SWEEP + DECODE_FULL_WIDTH):
            B, Hq, Hkv, T, hd, kv_len, cap = case
            q = randn(7, (B, Hq, 1, hd), dtype)
            k = randn(8, (B, Hkv, T, hd), dtype)
            v = randn(9, (B, Hkv, T, hd), dtype)
            ops.reset_launch_counts()
            got = ops.flash_decode(q, k, v, kv_len, softcap=cap)
            check(ops.launch_counts()["flash_decode"] == 1,
                  f"flash_decode {case} launched no kernel")
            hold("flash_decode", got,
                 ref.attention_ref(q, k, v, causal=False, softcap=cap,
                                   kv_len=kv_len), dtype, str(case),
                 wide=i >= 14)
            n_checks += 1
        # The serving path's shapes, in the model's layouts: (B,S,N,hd)
        # activations and a (B,T,Nkv,hd) cache seen through transposes.
        q = randn(10, (BATCH, PROMPT, 32, 64), dtype).transpose(1, 2)
        k = randn(11, (BATCH, PROMPT, 8, 64), dtype).transpose(1, 2)
        v = randn(12, (BATCH, PROMPT, 8, 64), dtype).transpose(1, 2)
        hold("flash_attention", ops.flash_attention(q, k, v, causal=True),
             ref.attention_ref(q, k, v, causal=True), dtype,
             "prefill (4,32,256,64)/(4,8,256,64)", main_shape=True)
        qd = randn(13, (BATCH, 1, 32, 64), dtype).transpose(1, 2)
        kc = randn(14, (BATCH, MAX_LEN, 8, 64), dtype).transpose(1, 2)
        vc = randn(15, (BATCH, MAX_LEN, 8, 64), dtype).transpose(1, 2)
        for kv_len in DECODE_KV_LENS:
            got = ops.flash_decode(qd, kc, vc, kv_len)
            hold("flash_decode", got,
                 ref.attention_ref(qd, kc, vc, causal=False, kv_len=kv_len),
                 dtype, f"decode (4,32,1,64)/(4,8,512,64) kv_len={kv_len}",
                 main_shape=True)
            # The merge's tickets are back at zero: a repeat is bitwise.
            check(torch.equal(ops.flash_decode(qd, kc, vc, kv_len), got),
                  f"flash_decode repeat differs at kv_len {kv_len}")
        n_checks += 1 + 2 * len(DECODE_KV_LENS)
        # mlstm_scan: the repo's sweep, a ragged second chunk at the
        # default chunk, a nonzero state carried across two calls, and the
        # serving shapes (prefill from a zero state; a decode step updating
        # a nonzero state in place).
        for i, case in enumerate(MLSTM_SWEEP + MLSTM_FULL_WIDTH):
            B, S, H, hd, chunk = case
            # The widened shapes' k as the model scales it (1/sqrt(hd)).
            k_scale = 1.0 if i < 3 else hd ** -0.5
            ops.reset_launch_counts()
            hold_mlstm(mlstm_inputs(30, B, S, H, hd, dtype, k_scale),
                       torch.zeros((B, H, hd, hd), device=dev),
                       randn(35, (B, H, hd), "float32") * 0.3, dtype,
                       str(case), chunk=chunk, wide=i >= 3)
            check(ops.launch_counts()["mlstm_scan"] == 1,
                  f"mlstm_scan {case} launched no kernel")
        inp = mlstm_inputs(40, 2, 200, 2, 64, dtype)
        c0 = randn(45, (2, 2, 64, 64), "float32") * 0.3
        y, c_last = hold_mlstm(inp, c0, randn(46, (2, 2, 64), "float32"),
                               dtype, "ragged (2,200,2,64)")
        y1, c1 = ops.mlstm(*(t[:, :77] for t in inp), c0)
        y2, c2 = ops.mlstm(*(t[:, 77:] for t in inp), c1)
        hold("mlstm_scan", torch.cat([y1, y2], dim=1), y, dtype,
             "state carried over two calls (77 + 123 rows)")
        hold("mlstm_scan_state", c2, c_last, dtype,
             "state carried over two calls", tol=MLSTM_C_TOL[dtype])
        H = get_config(XLSTM).n_heads
        hold_mlstm(mlstm_inputs(50, BATCH, PROMPT, H, MLSTM_HD, dtype,
                                k_scale=MLSTM_HD ** -0.5),
                   torch.zeros((BATCH, H, MLSTM_HD, MLSTM_HD), device=dev),
                   torch.zeros((BATCH, H, MLSTM_HD), device=dev),
                   dtype, f"prefill ({BATCH},{PROMPT},{H},{MLSTM_HD})",
                   main_shape=True)
        hold_mlstm(mlstm_inputs(60, BATCH, 1, H, MLSTM_HD, dtype,
                                k_scale=MLSTM_HD ** -0.5),
                   randn(65, (BATCH, H, MLSTM_HD, MLSTM_HD), "float32") * 0.1,
                   randn(66, (BATCH, H, MLSTM_HD), "float32") * 0.1,
                   dtype, f"decode ({BATCH},1,{H},{MLSTM_HD}) in place",
                   main_shape=True, in_place=True)
        n_checks += len(MLSTM_SWEEP) + len(MLSTM_FULL_WIDTH) + 4
        # Jamba's attention at head dim 128: the prefill, and decode steps
        # against its (4,8,512,128) cache.
        q = randn(90, (BATCH, PROMPT, 32, JHD), dtype).transpose(1, 2)
        k = randn(91, (BATCH, PROMPT, 8, JHD), dtype).transpose(1, 2)
        v = randn(92, (BATCH, PROMPT, 8, JHD), dtype).transpose(1, 2)
        hold("flash_attention_hd128", ops.flash_attention(q, k, v),
             ref.attention_ref(q, k, v), dtype,
             f"prefill (4,32,256,{JHD})/(4,8,256,{JHD})", main_shape=True)
        qd = randn(93, (BATCH, 1, 32, JHD), dtype).transpose(1, 2)
        kc = randn(94, (BATCH, MAX_LEN, 8, JHD), dtype).transpose(1, 2)
        vc = randn(95, (BATCH, MAX_LEN, 8, JHD), dtype).transpose(1, 2)
        for kv_len in DECODE_KV_LENS:
            hold("flash_decode_hd128", ops.flash_decode(qd, kc, vc, kv_len),
                 ref.attention_ref(qd, kc, vc, causal=False, kv_len=kv_len),
                 dtype, f"decode (4,32,1,{JHD})/(4,8,512,{JHD}) "
                 f"kv_len={kv_len}", main_shape=True)
        n_checks += 1 + len(DECODE_KV_LENS)
        # gemma2-2b's attention at head dim 256 as served, softcap 50: the
        # prefill (8 q heads, 4 KV heads) and decode steps against its
        # (4,4,512,256) cache.
        q = randn(180, (BATCH, PROMPT, G_HQ, 256), dtype).transpose(1, 2)
        k = randn(181, (BATCH, PROMPT, G_HKV, 256), dtype).transpose(1, 2)
        v = randn(182, (BATCH, PROMPT, G_HKV, 256), dtype).transpose(1, 2)
        hold("flash_attention_hd256",
             ops.flash_attention(q, k, v, softcap=G_CAP),
             ref.attention_ref(q, k, v, softcap=G_CAP), dtype,
             f"prefill (4,{G_HQ},256,256)/(4,{G_HKV},256,256)",
             main_shape=True)
        qd = randn(183, (BATCH, 1, G_HQ, 256), dtype).transpose(1, 2)
        kc = randn(184, (BATCH, MAX_LEN, G_HKV, 256), dtype).transpose(1, 2)
        vc = randn(185, (BATCH, MAX_LEN, G_HKV, 256), dtype).transpose(1, 2)
        for kv_len in DECODE_KV_LENS:
            hold("flash_decode_hd256",
                 ops.flash_decode(qd, kc, vc, kv_len, softcap=G_CAP),
                 ref.attention_ref(qd, kc, vc, causal=False, softcap=G_CAP,
                                   kv_len=kv_len),
                 dtype, f"decode (4,{G_HQ},1,256)/(4,{G_HKV},512,256) "
                 f"kv_len={kv_len}", main_shape=True)
        n_checks += 1 + len(DECODE_KV_LENS)
        # qwen2-vl's, qwen3-moe's, musicgen's and kimi-k2's attention as
        # served: the prefill and decode steps against a (4,Hkv,512,hd)
        # cache.
        for si, (name, (hq, hkv, hd)) in enumerate(model_shapes.items()):
            seed = 200 + 10 * si
            q = randn(seed, (BATCH, PROMPT, hq, hd), dtype).transpose(1, 2)
            k = randn(seed + 1, (BATCH, PROMPT, hkv, hd), dtype).transpose(
                1, 2)
            v = randn(seed + 2, (BATCH, PROMPT, hkv, hd), dtype).transpose(
                1, 2)
            hold(f"flash_attention {name}", ops.flash_attention(q, k, v),
                 ref.attention_ref(q, k, v), dtype,
                 f"{name} prefill (4,{hq},256,{hd})/(4,{hkv},256,{hd})",
                 main_shape=True)
            qd = randn(seed + 3, (BATCH, 1, hq, hd), dtype).transpose(1, 2)
            kc = randn(seed + 4, (BATCH, MAX_LEN, hkv, hd), dtype).transpose(
                1, 2)
            vc = randn(seed + 5, (BATCH, MAX_LEN, hkv, hd), dtype).transpose(
                1, 2)
            for kv_len in DECODE_KV_LENS:
                hold(f"flash_decode {name}",
                     ops.flash_decode(qd, kc, vc, kv_len),
                     ref.attention_ref(qd, kc, vc, causal=False,
                                       kv_len=kv_len),
                     dtype, f"{name} decode (4,{hq},1,{hd})/"
                     f"(4,{hkv},512,{hd}) kv_len={kv_len}", main_shape=True)
            n_checks += 1 + len(DECODE_KV_LENS)
        # mamba_scan: the repo's sweep from a nonzero state, the state
        # carried across two calls, and Jamba's serving shapes (the prefill
        # from a zero state; a decode step updating the state in place).
        for i, case in enumerate(MAMBA_SWEEP + MAMBA_FULL_WIDTH):
            B, S, di, N, _ = case
            ops.reset_launch_counts()
            hold_mamba(mamba_inputs(100, B, S, di, N, dtype, 0.3), dtype,
                       str(case), wide=i >= 3)
            check(ops.launch_counts()["mamba_scan"] == 1,
                  f"mamba_scan {case} launched no kernel")
        inp = mamba_inputs(110, 2, 200, 256, 16, dtype, 0.3)
        y, h = hold_mamba(inp, dtype, "ragged (2,200,256,16)")
        u, dt, a, b, c, h0 = inp
        y1, h1 = ops.selective_scan(u[:, :77], dt[:, :77], a, b[:, :77],
                                    c[:, :77], h0)
        y2, h2 = ops.selective_scan(u[:, 77:], dt[:, 77:], a, b[:, 77:],
                                    c[:, 77:], h1)
        hold("mamba_scan", torch.cat([y1, y2], dim=1), y, dtype,
             "state carried over two calls (77 + 123 rows)")
        hold("mamba_scan_state", h2, h, dtype,
             "state carried over two calls", tol=MAMBA_H_TOL)
        hold_mamba(mamba_inputs(120, BATCH, PROMPT, JDI, JN, dtype), dtype,
                   f"prefill ({BATCH},{PROMPT},{JDI},{JN})", main_shape=True)
        hold_mamba(mamba_inputs(130, BATCH, 1, JDI, JN, dtype, 0.5), dtype,
                   f"decode ({BATCH},1,{JDI},{JN}) in place",
                   main_shape=True, in_place=True)
        n_checks += len(MAMBA_SWEEP) + len(MAMBA_FULL_WIDTH) + 4
    log(f"[kernels] {n_checks} comparisons with the plain version passed; "
        f"main-shape max abs err {json.dumps(errs)}")
    log(f"[kernels] the widened shapes' max abs err {json.dumps(wide_errs)}; "
        f"phase 3 {time.perf_counter() - t_phase3:.1f} s")

    # -- 4. full-width llama3.2-1b, fp32: kernel path vs plain path -----------
    def rel_err(a, b):
        return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)

    def fp32_parity(name, model, batch):
        """Prefill of ``batch`` and FP32_DECODE_STEPS greedy decode steps
        (``step_batch``) on the kernel path and on the plain path: logits
        within MODEL_TOL, the same greedy tokens except at near-ties.  For
        an MoE model, the expert choices that differ between the two paths
        are counted and printed first."""
        with recorded_routes(model) as routes:
            try:
                free_running(name, model, batch)
            finally:
                n, total = routes.differ()
                if total:
                    log(f"[fp32] {name} expert choices that differ between "
                        f"the paths: {n} of {total} (token, router call)")

    def free_running(name, model, batch):
        cfg = model.cfg

        def both_paths(fn):
            model.plain_kernels = False
            got = fn()
            model.plain_kernels = True
            want = fn()
            model.plain_kernels = False
            return got, want

        B = next(iter(batch.values())).shape[0]
        S = sum(v.shape[1] for v in batch.values())       # patches + text
        max_len = max(MAX_LEN, S + FP32_DECODE_STEPS)
        (lk, ck, _), (lp, cp, _) = both_paths(
            lambda: model.prefill(batch, max_len))
        e = max_err(lk, lp)
        check(bool(torch.isfinite(lk).all()) and lk.shape == (
            B, 1, cfg.padded_vocab), "fp32 prefill logits finite, shaped")
        check(e <= MODEL_TOL, f"fp32 prefill logits err {e:g} > {MODEL_TOL}")
        fp32_errs = [e]
        tok = lk[:, -1, :cfg.vocab_size].argmax(-1)
        ties = 0
        for t in range(FP32_DECODE_STEPS):
            step = step_batch(cfg, tok, t, STUB_SEED)
            model.plain_kernels = False
            lk, ck = model.decode_step(step, ck, S + t)
            model.plain_kernels = True
            lp, cp = model.decode_step(step, cp, S + t)
            model.plain_kernels = False
            e = max_err(lk, lp)
            fp32_errs.append(e)
            check(e <= MODEL_TOL, f"fp32 decode step {t} logits err {e:g}")
            check(bool(torch.isfinite(lk).all()), "fp32 decode logits finite")
            tk = lk[:, -1, :cfg.vocab_size].argmax(-1)
            tp = lp[:, -1, :cfg.vocab_size].argmax(-1)
            for r in (tk != tp).nonzero().flatten().tolist():
                # A different greedy token is allowed only at a near-tie.
                gap = abs(float(lp[r, -1, tk[r]] - lp[r, -1, tp[r]]))
                check(gap <= 2 * MODEL_TOL,
                      f"greedy token differs at step {t} row {r}, "
                      f"plain-path logit gap {gap:g}")
                ties += 1
            tok = tk
        keys = " + ".join(f"{k} {tuple(v.shape[1:])}"
                          for k, v in batch.items())
        log(f"[fp32] {name} kernel vs plain path, {B} x ({keys}): prefill "
            f"+ {FP32_DECODE_STEPS} decode logits max abs err "
            f"{max(fp32_errs):g} (tol {MODEL_TOL}), relative "
            f"{rel_err(lk, lp):g}; greedy tokens equal ({ties} near-ties)")

    def free_memory():
        gc.collect()
        torch.cuda.empty_cache()

    def fp32_phase(cfg, layerwise=False, free=True, shape=(BATCH, PROMPT),
                   seed=1):
        """The fp32 model of ``cfg``: ``layer_parity`` if ``layerwise``,
        then ``fp32_parity`` if ``free``, on a ``prompt_batch`` of
        ``shape`` drawn from ``seed``; the model is freed after."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, 0, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[fp32] {cfg.name}: {cfg.n_layers} layers, {n_params} "
            f"parameters, init {time.perf_counter() - t0:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        batch = prompt_batch(cfg, *shape, dev, seed)
        t0 = time.perf_counter()
        if layerwise:
            layer_parity(cfg.name, model, batch["tokens"])
        if free:
            fp32_parity(cfg.name, model, batch)
        torch.cuda.synchronize()
        log(f"[fp32] {cfg.name}: parity {time.perf_counter() - t0:.1f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model
        free_memory()
        return batch

    cfg = get_config(ARCH)
    prompts = fp32_phase(cfg)

    # -- 5. serve llama3.2-1b in bf16 through the kernels ----------------------
    def bf16_logits_parity(model, batch, lk):
        """The bf16 kernel path's prefill logits ``lk`` against the plain
        path's, within BF16_MODEL_TOL."""
        model.plain_kernels = True
        lp, _, _ = model.prefill(batch, MAX_LEN)
        model.plain_kernels = False
        err = max_err(lk, lp)
        check(err <= BF16_MODEL_TOL,
              f"bf16 prefill logits err {err:g} > {BF16_MODEL_TOL}")
        return {"bf16_prefill_logit_err_vs_plain": err}

    def profiled_wave(wave):
        """One more wave under torch.profiler: its wall ms, the device-busy
        ms (``launch.profile._busy_ms``: the union of the device activities'
        intervals), the idle share and the device ms by activity name."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.profile import _busy_ms
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wave()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _busy_ms(acts)
        by_name = {}
        for e in acts:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        return {"profiled_wave_ms": wall_ms, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall_ms,
                "device_activities": len(acts),
                "top_device_ms": [[n[:80], ms] for n, ms in top]}

    served = {}     # each served path's numbers, by config name

    def serve_phase(cfg, batch, want_launches, parity, profile=False):
        """One counted wave of ``serve_wave`` over the prompt ``batch``
        (launch counters from 0), then the median of three more waves and
        of three prefills alone; then ``parity(model, batch,
        prefill_logits)`` holds the bf16 kernel path against the plain path
        and returns its errors; with ``profile``, ``profiled_wave``."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, 0, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        scfg = ServeConfig(max_new_tokens=NEW, max_len=MAX_LEN)

        def wave(b=batch, s=scfg):
            return serve_wave(cfg, model, b, s, dev, STUB_SEED)

        wave({k: v[:, :v.shape[1] // 4] for k, v in batch.items()},
             dataclasses.replace(scfg, max_new_tokens=4))     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = wave()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(out.shape == (BATCH, NEW) and out.min() >= 0
              and out.max() < cfg.vocab_size, f"served tokens {out.shape}")
        check(launches == want_launches,
              f"launches {launches}, expected {want_launches}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # Host-clock times vary from wave to wave: take the median of three
        # more waves, and of three prefills alone.
        walls, prefills = [], []
        for _ in range(3):
            t1 = time.perf_counter()
            wave()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            lk, _, _ = model.prefill(batch, MAX_LEN)
            torch.cuda.synchronize()
            prefills.append((time.perf_counter() - t1) * 1e3)
        wall_ms, prefill_ms = sorted(walls)[1], sorted(prefills)[1]
        check(bool(torch.isfinite(lk).all()), "bf16 prefill logits finite")
        check(int(out[0, 0]) == int(lk[0, -1, :cfg.vocab_size].argmax()),
              "first served token is the prefill's argmax")
        errors = parity(model, batch, lk)
        decode_ms = (wall_ms - prefill_ms) / (NEW - 1)
        floor_ms, w_bytes, c_bytes = decode_floor(cfg, BATCH,
                                                  PROMPT + NEW // 2)
        serve = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "input_mode": cfg.input_mode, "requests": BATCH,
                 "prompt": PROMPT, "new_tokens": NEW, "max_len": MAX_LEN,
                 "dtype": "bfloat16",
                 "counted_wave_ms": wall * 1e3, "wave_ms": walls,
                 "wall_ms": wall_ms, "prefill_ms": prefill_ms,
                 "decode_ms_per_token": decode_ms,
                 "decode_floor_ms": floor_ms,
                 "decode_floor_weights_gb": w_bytes / 1e9,
                 "decode_floor_cache_gb": c_bytes / 1e9,
                 "tokens_per_s": BATCH * NEW / wall_ms * 1e3,
                 "peak_gb": peak_gb, "init_s": init_s,
                 "init_peak_gb": init_peak_gb, "launches": launches,
                 **errors}
        if profile:
            serve.update(profiled_wave(wave))
        log(f"[serve] {json.dumps(serve)}")
        served[cfg.name] = serve
        return model, launches

    model, serve_launches = serve_phase(cfg, prompts, wave_launches(cfg),
                                        bf16_logits_parity)

    # -- 6. continuous batching on KernelDecode --------------------------------
    sessions, steps = 16, 8
    decode = KernelDecode(slots=sessions, q_heads=cfg.n_heads,
                          kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          max_len=MAX_LEN, dtype=torch.bfloat16, device=dev)
    batcher = ContinuousBatcher(decode, AdmissionConfig(
        max_batch=8, window_ms=5.0, queue_depth=64))
    ops.reset_launch_counts()
    batcher.start()
    try:
        for t in range(steps):
            reqs = [StepRequest(f"s{i}", t) for i in range(sessions)]
            for r in reqs:
                check(batcher.submit(r), "batcher admitted the request")
            for r in reqs:
                check(r.done.wait(timeout=60.0), "request completed")
    finally:
        batcher.stop()
    batch_launches = ops.launch_counts()
    check(batcher.last_error is None, f"decode raised {batcher.last_error!r}")
    check(batcher.decoded == batcher.submitted == sessions * steps
          and batcher.dropped == 0,
          f"batcher decoded {batcher.decoded} of {batcher.submitted}, "
          f"dropped {batcher.dropped}")
    check(batch_launches["flash_decode"] == batcher.batches > 0,
          f"batcher launches {batch_launches}, batches {batcher.batches}")
    log(f"[batcher] {sessions} sessions x {steps} steps: decoded "
        f"{batcher.decoded}, dropped {batcher.dropped}, batches "
        f"{batcher.batches}, mean batch {batcher.mean_batch:.2f}, launches "
        f"{batch_launches}")
    del decode
    del model
    torch.cuda.empty_cache()

    # -- 7./8. xlstm-125m: fp32 parity, then served in bf16 --------------------
    # Its free-running paths part by more than rounding (see layer_parity;
    # measured by ``python -m repro_torch.launch.xlstm_probe``), so the
    # kernel is held inside the model layer by layer, in fp32 and in bf16.
    xcfg = get_config(XLSTM)
    xprompts = fp32_phase(xcfg, layerwise=True, free=False)
    model, xlstm_launches = serve_phase(
        xcfg, xprompts, wave_launches(xcfg),
        lambda model, batch, _: {"bf16_layer_parity": layer_parity(
            XLSTM, model, batch["tokens"], tol=TOL["bfloat16"])})
    del model
    torch.cuda.empty_cache()

    # -- 9./10. jamba-v0.1-52b: fp32 parity, then served in bf16 --------------
    # The depth is cut to whole periods so the weights fit the card (see
    # JAMBA_*_LAYERS); every width is the published one.
    t_jamba = time.perf_counter()
    jcfg1 = dataclasses.replace(jcfg, n_layers=JAMBA_FP32_LAYERS)
    log(f"[jamba] depth cut: {jcfg.n_layers} -> {JAMBA_FP32_LAYERS} layers "
        f"in fp32, {JAMBA_SERVE_LAYERS} in bf16; widths as published "
        f"(d_model {jcfg.d_model}, {jcfg.n_experts} experts of d_ff "
        f"{jcfg.expert_d_ff}, di {JDI}, N {JN}, head dim {JHD})")
    jprompts = fp32_phase(jcfg1, layerwise=True, free=True)
    jcfg2 = dataclasses.replace(jcfg, n_layers=JAMBA_SERVE_LAYERS)
    model, jamba_launches = serve_phase(
        jcfg2, jprompts, wave_launches(jcfg2),
        lambda model, batch, _: {"bf16_layer_parity": layer_parity(
            JAMBA, model, batch["tokens"], tol=TOL["bfloat16"])})
    log(f"[jamba] {expert_floors_text(jcfg2)}; Jamba phases "
        f"{time.perf_counter() - t_jamba:.1f} s")
    del model
    torch.cuda.empty_cache()

    # -- 11. train llama3.2-1b at full width ----------------------------------
    train_out, train_launches = train_phase(torch, dev)
    # -- 11b. the int8-compressed step beside the plain one; the host mesh ---
    _, compress_launches = compress_phase(torch, dev, card)
    host_mesh_phase(torch, dev)
    # -- 11c. llama3.2-1b on DTensor parameters over the (1, 1) mesh --------
    _, sharded_launches = sharded_step_phase(torch, dev, compress=True)
    # -- 11d. qwen3-moe-235b-a22b on DTensor parameters, the same mesh -----
    _, moe_sharded_launches = moe_sharded_step_phase(torch, dev)
    # -- 11e. jamba-v0.1-52b and xlstm-125m on DTensor parameters ---------
    t_11e = time.perf_counter()
    (_, jamba_sharded_launches), (_, xlstm_sharded_launches) = \
        recurrent_sharded_step_phase(torch, dev)
    log(f"[sharded] phase 11e {time.perf_counter() - t_11e:.1f} s")

    # -- 12. kernel times at the serving shapes -------------------------------
    # Timed with a cold L2, as the layers between two kernel calls leave it
    # (``cold_device_ms``).
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def cold_ms(fn, iters=30, warmup=3):
        return cold_device_ms(torch, flush, fn, iters, warmup)

    kv_len = PROMPT + NEW // 2      # the middle of the served decode run
    # What the same method reads for one trivial kernel: the launch and
    # event overhead under every time below.
    one = torch.zeros(1, device=dev)
    floor_ms = cold_ms(lambda: one.add_(1))
    log(f"[timing] one-element add_ by the same method: {floor_ms:.5f} ms")

    def attention_times(hd, seed, hq=32, hkv=8):
        """flash_attention (prefill) and flash_decode (one step at kv_len)
        at the serving shapes with head dim ``hd`` and ``hq`` / ``hkv``
        heads, bf16: device ms of the kernel, of the plain version and of
        SDPA, and the bounds."""
        dtype, g = "bfloat16", hq // hkv
        q = randn(seed, (BATCH, PROMPT, hq, hd), dtype).transpose(1, 2)
        k = randn(seed + 1, (BATCH, PROMPT, hkv, hd), dtype).transpose(1, 2)
        v = randn(seed + 2, (BATCH, PROMPT, hkv, hd), dtype).transpose(1, 2)
        ke, ve = (t.repeat_interleave(g, dim=1).contiguous() for t in (k, v))
        qc = q.contiguous()
        fa = {
            "ms": cold_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            "plain_ms": cold_ms(lambda: ref.attention_ref(q, k, v,
                                                          causal=True)),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                qc, ke, ve, is_causal=True)),
            "bound": attention_bound(BATCH, hq, hkv, PROMPT, PROMPT, hd,
                                     causal=True),
            "shape": f"q (4,{hq},256,{hd}) k,v (4,{hkv},256,{hd}) bf16 "
                     f"causal",
        }
        qd = randn(seed + 3, (BATCH, 1, hq, hd), dtype).transpose(1, 2)
        kc = randn(seed + 4, (BATCH, MAX_LEN, hkv, hd), dtype).transpose(1, 2)
        vc = randn(seed + 5, (BATCH, MAX_LEN, hkv, hd), dtype).transpose(1, 2)
        kl, vl = (t[:, :, :kv_len].repeat_interleave(g, dim=1).contiguous()
                  for t in (kc, vc))
        qdc = qd.contiguous()
        fd = {
            "ms": cold_ms(lambda: ops.flash_decode(qd, kc, vc, kv_len)),
            "plain_ms": cold_ms(lambda: ref.attention_ref(
                qd, kc, vc, causal=False, kv_len=kv_len)),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                qdc, kl, vl)),
            "bound": attention_bound(BATCH, hq, hkv, 1, MAX_LEN, hd,
                                     causal=False, kv_len=kv_len),
            "shape": f"q (4,{hq},1,{hd}) cache (4,{hkv},512,{hd}) bf16 "
                     f"kv_len {kv_len}",
        }
        return {"flash_attention": fa, "flash_decode": fd}

    # Each path's counted run (counters set to 0 just before it): the
    # served waves, and the training runs, which launch none.  gemma2-2b's
    # wave (phase 14) joins after it has run; "launches" and
    # "launches_by_path" are filled in then.
    by_path = {ARCH: serve_launches, f"{ARCH} train": train_launches,
               f"{ARCH} train compressed": compress_launches,
               f"{ARCH} sharded": sharded_launches,
               f"{QWEN3MOE} sharded": moe_sharded_launches,
               f"{JAMBA} sharded": jamba_sharded_launches,
               f"{XLSTM} sharded": xlstm_sharded_launches,
               XLSTM: xlstm_launches,
               jcfg2.name: jamba_launches}

    def device_kernels(fn, spin=True):
        """Names of the device activities (kernels, memsets, copies) of one
        call of ``fn``, after a warm-up call, from torch.profiler.  With
        ``spin`` the traced window opens with a spin kernel, finished before
        the call, and only the activities after it are the call's: one
        trace (torch 2.11 with CUDA 12.8) reported one of an ``mlstm_scan``
        prefill's two kernels, and a lost first activity of the window is
        the guess that the spin guards against (``trace_loss_probe``)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if spin:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        acts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = [e.time_range.end for e in acts if "spin_kernel" in e.name]
        after = max(spins, default=float("-inf"))
        return [e.name for e in acts if "spin_kernel" not in e.name
                and e.time_range.start >= after]

    def profiled_ms(fn, names, calls=20):
        """Mean device ms of one call of ``fn`` by torch.profiler: the
        summed durations of the activities ``names`` (one call's, from
        ``device_kernels``), each call after a cold-L2 flush."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name in names)
        return us / calls / 1e3

    def trace_loss_probe(fn, want_kernels, what, traces=10):
        """How often one traced call of ``fn`` reports fewer than
        ``want_kernels`` device activities, over ``traces`` traces without
        the spin kernel and ``traces`` with it (logged, not checked)."""
        short = {spin: sum(len(device_kernels(fn, spin)) < want_kernels
                           for _ in range(traces))
                 for spin in (False, True)}
        log(f"[profile] {what}: traces short of {want_kernels} activities: "
            f"{short[False]} of {traces} without the spin kernel, "
            f"{short[True]} of {traces} with it")

    def scan_call(fn, want_kernels, what):
        """Event ms, profiler ms and device kernels of one scan call; the
        call must run ``want_kernels`` device kernels."""
        names = device_kernels(fn)
        log(f"[profile] one {what} call: device activities {names}")
        check(len(names) == want_kernels,
              f"{what} ran {len(names)} device activities in one call, not "
              f"{want_kernels}: {names}")
        return cold_ms(fn), profiled_ms(fn, set(names)), len(names)

    qp = randn(170, (BATCH, PROMPT, 32, JHD), "bfloat16").transpose(1, 2)
    kp = randn(171, (BATCH, PROMPT, 8, JHD), "bfloat16").transpose(1, 2)
    qd = randn(172, (BATCH, 1, 32, JHD), "bfloat16").transpose(1, 2)
    kc = randn(173, (BATCH, MAX_LEN, 8, JHD), "bfloat16").transpose(1, 2)
    for name, fn in (
            ("flash_attention", lambda: ops.flash_attention(qp, kp, kp)),
            ("flash_decode", lambda: ops.flash_decode(qd, kc, kc, kv_len))):
        names = device_kernels(fn)
        log(f"[profile] one {name} call: device activities {names}")
        check(len(names) == 1, f"{name} ran {len(names)} device activities "
                               f"in one call, not 1: {names}")
    del qp, kp, qd, kc

    llama_t, jamba_t = attention_times(64, 20), attention_times(JHD, 140)
    gemma_t = attention_times(256, 190, G_HQ, G_HKV)
    model_t = {}
    for si, (name, (hq, hkv, hd)) in enumerate(model_shapes.items()):
        model_t[name] = attention_times(hd, 260 + 10 * si, hq, hkv)
        for kname, t in model_t[name].items():
            log(f"[timing] {kname} {name}, {t['shape']}: {t['ms']:.5f} ms, "
                f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}), plain "
                f"{t['plain_ms']:.5f} ms, SDPA {t['library_ms']:.5f} ms")
    kernels = []
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:85"),
            ("flash_decode", "src/repro/kernels/decode_attention.py:66")):
        t, tj, tg = llama_t[name], jamba_t[name], gemma_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "max_abs_err": errs[name]["bfloat16"],
            "max_abs_err_fp32": errs[name]["float32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "shape": t["shape"], "bytes": t["bound"][2],
            "flops": t["bound"][3],
            "hd128_ms": tj["ms"], "hd128_plain_ms": tj["plain_ms"],
            "hd128_bound_ms": tj["bound"][0],
            "hd128_bound_by": tj["bound"][1],
            "hd128_library_ms": tj["library_ms"],
            "hd128_shape": tj["shape"], "hd128_bytes": tj["bound"][2],
            "hd128_flops": tj["bound"][3],
            "hd128_max_abs_err": errs[f"{name}_hd128"]["bfloat16"],
            "hd128_max_abs_err_fp32": errs[f"{name}_hd128"]["float32"],
            "hd256_ms": tg["ms"], "hd256_plain_ms": tg["plain_ms"],
            "hd256_bound_ms": tg["bound"][0],
            "hd256_bound_by": tg["bound"][1],
            "hd256_library_ms": tg["library_ms"],
            "hd256_shape": tg["shape"], "hd256_bytes": tg["bound"][2],
            "hd256_flops": tg["bound"][3],
            "hd256_max_abs_err": errs[f"{name}_hd256"]["bfloat16"],
            "hd256_max_abs_err_fp32": errs[f"{name}_hd256"]["float32"],
            # The stub-mode and MoE models' shapes, keyed by model.
            **{f"{arch}_{key}": value for arch, ts in model_t.items()
               for key, value in (
                   ("ms", ts[name]["ms"]),
                   ("plain_ms", ts[name]["plain_ms"]),
                   ("bound_ms", ts[name]["bound"][0]),
                   ("bound_by", ts[name]["bound"][1]),
                   ("library_ms", ts[name]["library_ms"]),
                   ("shape", ts[name]["shape"]),
                   ("bytes", ts[name]["bound"][2]),
                   ("flops", ts[name]["bound"][3]),
                   ("max_abs_err", errs[f"{name} {arch}"]["bfloat16"]),
                   ("max_abs_err_fp32", errs[f"{name} {arch}"]["float32"]))},
            "bound_formula": "max(bytes / 3.35e12 B/s, flops / 989e12 "
                             "FLOP/s); bytes = inputs read once (keys up "
                             "to kv_len) + output; flops = 4*hd per visible "
                             "(query, key) pair",
        })
    # mlstm_scan at the served shapes and dtype: mlstm_apply casts q, k, v
    # and the gates to fp32, so the kernel runs on fp32 inputs and carries
    # the normalizer; the prefill starts from a zero state (score kernel +
    # scan kernel), a decode step updates C and n in place (step kernel).
    H, hd = xcfg.n_heads, MLSTM_HD
    pre = mlstm_inputs(70, BATCH, PROMPT, H, hd, "float32", hd ** -0.5)
    c_pre = torch.zeros((BATCH, H, hd, hd), device=dev)
    n_pre = torch.zeros((BATCH, H, hd), device=dev)
    step = mlstm_inputs(80, BATCH, 1, H, hd, "float32", hd ** -0.5)
    c_step = randn(85, (BATCH, H, hd, hd), "float32") * 0.1
    n_step = randn(86, (BATCH, H, hd), "float32") * 0.1
    ml_pre = mlstm_bound(BATCH, PROMPT, H, hd)
    ml_step = mlstm_bound(BATCH, 1, H, hd)
    trace_loss_probe(lambda: ops.mlstm(*pre, c_pre, n0=n_pre), 2,
                     "mlstm_scan prefill")
    pre_ms, pre_prof, pre_k = scan_call(
        lambda: ops.mlstm(*pre, c_pre, n0=n_pre), 2, "mlstm_scan prefill")
    step_ms, step_prof, step_k = scan_call(
        lambda: ops.mlstm(*step, c_step, n0=n_step, out=c_step,
                          n_out=n_step), 1, "mlstm_scan decode")
    now_ms = {"mlstm_scan": {"prefill": pre_ms, "decode": step_ms}}
    kernels.append({
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:73",
        "max_abs_err": errs["mlstm_scan"]["bfloat16"],
        "max_abs_err_fp32": errs["mlstm_scan"]["float32"],
        "max_abs_err_state": errs["mlstm_scan_state"]["bfloat16"],
        "max_abs_err_state_fp32": errs["mlstm_scan_state"]["float32"],
        "max_abs_err_n": errs["mlstm_scan_n"]["bfloat16"],
        "max_abs_err_n_fp32": errs["mlstm_scan_n"]["float32"],
        "ms": pre_ms, "profiled_ms": pre_prof, "device_kernels": pre_k,
        "plain_ms": cold_ms(lambda: ref.mlstm_ref(*pre, c_pre, n_pre),
                            iters=5, warmup=1),
        "bound_ms": ml_pre[0], "bound_by": ml_pre[1],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunkwise "
                        "mLSTM",
        "shape": f"prefill q,k,v ({BATCH},{PROMPT},{H},{hd}) fp32 chunk "
                 f"128, zero c0 and n0",
        "bytes": ml_pre[2], "flops": ml_pre[3],
        "decode_ms": step_ms, "decode_profiled_ms": step_prof,
        "decode_device_kernels": step_k,
        "decode_plain_ms": cold_ms(lambda: ref.mlstm_ref(*step, c_step,
                                                         n_step)),
        "decode_bound_ms": ml_step[0], "decode_bound_by": ml_step[1],
        "decode_shape": f"decode q,k,v ({BATCH},1,{H},{hd}) fp32, C and n "
                        f"updated in place",
        "decode_bytes": ml_step[2], "decode_flops": ml_step[3],
        "timing_floor_ms": floor_ms,
        "bound_formula": "max(bytes / 3.35e12 B/s, flops / (495e12 / 3) "
                         "FLOP/s, 3xTF32); bytes = q,k,v,i,f,c0 read once "
                         "+ y, c_last written; flops = 4*B*S*H*hd^2 (the "
                         "recurrence: k v^T into C and q C per token)",
    })
    # mamba_scan at the served shapes and dtype: mamba_apply casts u, dt, b
    # and c to fp32; the prefill starts from a zero state, a decode step
    # updates the cache in place.
    pre = mamba_inputs(150, BATCH, PROMPT, JDI, JN, "float32")
    step = mamba_inputs(160, BATCH, 1, JDI, JN, "float32", 0.5)
    mb_pre = mamba_bound(BATCH, PROMPT, JDI, JN)
    mb_step = mamba_bound(BATCH, 1, JDI, JN)
    pre_ms, pre_prof, _ = scan_call(lambda: ops.selective_scan(*pre), 1,
                                    "mamba_scan prefill")
    step_ms, step_prof, _ = scan_call(
        lambda: ops.selective_scan(*step, out=step[-1]), 1,
        "mamba_scan decode")
    now_ms["mamba_scan"] = {"prefill": pre_ms, "decode": step_ms}
    kernels.append({
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:55",
        "max_abs_err": errs["mamba_scan"]["bfloat16"],
        "max_abs_err_fp32": errs["mamba_scan"]["float32"],
        "max_abs_err_state": errs["mamba_scan_state"]["bfloat16"],
        "max_abs_err_state_fp32": errs["mamba_scan_state"]["float32"],
        "ms": pre_ms, "profiled_ms": pre_prof,
        "plain_ms": cold_ms(lambda: ref.mamba_scan_ref(*pre), iters=5,
                            warmup=1),
        # The special-function units' exps are operations at their own
        # peak rate: the line names the term in "bound_term".
        "bound_ms": mb_pre[0],
        "bound_by": "bytes" if mb_pre[1] == "bytes" else "operations",
        "bound_term": mb_pre[1],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a selective scan",
        "shape": f"prefill u,dt ({BATCH},{PROMPT},{JDI}) N {JN} fp32, zero "
                 f"h0",
        "bytes": mb_pre[2], "flops": mb_pre[3],
        "decode_ms": step_ms, "decode_profiled_ms": step_prof,
        "decode_plain_ms": cold_ms(lambda: ref.mamba_scan_ref(*step)),
        "decode_bound_ms": mb_step[0], "decode_bound_by": mb_step[1],
        "decode_shape": f"decode u,dt ({BATCH},1,{JDI}) N {JN} fp32, state "
                        f"updated in place",
        "decode_bytes": mb_step[2], "decode_flops": mb_step[3],
        "timing_floor_ms": floor_ms,
        "bound_formula": "max(bytes / 3.35e12 B/s, flops / 67e12 FLOP/s "
                         "fp32, exps / (132*16*1.98e9 /s) special-function "
                         "units); bytes = u,dt,b,c,a,h0 read once + y, "
                         "h_last written; flops = 8*B*S*di*N (the "
                         "recurrence); exps = B*S*di*N",
    })
    # The old shapes' times beside the recorded ones.
    for name in ("flash_attention", "flash_decode"):
        now_ms[name] = {"hd64": llama_t[name]["ms"],
                        "hd128": jamba_t[name]["ms"],
                        "hd256": gemma_t[name]["ms"],
                        **{arch: ts[name]["ms"]
                           for arch, ts in model_t.items()}}
    moved = []
    for name, shapes in RECORDED_MS.items():
        for shape, was in shapes.items():
            ratio = now_ms[name][shape] / was
            if abs(ratio - 1) > 0.05:
                moved.append(f"{name} {shape}")
            log(f"[timing] {name} {shape}: {now_ms[name][shape]:.5f} ms, "
                f"recorded {was:.5f} ms, ratio {ratio:.3f}"
                f"{' (moved past 5%)' if abs(ratio - 1) > 0.05 else ''}")
    log(f"[timing] moved past 5% of the recorded times: {moved or 'none'}")

    # The public models' full widths that only the widened kernels take
    # (phase 3 holds them against the plain version): device ms beside the
    # plain version, SDPA where one call computes the same attention, and
    # the bound.
    def wide_entry(fn, plain, bound, library=None, shape=""):
        return {"ms": cold_ms(fn),
                "plain_ms": cold_ms(plain, iters=3, warmup=1),
                "library_ms": None if library is None else cold_ms(library),
                "bound_ms": bound[0], "bound_by": bound[1], "shape": shape}

    wide = {}
    q, k, v = (randn(300 + i, (1, 2048, 32, 96), "bfloat16").transpose(1, 2)
               for i in range(3))
    qc, kc_, vc_ = (t.contiguous() for t in (q, k, v))
    wide["flash_attention"] = {"phi3-mini": wide_entry(
        lambda: ops.flash_attention(q, k, v),
        lambda: ref.attention_ref(q, k, v),
        attention_bound(1, 32, 32, 2048, 2048, 96, causal=True),
        lambda: F.scaled_dot_product_attention(qc, kc_, vc_, is_causal=True),
        "q,k,v (1,32,2048,96) bf16 causal")}
    del q, k, v, qc, kc_, vc_
    wide["flash_decode"] = {}
    for tag, (hq, hd, T, n) in (("starcoder", (48, 128, 8192, 8000)),
                                ("falcon-7b", (71, 64, 2048, 2000))):
        qd = randn(310, (BATCH, 1, hq, hd), "bfloat16").transpose(1, 2)
        kc, vc = (randn(311 + i, (BATCH, T, 1, hd), "bfloat16").transpose(
            1, 2) for i in range(2))
        ke, ve = (t[:, :, :n].expand(-1, hq, -1, -1).contiguous()
                  for t in (kc, vc))
        qdc = qd.contiguous()
        wide["flash_decode"][tag] = wide_entry(
            lambda: ops.flash_decode(qd, kc, vc, n),
            lambda: ref.attention_ref(qd, kc, vc, causal=False, kv_len=n),
            attention_bound(BATCH, hq, 1, 1, T, hd, causal=False, kv_len=n),
            lambda: F.scaled_dot_product_attention(qdc, ke, ve),
            f"q ({BATCH},{hq},1,{hd}) cache ({BATCH},1,{T},{hd}) bf16 "
            f"kv_len {n}")
        del qd, kc, vc, ke, ve, qdc
    pre = mamba_inputs(320, BATCH, PROMPT, 5120, 128, "float32")
    step = mamba_inputs(330, BATCH, 1, 5120, 128, "float32", 0.5)
    wide["mamba_scan"] = {
        "mamba2-2.7b": wide_entry(
            lambda: ops.selective_scan(*pre), lambda: ref.mamba_scan_ref(*pre),
            mamba_bound(BATCH, PROMPT, 5120, 128),
            shape=f"prefill u,dt ({BATCH},{PROMPT},5120) N 128 fp32"),
        "mamba2-2.7b_decode": wide_entry(
            lambda: ops.selective_scan(*step, out=step[-1]),
            lambda: ref.mamba_scan_ref(*step),
            mamba_bound(BATCH, 1, 5120, 128),
            shape=f"decode u,dt ({BATCH},1,5120) N 128 fp32, in place")}
    pre = mlstm_inputs(340, 1, 2048, 8, 512, "float32", 512 ** -0.5)
    c_pre, n_pre = (torch.zeros(s, device=dev)
                    for s in ((1, 8, 512, 512), (1, 8, 512)))
    step = mlstm_inputs(350, 1, 1, 8, 512, "float32", 512 ** -0.5)
    c_step = randn(355, (1, 8, 512, 512), "float32") * 0.1
    n_step = randn(356, (1, 8, 512), "float32") * 0.1
    wide["mlstm_scan"] = {
        "xlstm-7b": wide_entry(
            lambda: ops.mlstm(*pre, c_pre, n0=n_pre),
            lambda: ref.mlstm_ref(*pre, c_pre, n_pre),
            mlstm_bound(1, 2048, 8, 512),
            shape="prefill q,k,v (1,2048,8,512) fp32 chunk 128"),
        "xlstm-7b_decode": wide_entry(
            lambda: ops.mlstm(*step, c_step, n0=n_step, out=c_step,
                              n_out=n_step),
            lambda: ref.mlstm_ref(*step, c_step, n_step),
            mlstm_bound(1, 1, 8, 512),
            shape="decode q,k,v (1,1,8,512) fp32, in place")}
    del pre, step, c_pre, n_pre, c_step, n_step
    for entry in kernels:
        name = entry["name"]
        entry["wide_max_abs_err"] = wide_errs[name]["bfloat16"]
        entry["wide_max_abs_err_fp32"] = wide_errs[name]["float32"]
        entry["recorded_ms"] = RECORDED_MS[name]
        entry["recorded_ratio"] = {k: now_ms[name][k] / v
                                   for k, v in RECORDED_MS[name].items()}
        for tag, t in wide[name].items():
            sdpa = t["library_ms"]
            log(f"[timing] {name} {tag}, {t['shape']}: {t['ms']:.5f} ms, "
                f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}), plain "
                f"{t['plain_ms']:.5f} ms, SDPA "
                f"{'none' if sdpa is None else f'{sdpa:.5f} ms'}")
            entry.update({f"{tag}_{key}": value for key, value in t.items()})
    del flush

    # -- 13.-16. gemma2-2b, gemma3-4b, minicpm-2b at full width ---------------
    # Each at its published depth (the weights fit the card whole): the
    # fp32 kernel path against the plain path on prompts longer than the
    # local window (FP32_PROMPTS), and gemma2-2b served in bf16.
    t_gemma = time.perf_counter()
    fp32_phase(g2cfg, shape=FP32_PROMPTS[GEMMA2])                      # 13
    model, by_path[GEMMA2] = serve_phase(                              # 14
        g2cfg, prompt_batch(g2cfg, BATCH, PROMPT, dev), wave_launches(g2cfg),
        bf16_logits_parity)
    del model
    torch.cuda.empty_cache()
    fp32_phase(get_config(GEMMA3), shape=FP32_PROMPTS[GEMMA3])         # 15
    fp32_phase(get_config(MINICPM), shape=FP32_PROMPTS[MINICPM])       # 16
    log(f"[gemma] phases 13-16 {time.perf_counter() - t_gemma:.1f} s")

    # -- 17.-21. qwen2-vl-72b, musicgen-medium, qwen3-moe-235b-a22b -----------
    # At full width; qwen2-vl and qwen3-moe cut in depth so the weights fit
    # the card (QWEN2VL_*_LAYERS, QWEN3MOE_FP32_LAYERS).  The stub modes'
    # waves run ``serve_wave`` with each mode's batch keys.
    t_stub = time.perf_counter()
    vcfg = get_config(QWEN2VL)
    log(f"[qwen2-vl] depth cut: {vcfg.n_layers} -> {QWEN2VL_FP32_LAYERS} "
        f"layers in fp32, {QWEN2VL_SERVE_LAYERS} in bf16; widths as "
        f"published (d_model {vcfg.d_model}, {vcfg.n_heads}/"
        f"{vcfg.n_kv_heads} heads of {vcfg.hd}, d_ff {vcfg.d_ff}, M-RoPE "
        f"sections {vcfg.mrope_sections})")
    fp32_phase(dataclasses.replace(vcfg, n_layers=QWEN2VL_FP32_LAYERS),  # 17
               seed=STUB_SEED)
    vcfg2 = dataclasses.replace(vcfg, n_layers=QWEN2VL_SERVE_LAYERS)
    model, by_path[vcfg2.name] = serve_phase(                          # 18
        vcfg2, prompt_batch(vcfg2, BATCH, PROMPT, dev, STUB_SEED),
        wave_launches(vcfg2), bf16_logits_parity, profile=True)
    del model
    free_memory()
    mcfg = get_config(MUSICGEN)
    fp32_phase(mcfg, seed=STUB_SEED)                                   # 19
    model, by_path[MUSICGEN] = serve_phase(                            # 20
        mcfg, prompt_batch(mcfg, BATCH, PROMPT, dev, STUB_SEED),
        wave_launches(mcfg), bf16_logits_parity)
    del model
    free_memory()
    qcfg = get_config(QWEN3MOE)
    log(f"[qwen3-moe] depth cut: {qcfg.n_layers} -> {QWEN3MOE_FP32_LAYERS} "
        f"layers in fp32; widths as published (d_model {qcfg.d_model}, "
        f"{qcfg.n_experts} experts top-{qcfg.experts_per_token} of d_ff "
        f"{qcfg.expert_d_ff}, {qcfg.n_heads}/{qcfg.n_kv_heads} heads of "
        f"{qcfg.hd})")
    fp32_phase(dataclasses.replace(qcfg, n_layers=QWEN3MOE_FP32_LAYERS),  # 21
               layerwise=True, seed=STUB_SEED)
    log(f"[stub] phases 17-21 {time.perf_counter() - t_stub:.1f} s")

    # -- 22./23. kimi-k2-1t-a32b at full width, cut in depth ------------------
    # Every width as published (attention at 64/8 heads of head dim 112, 384
    # experts top-8 and a shared expert); the depth cut so the weights fit
    # the card (KIMI_*_LAYERS).  The expert-parallel MoE does not run here:
    # it needs one rank a card, and this machine has one card
    # (tests/test_torch_moe_ep.py holds it on CPU ranks).
    t_kimi = time.perf_counter()
    kcfg = get_config(KIMI)
    log(f"[kimi-k2] depth cut: {kcfg.n_layers} -> {KIMI_FP32_LAYERS} layer "
        f"in fp32, {KIMI_SERVE_LAYERS} in bf16; widths as published "
        f"(d_model {kcfg.d_model}, {kcfg.n_experts} experts top-"
        f"{kcfg.experts_per_token} of d_ff {kcfg.expert_d_ff} and "
        f"{kcfg.n_shared_experts} shared, {kcfg.n_heads}/{kcfg.n_kv_heads} "
        f"heads of {kcfg.hd}, vocab {kcfg.vocab_size})")
    fp32_phase(dataclasses.replace(kcfg, n_layers=KIMI_FP32_LAYERS),   # 22
               layerwise=True, seed=STUB_SEED)
    kcfg2 = dataclasses.replace(kcfg, n_layers=KIMI_SERVE_LAYERS)
    model, by_path[kcfg2.name] = serve_phase(                          # 23
        kcfg2, prompt_batch(kcfg2, BATCH, PROMPT, dev, STUB_SEED),
        wave_launches(kcfg2),
        lambda model, batch, _: {"bf16_layer_parity": layer_parity(
            KIMI, model, batch["tokens"], tol=TOL["bfloat16"])},
        profile=True)
    log(f"[kimi-k2] {expert_floors_text(kcfg2)}; phases 22-23 "
        f"{time.perf_counter() - t_kimi:.1f} s")
    del model
    free_memory()

    # -- 24. the serving engine: sessions committed through the protocols ----
    engine_err = engine_phase(torch, dev, by_path)
    # flash_decode's outputs on the engine's path (24a-24b), held against
    # the plain version in the phase, join its bf16 error.
    decode_entry = next(e for e in kernels if e["name"] == "flash_decode")
    decode_entry["engine_max_abs_err"] = engine_err
    decode_entry["max_abs_err"] = max(decode_entry["max_abs_err"],
                                      engine_err)

    # -- 25. flash_attention at 32,768 query tokens; the cost pass ----------
    t_long = time.perf_counter()
    by_path["flash_attention 32k"], long_keys = long_attention_phase(
        torch, dev, randn)
    fa_entry = next(e for e in kernels if e["name"] == "flash_attention")
    fa_entry.update(long_keys)
    for key, fp32 in (("max_abs_err", False), ("max_abs_err_fp32", True)):
        fa_entry[key] = max([fa_entry[key]] + [
            v for k, v in long_keys.items()
            if k.endswith("max_abs_err") and ("fp32" in k) == fp32])
    cost_vs_card_phase(torch, dev, card, train_out, served)
    dryrun_layout_phase(torch)
    log(f"[long] phase 25 {time.perf_counter() - t_long:.1f} s")

    # -- 26. the discrete-event half of the commit core (no kernel) ---------
    sim_phase(card)
    rot_phase(card)

    for entry in kernels:
        per = {path: c[entry["name"]] for path, c in by_path.items()}
        entry["launches"], entry["launches_by_path"] = sum(per.values()), per

    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
