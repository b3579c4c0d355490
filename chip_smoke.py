#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; TF32 off for fp32 products;
  2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, started together); every entry function's
     registers, spills (none allowed) and shared memory, the HGMMA
     instructions of the bf16 ``flash_attention`` and the TF32 HMMA of the
     ``mlstm_scan`` prefill in their SASS;
  3. hold each kernel against its plain PyTorch version on the card, fp32
     and bf16, over the repo's sweeps and the serving paths' own shapes
     (``mlstm_scan``: y, C and the normalizer n);
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
     remat "full") through ``repro_torch.launch.train.train``, with
     deterministic algorithms on: the training forward (plain path, with
     grad) against the served forward through the kernels; the gradient
     against a central difference along a random unit direction; a
     6-step golden run whose loss falls; then a run with Cornus
     checkpoints over 4 hosts every 3 steps that crashes after host 0's
     vote in epoch 6, and its resume from epoch 3, whose losses must
     equal the golden run's.  The training path launches none of the
     four kernels: it differentiates the plain path, as the JAX package
     does;
 12. one ``flash_attention`` and one ``flash_decode`` call under
     torch.profiler, each exactly one device kernel, and each scan call
     (one kernel; two for the ``mlstm_scan`` prefill: scores, then the
     scan); then one ``{"kernels": [...]}`` line with each kernel's time
     (events and profiler), bound, plain and library times at the serving
     shapes, beside the timing method's floor.
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
# The repo's kernel sweeps (tests/test_kernels.py:35-44 and :76-86), the
# attention sweep with one head-dim-128 case appended (the CPU tests pick
# earlier cases by index).
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
]
MLSTM_SWEEP = [                      # tests/test_kernels.py:157-162
    # (B, S, H, hd, chunk)
    (1, 32, 2, 16, 8),
    (2, 80, 4, 32, 16),        # ragged seq vs chunk
    (1, 64, 1, 64, 64),        # single chunk
]
MLSTM_C_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the returned state
MAMBA_SWEEP = [                      # tests/test_kernels.py:107-112
    # (B, S, di, N, chunk)
    (1, 32, 64, 8, 8),
    (2, 100, 128, 16, 16),     # ragged seq vs chunk
    (1, 64, 256, 4, 64),       # single chunk
]
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------
def attention_bound(B, Hq, Hkv, Sq, Skv, hd, *, causal, q_offset=0,
                    kv_len=None, dtype="bfloat16"):
    """(bound_ms, bound_by, bytes, flops) for one attention call: each input
    read once (keys up to the valid length), the output written once, and
    4·hd flops (QK and PV multiply-adds) per visible (query, key) pair."""
    itemsize = 2 if dtype == "bfloat16" else 4
    valid = min(Skv, Skv if kv_len is None else kv_len)
    if causal:
        pairs = sum(max(0, min(valid, q + q_offset + 1)) for q in range(Sq))
    else:
        pairs = Sq * valid
    nbytes = itemsize * (2 * B * Hq * Sq * hd + 2 * B * Hkv * valid * hd)
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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


def sass_forms(lib: Path, opcode: str) -> Dict[str, int]:
    """{instruction form: count} of the ``opcode`` instructions in the
    card's code in ``lib`` (``cuobjdump -sass``); a form is the opcode with
    its modifiers and, for HGMMA, whether B is read transposed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump -sass {lib.name}: {res.stderr}")
    forms: Dict[str, int] = {}
    for m in re.finditer(rf"\b({opcode}\.[\w.]+)([^;]*);", res.stdout):
        form = m.group(1) + (" tnspB" if ".tnspB" in m.group(2) else "")
        forms[form] = forms.get(form, 0) + 1
    return forms


# ---------------------------------------------------------------------------
# Training: the FLOP count, the memory reckoning, the gradient check
# ---------------------------------------------------------------------------
def spec_elements(cfg, layers_only=False) -> int:
    """Parameter elements in the model's spec leaves (``model_specs``),
    without allocating; only the layers' with ``layers_only``."""
    from repro_torch.models.layers import PSpec
    from repro_torch.models.lm import model_specs

    def count(tree):
        if isinstance(tree, PSpec):
            return math.prod(tree.shape)
        items = tree.values() if isinstance(tree, dict) else tree
        return sum(count(t) for t in items)

    specs = model_specs(cfg)
    return count(specs["layers"] if layers_only else specs)


def train_flops(cfg, batch, seq, remat="full"):
    """Model FLOPs of one training step, by term: 6·N·T for the
    parameters' products (2 forward, 4 backward per parameter and token; N
    counts every leaf, the tied embedding once, as the head's product);
    the attention's score and value products, 4·hd per (query, key) pair
    over the full S x S that the plain attention computes, times 3 for the
    forward and backward; and with remat "full" the layers' forward again
    (their parameters' 2·N_layers·T and the attention's forward)."""
    tokens = batch * seq
    n_attn = sum(k in ("attn", "attn_local") for k in cfg.full_pattern)
    attn_fwd = 4.0 * batch * cfg.n_heads * cfg.hd * seq * seq * n_attn
    out = {"params": 6.0 * spec_elements(cfg) * tokens,
           "attention": 3 * attn_fwd,
           "recompute": (2.0 * spec_elements(cfg, layers_only=True) * tokens
                         + attn_fwd) if remat == "full" else 0.0}
    out["total"] = sum(out.values())
    return out


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
    from repro_torch.models.blocks import Ctx, _scaled, ffn_apply, mixer
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
        rope = model.rope(text_positions(B, tokens.shape[1], pos,
                                         device=tokens.device))
        for li, kind in enumerate(cfg.full_pattern):
            out = {}
            for plain in (False, True):
                ctx = Ctx(mode=mode, rope=rope, cache=layer_cache(
                    cfg, caches[plain], li), pos_offset=pos,
                    max_len=MAX_LEN, plain=plain)
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
    log(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, "
        f"{spec_elements(cfg)} parameter elements, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, fp32, remat full; model FLOPs a step "
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
        "model_tflop_per_step": flops["total"] / 1e12,
        "mfu_fp32_67tflops": flops["total"] / step_s / PEAK_FLOPS["float32"],
        "bound_ms": flops["total"] / PEAK_FLOPS["float32"] * 1e3,
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
    from repro_torch.launch.serve import ServeConfig, generate
    from repro_torch.models import init_model, layer_is_moe
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
    for name in _build.KERNELS:
        for fn, (regs, st, ld, smem) in ptxas_report(
                _build.build_log(name)).items():
            dyn = ""
            param = re.search(r"Li(\d+)E", fn)
            if "attn_wgmma_kernel" in fn:
                hd = int(fn.split("attn_wgmma_kernelILi")[1].split("E")[0])
                dyn = f", {flash_attention.wgmma_smem_bytes(hd)} B dynamic"
            elif "decode_kernel" in fn:
                item = 2 if "bfloat16" in fn else 4
                dyn = (f", {decode_attention.smem_bytes(4, 128, item)} B "
                       f"dynamic at g 4, hd 128")
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
    hgmma = sass_forms(_build.lib_path("flash_attention"), "HGMMA")
    log(f"[sass flash_attention] {sum(hgmma.values())} HGMMA instructions: "
        f"{json.dumps(hgmma)}")
    check(any("tnspB" in f for f in hgmma) and
          any("tnspB" not in f for f in hgmma),
          "flash_attention's bf16 kernel issues no HGMMA for one product")
    hmma = sass_forms(_build.lib_path("mlstm_scan"), "HMMA")
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
            "flash_decode_hd128": {}, "mamba_scan": {},
            "mamba_scan_state": {}}

    def hold(name, got, want, dtype, what, main_shape=False, tol=None):
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = TOL[dtype] if tol is None else tol
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        check(ok and got.dtype == want.dtype,
              f"{name} {what} {dtype}: max abs err {err:g} (tol {tol})")
        if main_shape:
            errs[name][dtype] = max(errs[name].get(dtype, 0.0), err)
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
                   in_place=False):
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
        hold("mlstm_scan", y, want_y.to(y.dtype), dtype, what, main_shape)
        hold("mlstm_scan_state", c_last, want_c, dtype, what, main_shape,
             tol=MLSTM_C_TOL[dtype])
        hold("mlstm_scan_n", n_last, want_n, dtype, what, main_shape,
             tol=MLSTM_C_TOL[dtype])
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

    def hold_mamba(inp, dtype, what, main_shape=False, in_place=False):
        """One mamba_scan call against ref.mamba_scan_ref: y at TOL, the
        state at MAMBA_H_TOL.  ``in_place`` passes out=h0, as the decode
        step does."""
        want_y, want_h = ref.mamba_scan_ref(*inp)
        h0 = inp[-1].clone() if in_place else inp[-1]
        y, h = ops.selective_scan(*inp[:-1], h0, out=h0 if in_place
                                  else None)
        check(h is h0 or not in_place, "mamba_scan out= is the state")
        hold("mamba_scan", y, want_y.to(y.dtype), dtype, what, main_shape)
        hold("mamba_scan_state", h, want_h, dtype, what, main_shape,
             tol=MAMBA_H_TOL)
        return y, h

    jcfg = get_config(JAMBA)
    JDI, JN, JHD = jcfg.ssm_expand * jcfg.d_model, jcfg.ssm_state, jcfg.hd
    n_checks = 0
    for dtype in ("float32", "bfloat16"):
        for case in ATTN_SWEEP:
            B, Hq, Hkv, Sq, Skv, hd, causal, window, cap = case
            q = randn(1, (B, Hq, Sq, hd), dtype)
            k = randn(2, (B, Hkv, Skv, hd), dtype)
            v = randn(3, (B, Hkv, Skv, hd), dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            hold("flash_attention", ops.flash_attention(q, k, v, **kw),
                 ref.attention_ref(q, k, v, **kw), dtype, str(case))
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
        for case in DECODE_SWEEP:
            B, Hq, Hkv, T, hd, kv_len, cap = case
            q = randn(7, (B, Hq, 1, hd), dtype)
            k = randn(8, (B, Hkv, T, hd), dtype)
            v = randn(9, (B, Hkv, T, hd), dtype)
            hold("flash_decode", ops.flash_decode(q, k, v, kv_len,
                                                  softcap=cap),
                 ref.attention_ref(q, k, v, causal=False, softcap=cap,
                                   kv_len=kv_len), dtype, str(case))
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
        for case in MLSTM_SWEEP:
            B, S, H, hd, chunk = case
            hold_mlstm(mlstm_inputs(30, B, S, H, hd, dtype),
                       torch.zeros((B, H, hd, hd), device=dev),
                       randn(35, (B, H, hd), "float32") * 0.3, dtype,
                       str(case), chunk=chunk)
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
        n_checks += len(MLSTM_SWEEP) + 4
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
        # mamba_scan: the repo's sweep from a nonzero state, the state
        # carried across two calls, and Jamba's serving shapes (the prefill
        # from a zero state; a decode step updating the state in place).
        for case in MAMBA_SWEEP:
            B, S, di, N, _ = case
            hold_mamba(mamba_inputs(100, B, S, di, N, dtype, 0.3), dtype,
                       str(case))
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
        n_checks += len(MAMBA_SWEEP) + 4
    log(f"[kernels] {n_checks} comparisons with the plain version passed; "
        f"main-shape max abs err {json.dumps(errs)}")

    # -- 4. full-width llama3.2-1b, fp32: kernel path vs plain path -----------
    def rel_err(a, b):
        return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)

    def fp32_parity(name, model, prompts):
        """Prefill and FP32_DECODE_STEPS greedy decode steps on the kernel
        path and on the plain path: logits within MODEL_TOL, the same greedy
        tokens except at near-ties.  For an MoE model, the expert choices
        that differ between the two paths are counted and printed first."""
        with recorded_routes(model) as routes:
            try:
                free_running(name, model, prompts)
            finally:
                n, total = routes.differ()
                if total:
                    log(f"[fp32] {name} expert choices that differ between "
                        f"the paths: {n} of {total} (token, router call)")

    def free_running(name, model, prompts):
        cfg = model.cfg

        def both_paths(fn):
            model.plain_kernels = False
            got = fn()
            model.plain_kernels = True
            want = fn()
            model.plain_kernels = False
            return got, want

        (lk, ck, _), (lp, cp, _) = both_paths(
            lambda: model.prefill({"tokens": prompts}, MAX_LEN))
        e = max_err(lk, lp)
        check(bool(torch.isfinite(lk).all()) and lk.shape == (
            BATCH, 1, cfg.padded_vocab), "fp32 prefill logits finite, shaped")
        check(e <= MODEL_TOL, f"fp32 prefill logits err {e:g} > {MODEL_TOL}")
        fp32_errs = [e]
        tok = lk[:, -1, :cfg.vocab_size].argmax(-1)
        ties = 0
        for t in range(FP32_DECODE_STEPS):
            batch = {"tokens": tok[:, None]}
            model.plain_kernels = False
            lk, ck = model.decode_step(batch, ck, PROMPT + t)
            model.plain_kernels = True
            lp, cp = model.decode_step(batch, cp, PROMPT + t)
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
        log(f"[fp32] {name} kernel vs plain path: prefill + "
            f"{FP32_DECODE_STEPS} decode logits max abs err "
            f"{max(fp32_errs):g} (tol {MODEL_TOL}), relative "
            f"{rel_err(lk, lp):g}; greedy tokens equal ({ties} near-ties)")

    def fp32_phase(cfg, layerwise=False, free=True):
        """The fp32 model of ``cfg``: ``layer_parity`` if ``layerwise``,
        then ``fp32_parity`` if ``free``; the model is freed after."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, 0, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[fp32] {cfg.name}: {cfg.n_layers} layers, {n_params} "
            f"parameters, init {time.perf_counter() - t0:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=gen, device=dev)
        t0 = time.perf_counter()
        if layerwise:
            layer_parity(cfg.name, model, prompts)
        if free:
            fp32_parity(cfg.name, model, prompts)
        torch.cuda.synchronize()
        log(f"[fp32] {cfg.name}: parity {time.perf_counter() - t0:.1f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model
        torch.cuda.empty_cache()
        return prompts

    cfg = get_config(ARCH)
    prompts = fp32_phase(cfg)

    # -- 5. serve llama3.2-1b in bf16 through the kernels ----------------------
    def bf16_logits_parity(model, prompts, lk):
        """The bf16 kernel path's prefill logits ``lk`` against the plain
        path's, within BF16_MODEL_TOL."""
        model.plain_kernels = True
        lp, _, _ = model.prefill({"tokens": prompts}, MAX_LEN)
        model.plain_kernels = False
        err = max_err(lk, lp)
        check(err <= BF16_MODEL_TOL,
              f"bf16 prefill logits err {err:g} > {BF16_MODEL_TOL}")
        return {"bf16_prefill_logit_err_vs_plain": err}

    def serve_phase(cfg, prompts, want_launches, parity):
        """One counted wave (launch counters from 0), then the median of
        three more waves and of three prefills alone; then
        ``parity(model, prompts, prefill_logits)`` holds the bf16 kernel
        path against the plain path and returns its errors."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = init_model(cfg, 0, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        scfg = ServeConfig(max_new_tokens=NEW, max_len=MAX_LEN)
        generate(cfg, model, prompts[:, :PROMPT // 4], dataclasses.replace(
            scfg, max_new_tokens=4), device=dev)              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(cfg, model, prompts, scfg, device=dev)
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
            generate(cfg, model, prompts, scfg, device=dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            lk, _, _ = model.prefill({"tokens": prompts}, MAX_LEN)
            torch.cuda.synchronize()
            prefills.append((time.perf_counter() - t1) * 1e3)
        wall_ms, prefill_ms = sorted(walls)[1], sorted(prefills)[1]
        check(bool(torch.isfinite(lk).all()), "bf16 prefill logits finite")
        check(int(out[0, 0]) == int(lk[0, -1, :cfg.vocab_size].argmax()),
              "first served token is the prefill's argmax")
        errors = parity(model, prompts, lk)
        decode_ms = (wall_ms - prefill_ms) / (NEW - 1)
        serve = {"arch": cfg.name, "requests": BATCH, "prompt": PROMPT,
                 "new_tokens": NEW, "max_len": MAX_LEN, "dtype": "bfloat16",
                 "counted_wave_ms": wall * 1e3, "wave_ms": walls,
                 "wall_ms": wall_ms, "prefill_ms": prefill_ms,
                 "decode_ms_per_token": decode_ms,
                 "tokens_per_s": BATCH * NEW / wall_ms * 1e3,
                 "peak_gb": peak_gb, "init_s": init_s,
                 "init_peak_gb": init_peak_gb, "launches": launches,
                 **errors}
        log(f"[serve] {json.dumps(serve)}")
        return model, launches

    model, serve_launches = serve_phase(cfg, prompts, {
        "flash_attention": cfg.n_layers,
        "flash_decode": cfg.n_layers * (NEW - 1), "mlstm_scan": 0,
        "mamba_scan": 0}, bf16_logits_parity)

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
    n_mlstm = sum(kind == "mlstm" for kind in xcfg.full_pattern)
    model, xlstm_launches = serve_phase(xcfg, xprompts, {
        "flash_attention": 0, "flash_decode": 0,
        "mlstm_scan": n_mlstm * NEW, "mamba_scan": 0},
        lambda model, prompts, _: {"bf16_layer_parity": layer_parity(
            XLSTM, model, prompts, tol=TOL["bfloat16"])})
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
    kinds = jcfg2.full_pattern
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    model, jamba_launches = serve_phase(jcfg2, jprompts, {
        "flash_attention": n_attn, "flash_decode": n_attn * (NEW - 1),
        "mlstm_scan": 0, "mamba_scan": n_mamba * NEW},
        lambda model, prompts, _: {"bf16_layer_parity": layer_parity(
            JAMBA, model, prompts, tol=TOL["bfloat16"])})
    # The decode floor: a step reads every weight once (the embedding only
    # its 4 rows, which the count below ignores), and with the expert
    # products as they stand (three batched products over all experts)
    # every expert; reading only the picked experts (at most BATCH * k of
    # them per MoE layer) would lower it.
    param_bytes = 2 * sum(p.numel() for p in model.parameters())
    n_moe = sum(layer_is_moe(jcfg2, li) for li in range(jcfg2.n_layers))
    expert_bytes = 2 * 3 * jcfg2.d_model * jcfg2.expert_d_ff
    picked = min(jcfg2.n_experts, BATCH * jcfg2.experts_per_token)
    unread = n_moe * (jcfg2.n_experts - picked) * expert_bytes
    log(f"[jamba] decode floor per token (bf16 weights / 3.35 TB/s): every "
        f"expert read {param_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"({param_bytes / 1e9:.1f} GB); only the <= {picked} picked of "
        f"{jcfg2.n_experts} experts per MoE layer "
        f"{(param_bytes - unread) / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"({(param_bytes - unread) / 1e9:.1f} GB); Jamba phases "
        f"{time.perf_counter() - t_jamba:.1f} s")
    del model
    torch.cuda.empty_cache()

    # -- 11. train llama3.2-1b at full width ----------------------------------
    _, train_launches = train_phase(torch, dev)

    # -- 12. kernel times at the serving shapes -------------------------------
    # Before each timed call the card spins for about 1 ms (so the host has
    # queued the call before the card reaches it, and the events bracket
    # device time, not the wrapper's Python) and zeroes 64 MB (evicting the
    # 50 MB L2, as the layers between two kernel calls do).
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def cold_ms(fn, iters=30, warmup=3):
        """Mean device ms of one call with a cold L2 (as between layers)."""
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

    kv_len = PROMPT + NEW // 2      # the middle of the served decode run
    # What the same method reads for one trivial kernel: the launch and
    # event overhead under every time below.
    one = torch.zeros(1, device=dev)
    floor_ms = cold_ms(lambda: one.add_(1))
    log(f"[timing] one-element add_ by the same method: {floor_ms:.5f} ms")

    def attention_times(hd, seed):
        """flash_attention (prefill) and flash_decode (one step at kv_len)
        at the serving shapes with head dim ``hd``, bf16: device ms of the
        kernel, of the plain version and of SDPA, and the bounds."""
        dtype = "bfloat16"
        q = randn(seed, (BATCH, PROMPT, 32, hd), dtype).transpose(1, 2)
        k = randn(seed + 1, (BATCH, PROMPT, 8, hd), dtype).transpose(1, 2)
        v = randn(seed + 2, (BATCH, PROMPT, 8, hd), dtype).transpose(1, 2)
        ke, ve = (t.repeat_interleave(4, dim=1).contiguous() for t in (k, v))
        qc = q.contiguous()
        fa = {
            "ms": cold_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            "plain_ms": cold_ms(lambda: ref.attention_ref(q, k, v,
                                                          causal=True)),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                qc, ke, ve, is_causal=True)),
            "bound": attention_bound(BATCH, 32, 8, PROMPT, PROMPT, hd,
                                     causal=True),
            "shape": f"q (4,32,256,{hd}) k,v (4,8,256,{hd}) bf16 causal",
        }
        qd = randn(seed + 3, (BATCH, 1, 32, hd), dtype).transpose(1, 2)
        kc = randn(seed + 4, (BATCH, MAX_LEN, 8, hd), dtype).transpose(1, 2)
        vc = randn(seed + 5, (BATCH, MAX_LEN, 8, hd), dtype).transpose(1, 2)
        kl, vl = (t[:, :, :kv_len].repeat_interleave(4, dim=1).contiguous()
                  for t in (kc, vc))
        qdc = qd.contiguous()
        fd = {
            "ms": cold_ms(lambda: ops.flash_decode(qd, kc, vc, kv_len)),
            "plain_ms": cold_ms(lambda: ref.attention_ref(
                qd, kc, vc, causal=False, kv_len=kv_len)),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                qdc, kl, vl)),
            "bound": attention_bound(BATCH, 32, 8, 1, MAX_LEN, hd,
                                     causal=False, kv_len=kv_len),
            "shape": f"q (4,32,1,{hd}) cache (4,8,512,{hd}) bf16 kv_len "
                     f"{kv_len}",
        }
        return {"flash_attention": fa, "flash_decode": fd}

    # Each path's counted run (counters set to 0 just before it): the
    # served waves, and the training runs, which launch none.
    by_path = {ARCH: serve_launches, f"{ARCH} train": train_launches,
               XLSTM: xlstm_launches,
               jcfg2.name: jamba_launches}

    def launches_of(name):
        per = {path: c[name] for path, c in by_path.items()}
        return sum(per.values()), per

    def device_kernels(fn):
        """Names of the device activities (kernels, memsets, copies) of one
        call of ``fn``, after a warm-up call, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

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
    kernels = []
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:85"),
            ("flash_decode", "src/repro/kernels/decode_attention.py:66")):
        t, tj = llama_t[name], jamba_t[name]
        total, per = launches_of(name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": total, "launches_by_path": per,
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
    pre_ms, pre_prof, pre_k = scan_call(
        lambda: ops.mlstm(*pre, c_pre, n0=n_pre), 2, "mlstm_scan prefill")
    step_ms, step_prof, step_k = scan_call(
        lambda: ops.mlstm(*step, c_step, n0=n_step, out=c_step,
                          n_out=n_step), 1, "mlstm_scan decode")
    kernels.append({
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:73",
        "launches": launches_of("mlstm_scan")[0],
        "launches_by_path": launches_of("mlstm_scan")[1],
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
    kernels.append({
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:55",
        "launches": launches_of("mamba_scan")[0],
        "launches_by_path": launches_of("mamba_scan")[1],
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
    del flush

    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
