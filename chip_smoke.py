#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; TF32 off for fp32 products;
  2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card, fp32
     and bf16, over the repo's sweeps and the serving paths' own shapes;
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
  9. one ``{"kernels": [...]}`` line with each kernel's time, bound, plain
     and library times at the serving shapes.
The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The repo's kernel tolerances (tests/test_kernels.py:28-29).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The repo's kernel sweeps (tests/test_kernels.py:35-44 and :76-86).
ATTN_SWEEP = [
    # (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap)
    (1, 2, 2, 64, 64, 32, True, 0, 0.0),      # MHA causal
    (2, 4, 2, 128, 128, 16, True, 0, 0.0),    # GQA
    (1, 2, 1, 96, 96, 32, True, 0, 0.0),      # ragged seq vs block
    (1, 2, 2, 64, 64, 32, True, 32, 0.0),     # sliding window
    (1, 2, 2, 64, 64, 32, True, 0, 50.0),     # softcap (gemma)
    (1, 2, 2, 64, 64, 32, False, 0, 0.0),     # non-causal
    (1, 8, 4, 160, 224, 64, True, 64, 30.0),  # everything at once, ragged
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

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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
    chunkwise form adds the causal c×c score and P·V terms on top.)"""
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (4 * B * S * H * hd + 2 * B * S * H) \
        + 2 * 4 * B * H * hd * hd
    flops = 4.0 * B * S * H * hd * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def layer_parity(name, model, prompts, tol=MODEL_TOL):
    """The kernel path against the plain path layer by layer: every
    layer's mixer on both paths is fed the plain path's input (and each
    path keeps its own cache), over the prefill and FP32_DECODE_STEPS
    decode steps on the plain path's greedy tokens.  Each mixer output
    must agree within ``tol`` relative to its largest value (the mixer
    output, not the layer's x + mixer output, in which a bf16 residual
    would hide a wrong mixer), and after the prefill and the last step
    every cache leaf within MODEL_TOL.  For a model whose free-running
    paths part by more than rounding (the sLSTM recurrence at random
    full-width init amplifies 1e-6 differences over 256 tokens), this
    holds the kernel inside the model where the end-to-end logits
    cannot.  Returns the largest errors."""
    import torch

    from repro_torch.models import init_cache, layer_cache
    from repro_torch.models.blocks import ATTN_KINDS, Ctx, _scaled, mixer
    cfg = model.cfg
    B, S = prompts.shape
    check(not set(cfg.pattern) & set(ATTN_KINDS)
          and not any("ffn" in layer for layer in model.layers),
          "layer_parity: no rope tables, no FFN")
    dtype = next(model.parameters()).dtype
    caches = {plain: init_cache(cfg, B, MAX_LEN, dtype=dtype,
                                device=prompts.device)
              for plain in (False, True)}
    worst = {"mixer_rel": 0.0, "cache": 0.0}

    def one_pass(tokens, mode, pos):
        x = model.embed_inputs({"tokens": tokens})
        for li, kind in enumerate(cfg.full_pattern):
            out = {}
            for plain in (False, True):
                ctx = Ctx(mode=mode, cache=layer_cache(
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
        return model._head(x[:, -1:])

    def same_caches(when):
        for li in range(cfg.n_layers):
            got = layer_cache(cfg, caches[False], li)
            want = layer_cache(cfg, caches[True], li)
            for n, t in got.items():
                e = max_err(t, want[n])
                check(t.dtype == torch.float32 and e <= MODEL_TOL,
                      f"{name} cache layer {li} {n} {t.dtype} err {e:g} "
                      f"{when}")
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
        f"{worst['cache']:g} (tol {MODEL_TOL})")
    return worst


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    for name in _build.KERNELS:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        for line in dict.fromkeys(lines):
            log(f"[ptxas {name}] {line}")

    def randn(seed, shape, dtype):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(DT[dtype])

    # -- 3. kernels against their plain versions -------------------------------
    errs = {"flash_attention": {}, "flash_decode": {}, "mlstm_scan": {},
            "mlstm_scan_state": {}}

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

    def hold_mlstm(inp, c0, dtype, what, chunk=128, main_shape=False,
                   in_place=False):
        """One mlstm_scan call against ref.mlstm_ref: y at TOL, the state at
        MLSTM_C_TOL.  ``in_place`` passes out=c0, as the decode step does."""
        B, _, H, hd = inp[0].shape
        want_y, want_c, _ = ref.mlstm_ref(*inp, c0, torch.zeros(
            (B, H, hd), device=dev))
        state = c0.clone() if in_place else c0
        y, c_last = ops.mlstm(*inp, state, chunk=chunk,
                              out=state if in_place else None)
        check(c_last is state or not in_place,
              "mlstm_scan out= is the returned state")
        hold("mlstm_scan", y, want_y.to(y.dtype), dtype, what, main_shape)
        hold("mlstm_scan_state", c_last, want_c, dtype, what, main_shape,
             tol=MLSTM_C_TOL[dtype])
        return y, c_last

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
            hold("flash_decode", ops.flash_decode(qd, kc, vc, kv_len),
                 ref.attention_ref(qd, kc, vc, causal=False, kv_len=kv_len),
                 dtype, f"decode (4,32,1,64)/(4,8,512,64) kv_len={kv_len}",
                 main_shape=True)
        n_checks += 1 + len(DECODE_KV_LENS)
        # mlstm_scan: the repo's sweep, a ragged second chunk at the
        # default chunk, a nonzero state carried across two calls, and the
        # serving shapes (prefill from a zero state; a decode step updating
        # a nonzero state in place).
        for case in MLSTM_SWEEP:
            B, S, H, hd, chunk = case
            hold_mlstm(mlstm_inputs(30, B, S, H, hd, dtype),
                       torch.zeros((B, H, hd, hd), device=dev), dtype,
                       str(case), chunk=chunk)
        inp = mlstm_inputs(40, 2, 200, 2, 64, dtype)
        c0 = randn(45, (2, 2, 64, 64), "float32") * 0.3
        y, c_last = hold_mlstm(inp, c0, dtype, "ragged (2,200,2,64)")
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
                   dtype, f"prefill ({BATCH},{PROMPT},{H},{MLSTM_HD})",
                   main_shape=True)
        hold_mlstm(mlstm_inputs(60, BATCH, 1, H, MLSTM_HD, dtype,
                                k_scale=MLSTM_HD ** -0.5),
                   randn(65, (BATCH, H, MLSTM_HD, MLSTM_HD), "float32") * 0.1,
                   dtype, f"decode ({BATCH},1,{H},{MLSTM_HD}) in place",
                   main_shape=True, in_place=True)
        n_checks += len(MLSTM_SWEEP) + 4
    log(f"[kernels] {n_checks} comparisons with the plain version passed; "
        f"main-shape max abs err {json.dumps(errs)}")

    # -- 4. full-width llama3.2-1b, fp32: kernel path vs plain path -----------
    def rel_err(a, b):
        return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)

    def fp32_parity(name, model, prompts):
        """Prefill and FP32_DECODE_STEPS greedy decode steps on the kernel
        path and on the plain path: logits within MODEL_TOL, the same greedy
        tokens except at near-ties."""
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

    def fp32_phase(arch, layerwise=False):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        model = init_model(cfg, 0, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[fp32] {arch}: {cfg.n_layers} layers, {n_params} parameters, "
            f"init {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=gen, device=dev)
        if layerwise:
            layer_parity(arch, model, prompts)
        else:
            fp32_parity(arch, model, prompts)
        del model
        torch.cuda.empty_cache()
        return cfg, prompts

    cfg, prompts = fp32_phase(ARCH)

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
        model = init_model(cfg, 0, dtype=torch.bfloat16, device=dev)
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
                 "peak_gb": peak_gb, "launches": launches, **errors}
        log(f"[serve] {json.dumps(serve)}")
        return model, launches

    model, serve_launches = serve_phase(cfg, prompts, {
        "flash_attention": cfg.n_layers,
        "flash_decode": cfg.n_layers * (NEW - 1), "mlstm_scan": 0},
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
    xcfg, xprompts = fp32_phase(XLSTM, layerwise=True)
    n_mlstm = sum(kind == "mlstm" for kind in xcfg.full_pattern)
    model, xlstm_launches = serve_phase(xcfg, xprompts, {
        "flash_attention": 0, "flash_decode": 0,
        "mlstm_scan": n_mlstm * NEW},
        lambda model, prompts, _: {"bf16_layer_parity": layer_parity(
            XLSTM, model, prompts, tol=TOL["bfloat16"])})
    del model
    torch.cuda.empty_cache()

    # -- 9. kernel times at the serving shapes ---------------------------------
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

    dtype = "bfloat16"
    q = randn(20, (BATCH, PROMPT, 32, 64), dtype).transpose(1, 2)
    k = randn(21, (BATCH, PROMPT, 8, 64), dtype).transpose(1, 2)
    v = randn(22, (BATCH, PROMPT, 8, 64), dtype).transpose(1, 2)
    ke, ve = (t.repeat_interleave(4, dim=1).contiguous() for t in (k, v))
    qc = q.contiguous()
    fa_bound = attention_bound(BATCH, 32, 8, PROMPT, PROMPT, 64, causal=True)
    fa = {
        "ms": cold_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        "plain_ms": cold_ms(lambda: ref.attention_ref(q, k, v, causal=True)),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            qc, ke, ve, is_causal=True)),
    }
    kv_len = PROMPT + NEW // 2      # the middle of the served decode run
    qd = randn(23, (BATCH, 1, 32, 64), dtype).transpose(1, 2)
    kc = randn(24, (BATCH, MAX_LEN, 8, 64), dtype).transpose(1, 2)
    vc = randn(25, (BATCH, MAX_LEN, 8, 64), dtype).transpose(1, 2)
    kl, vl = (t[:, :, :kv_len].repeat_interleave(4, dim=1).contiguous()
              for t in (kc, vc))
    qdc = qd.contiguous()
    fd_bound = attention_bound(BATCH, 32, 8, 1, MAX_LEN, 64, causal=False,
                               kv_len=kv_len)
    fd = {
        "ms": cold_ms(lambda: ops.flash_decode(qd, kc, vc, kv_len)),
        "plain_ms": cold_ms(lambda: ref.attention_ref(
            qd, kc, vc, causal=False, kv_len=kv_len)),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            qdc, kl, vl)),
    }
    kernels = []
    for name, t, bound, replaces, shape in (
            ("flash_attention", fa, fa_bound,
             "src/repro/kernels/flash_attention.py:85",
             "q (4,32,256,64) k,v (4,8,256,64) bf16 causal"),
            ("flash_decode", fd, fd_bound,
             "src/repro/kernels/decode_attention.py:66",
             f"q (4,32,1,64) cache (4,8,512,64) bf16 kv_len {kv_len}")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": serve_launches[name],
            "max_abs_err": errs[name]["bfloat16"],
            "max_abs_err_fp32": errs[name]["float32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t["library_ms"],
            "shape": shape, "bytes": bound[2], "flops": bound[3],
            "bound_formula": "max(bytes / 3.35e12 B/s, flops / 989e12 "
                             "FLOP/s); bytes = inputs read once (keys up "
                             "to kv_len) + output; flops = 4*hd per visible "
                             "(query, key) pair",
        })
    # mlstm_scan at the served shapes and dtype: mlstm_apply casts q, k, v
    # and the gates to fp32, so the kernel runs on fp32 inputs; the prefill
    # starts from a zero state, a decode step updates the cache in place.
    H, hd = xcfg.n_heads, MLSTM_HD
    pre = mlstm_inputs(70, BATCH, PROMPT, H, hd, "float32", hd ** -0.5)
    c_pre = torch.zeros((BATCH, H, hd, hd), device=dev)
    step = mlstm_inputs(80, BATCH, 1, H, hd, "float32", hd ** -0.5)
    c_step = randn(85, (BATCH, H, hd, hd), "float32") * 0.1
    n_pre = torch.zeros((BATCH, H, hd), device=dev)
    ml_pre = mlstm_bound(BATCH, PROMPT, H, hd)
    ml_step = mlstm_bound(BATCH, 1, H, hd)
    kernels.append({
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:73",
        "launches": xlstm_launches["mlstm_scan"],
        "max_abs_err": errs["mlstm_scan"]["bfloat16"],
        "max_abs_err_fp32": errs["mlstm_scan"]["float32"],
        "max_abs_err_state": errs["mlstm_scan_state"]["bfloat16"],
        "max_abs_err_state_fp32": errs["mlstm_scan_state"]["float32"],
        "ms": cold_ms(lambda: ops.mlstm(*pre, c_pre)),
        "plain_ms": cold_ms(lambda: ref.mlstm_ref(*pre, c_pre, n_pre),
                            iters=5, warmup=1),
        "bound_ms": ml_pre[0], "bound_by": ml_pre[1],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunkwise "
                        "mLSTM",
        "shape": f"prefill q,k,v ({BATCH},{PROMPT},{H},{hd}) fp32 chunk "
                 f"128, zero c0",
        "bytes": ml_pre[2], "flops": ml_pre[3],
        "decode_ms": cold_ms(lambda: ops.mlstm(*step, c_step, out=c_step)),
        "decode_plain_ms": cold_ms(lambda: ref.mlstm_ref(*step, c_step,
                                                         n_pre)),
        "decode_bound_ms": ml_step[0], "decode_bound_by": ml_step[1],
        "decode_shape": f"decode q,k,v ({BATCH},1,{H},{hd}) fp32, state "
                        f"updated in place",
        "decode_bytes": ml_step[2], "decode_flops": ml_step[3],
        "bound_formula": "max(bytes / 3.35e12 B/s, flops / 67e12 FLOP/s "
                         "fp32); bytes = q,k,v,i,f,c0 read once + y, "
                         "c_last written; flops = 4*B*S*H*hd^2 (the "
                         "recurrence: k v^T into C and q C per token)",
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
