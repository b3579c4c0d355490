#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; TF32 off for fp32 products;
  2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card, fp32
     and bf16, over the repo's sweeps and the serving path's own shapes;
  4. full-width llama3.2-1b (16 layers) in fp32: the kernel path against
     the plain path on the prefill logits, 8 decode steps and the greedy
     tokens;
  5. serve llama3.2-1b in bf16 with ``generate`` (4 requests, 256-token
     prompts, 32 new tokens, max_len 512); the launch counters show that
     every prefill and decode attention went through the kernels;
  6. the continuous batcher with ``KernelDecode`` on the card, no drops;
  7. one ``{"kernels": [...]}`` line with each kernel's time, bound, plain
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

# The serving path: llama3.2-1b, 4 requests, 256-token prompts, 32 new
# tokens, cache capacity 512.
ARCH = "llama3.2-1b"
BATCH, PROMPT, NEW, MAX_LEN = 4, 256, 32, 512
DECODE_KV_LENS = (1, 63, 64, 65, 257, 272, 300, 512)
FP32_DECODE_STEPS = 8
MODEL_TOL = 1e-3       # fp32 logits, kernel path vs plain path, 16 layers
BF16_MODEL_TOL = 0.25  # bf16 prefill logits: bf16 rounding through 16 layers

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

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- 3. kernels against their plain versions -------------------------------
    errs = {"flash_attention": {}, "flash_decode": {}}

    def hold(name, got, want, dtype, what, main_shape=False):
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = TOL[dtype]
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        check(ok and got.dtype == want.dtype,
              f"{name} {what} {dtype}: max abs err {err:g} (tol {tol})")
        if main_shape:
            errs[name][dtype] = max(errs[name].get(dtype, 0.0), err)
        return err

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
    log(f"[kernels] {n_checks} comparisons with the plain version passed; "
        f"main-shape max abs err {json.dumps(errs)}")

    # -- 4. full-width llama3.2-1b, fp32: kernel path vs plain path -----------
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = init_model(cfg, 0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[fp32] {ARCH}: {cfg.n_layers} layers, {n_params} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)

    def both_paths(fn):
        model.plain_attention = False
        got = fn()
        model.plain_attention = True
        want = fn()
        model.plain_attention = False
        return got, want

    def rel_err(a, b):
        return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)

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
        model.plain_attention = False
        lk, ck = model.decode_step(batch, ck, PROMPT + t)
        model.plain_attention = True
        lp, cp = model.decode_step(batch, cp, PROMPT + t)
        model.plain_attention = False
        e = max_err(lk, lp)
        fp32_errs.append(e)
        check(e <= MODEL_TOL, f"fp32 decode step {t} logits err {e:g}")
        tk = lk[:, -1, :cfg.vocab_size].argmax(-1)
        tp = lp[:, -1, :cfg.vocab_size].argmax(-1)
        for r in (tk != tp).nonzero().flatten().tolist():
            # A different greedy token is allowed only at a near-tie.
            gap = abs(float(lp[r, -1, tk[r]] - lp[r, -1, tp[r]]))
            check(gap <= 2 * MODEL_TOL, f"greedy token differs at step {t} "
                  f"row {r}, plain-path logit gap {gap:g}")
            ties += 1
        tok = tk
    log(f"[fp32] kernel vs plain path: prefill + {FP32_DECODE_STEPS} decode "
        f"logits max abs err {max(fp32_errs):g} (tol {MODEL_TOL}), "
        f"relative {rel_err(lk, lp):g}; greedy tokens equal "
        f"({ties} near-ties)")
    del model, ck, cp, lk, lp
    torch.cuda.empty_cache()

    # -- 5. serve llama3.2-1b in bf16 through the kernels ----------------------
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
    serve_launches = ops.launch_counts()
    check(out.shape == (BATCH, NEW) and out.min() >= 0
          and out.max() < cfg.vocab_size, f"served tokens {out.shape}")
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * (NEW - 1)}
    check(serve_launches == want,
          f"launches {serve_launches}, expected {want}")
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
    # The bf16 kernel path against the plain path.
    model.plain_attention = True
    lp, _, _ = model.prefill({"tokens": prompts}, MAX_LEN)
    model.plain_attention = False
    bf16_err = max_err(lk, lp)
    check(bool(torch.isfinite(lk).all()), "bf16 prefill logits finite")
    check(bf16_err <= BF16_MODEL_TOL,
          f"bf16 prefill logits err {bf16_err:g} > {BF16_MODEL_TOL}")
    check(int(out[0, 0]) == int(lk[0, -1, :cfg.vocab_size].argmax()),
          "first served token is the prefill's argmax")
    decode_ms = (wall_ms - prefill_ms) / (NEW - 1)
    serve = {"requests": BATCH, "prompt": PROMPT, "new_tokens": NEW,
             "max_len": MAX_LEN, "dtype": "bfloat16",
             "counted_wave_ms": wall * 1e3, "wave_ms": walls,
             "wall_ms": wall_ms, "prefill_ms": prefill_ms,
             "decode_ms_per_token": decode_ms,
             "tokens_per_s": BATCH * NEW / wall_ms * 1e3, "peak_gb": peak_gb,
             "launches": serve_launches,
             "bf16_prefill_logit_err_vs_plain": bf16_err}
    log(f"[serve] {json.dumps(serve)}")
    del lk, lp

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

    # -- 7. kernel times at the serving shapes (bf16) --------------------------
    # Before each timed call the card spins for about 1 ms (so the host has
    # queued the call before the card reaches it, and the events bracket
    # device time, not the wrapper's Python) and zeroes 64 MB (evicting the
    # 50 MB L2, as the layers between two attention calls do).
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
    del flush

    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
