"""Device times of the four kernels, by the method of chip_smoke.py phase 12
(cold L2, CUDA events; ``scan_times.cold_ms``).

    PYTHONPATH=src python tools/kernel_times.py [--label L] [--wide]

Without ``--wide`` it times the serving shapes of phase 12, which every
checkout's kernels take, so the same file times another checkout too:
``PYTHONPATH=<other>/src python tools/kernel_times.py``; two trees timed in
turns (a, b, b, a) in one command compare on one card.  Those shapes:
``flash_attention`` prefill q (4,Hq,256,hd) causal and ``flash_decode`` q
(4,Hq,1,hd) against a (4,Hkv,512,hd) cache at kv_len 272, bf16, at llama's
32/8 heads of 64, Jamba's 32/8 of 128, gemma2's 8/4 of 256, qwen2-vl's 64/8
and qwen3-moe's 64/4 of 128, musicgen's 24/24 of 64 and kimi-k2's 64/8 of
112; ``mlstm_scan`` at xlstm-125m's (4,S,4,384) and ``mamba_scan`` at
Jamba's (4,S,8192,16), fp32 as served, S = 256 and a one-token step that
updates the state in place.

``--wide`` times public models' full widths, which only the widened
kernels take, beside the plain version, SDPA where one SDPA call computes
the same attention, and the bound of ``chip_smoke``: Phi-3-mini's prefill
(1,32,2048,96) causal; StarCoder's decode, 48 query heads over 1 KV head of
128 against an 8,192-key cache at kv_len 8,000; Falcon-7B's, 71 over 1 of
64 at 2,000 of 2,048; Mamba-2-2.7B's scan (4,256,5120,128) and its step;
xLSTM-7B's mLSTM (1,2048,8,512) and its step.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
from scan_times import cold_ms  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

BATCH, PROMPT, MAX_LEN, KV_LEN = 4, 256, 512, 272
ATTENTION = {           # tag: (hd, q heads, KV heads)
    "llama": (64, 32, 8), "jamba": (128, 32, 8), "gemma2": (256, 8, 4),
    "qwen2-vl": (128, 64, 8), "qwen3-moe": (128, 64, 4),
    "musicgen": (64, 24, 24), "kimi-k2": (112, 64, 8)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--label", default="")
    ap.add_argument("--wide", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device; this script times "
                         "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def model_view(B, S, H, hd, dtype=torch.bfloat16):
        """A (B,H,S,hd) view of a (B,S,H,hd) tensor, as the model passes."""
        return randn(B, S, H, hd, dtype=dtype).transpose(1, 2)

    def mlstm_inputs(B, S, H, hd, state_scale):
        return ((randn(B, S, H, hd), randn(B, S, H, hd, scale=hd ** -0.5),
                 randn(B, S, H, hd), torch.sigmoid(randn(B, S, H)),
                 torch.sigmoid(randn(B, S, H) + 2.0)),
                randn(B, H, hd, hd, scale=state_scale),
                randn(B, H, hd, scale=state_scale))

    def mamba_inputs(B, S, di, N, state_scale):
        return (randn(B, S, di),
                torch.nn.functional.softplus(randn(B, S, di)),
                -torch.exp(randn(di, N, scale=0.5)), randn(B, S, N),
                randn(B, S, N), randn(B, di, N, scale=state_scale))

    with_n = "n0" in inspect.signature(ops.mlstm).parameters

    def mlstm_calls(tag, B, S, H, hd):
        pre, c_pre, n_pre = mlstm_inputs(B, S, H, hd, 0.0)
        step, c_step, n_step = mlstm_inputs(B, 1, H, hd, 0.1)
        if with_n:
            return {f"{tag}_prefill": lambda: ops.mlstm(*pre, c_pre,
                                                        n0=n_pre),
                    f"{tag}_decode": lambda: ops.mlstm(
                        *step, c_step, n0=n_step, out=c_step,
                        n_out=n_step)}, (pre, c_pre, n_pre)
        return {f"{tag}_prefill": lambda: ops.mlstm(*pre, c_pre),
                f"{tag}_decode": lambda: ops.mlstm(*step, c_step,
                                                   out=c_step)}, None

    def mamba_calls(tag, B, S, di, N):
        pre = mamba_inputs(B, S, di, N, 0.0)
        step = mamba_inputs(B, 1, di, N, 0.5)
        return {f"{tag}_prefill": lambda: ops.selective_scan(*pre),
                f"{tag}_decode": lambda: ops.selective_scan(
                    *step, out=step[-1])}, pre

    calls, extra = {}, {}
    if not args.wide:
        for tag, (hd, hq, hkv) in ATTENTION.items():
            q, k, v = (model_view(BATCH, PROMPT, h, hd)
                       for h in (hq, hkv, hkv))
            qd = model_view(BATCH, 1, hq, hd)
            kc, vc = (model_view(BATCH, MAX_LEN, hkv, hd) for _ in range(2))
            calls[f"flash_attention_{tag}"] = (
                lambda q=q, k=k, v=v: ops.flash_attention(q, k, v))
            calls[f"flash_decode_{tag}"] = (
                lambda q=qd, k=kc, v=vc: ops.flash_decode(q, k, v, KV_LEN))
        more, _ = mlstm_calls("mlstm", BATCH, PROMPT, 4, 384)
        calls.update(more)
        more, _ = mamba_calls("mamba", BATCH, PROMPT, 8192, 16)
        calls.update(more)
    else:
        import chip_smoke as cs
        F = torch.nn.functional
        # Phi-3-mini's prefill: 32 heads of 96 over 2,048 causal tokens.
        q, k, v = (model_view(1, 2048, 32, 96) for _ in range(3))
        qc, kc_, vc_ = (t.contiguous() for t in (q, k, v))
        calls["phi3_prefill"] = lambda: ops.flash_attention(q, k, v)
        extra["phi3_prefill"] = {
            "plain": lambda: ref.attention_ref(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(
                qc, kc_, vc_, is_causal=True),
            "bound": cs.attention_bound(1, 32, 32, 2048, 2048, 96,
                                        causal=True)}
        # StarCoder's and Falcon-7B's decode: one KV head under 48 and 71.
        for tag, (hq, hd, T, kv_len) in (("starcoder", (48, 128, 8192, 8000)),
                                         ("falcon", (71, 64, 2048, 2000))):
            qd = model_view(BATCH, 1, hq, hd)
            kc, vc = (model_view(BATCH, T, 1, hd) for _ in range(2))
            ke, ve = (t[:, :, :kv_len].expand(-1, hq, -1, -1).contiguous()
                      for t in (kc, vc))
            qdc = qd.contiguous()
            calls[f"{tag}_decode"] = (
                lambda qd=qd, kc=kc, vc=vc, n=kv_len:
                ops.flash_decode(qd, kc, vc, n))
            extra[f"{tag}_decode"] = {
                "plain": lambda qd=qd, kc=kc, vc=vc, n=kv_len:
                ref.attention_ref(qd, kc, vc, causal=False, kv_len=n),
                "library": lambda qdc=qdc, ke=ke, ve=ve:
                F.scaled_dot_product_attention(qdc, ke, ve),
                "bound": cs.attention_bound(BATCH, hq, 1, 1, T, hd,
                                            causal=False, kv_len=kv_len)}
        more, pre = mamba_calls("mamba2", BATCH, PROMPT, 5120, 128)
        calls.update(more)
        extra["mamba2_prefill"] = {
            "plain": lambda pre=pre: ref.mamba_scan_ref(*pre),
            "bound": cs.mamba_bound(BATCH, PROMPT, 5120, 128)}
        extra["mamba2_decode"] = {
            "bound": cs.mamba_bound(BATCH, 1, 5120, 128)}
        more, pre = mlstm_calls("xlstm7b", 1, 2048, 8, 512)
        calls.update(more)
        extra["xlstm7b_prefill"] = {
            "plain": lambda pre=pre: ref.mlstm_ref(*pre[0], *pre[1:]),
            "bound": cs.mlstm_bound(1, 2048, 8, 512)}
        extra["xlstm7b_decode"] = {"bound": cs.mlstm_bound(1, 1, 8, 512)}

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    res = {"label": args.label, "card": smi.stdout.strip(),
           "torch": torch.__version__, "wide": args.wide,
           "floor_ms": cold_ms(lambda: one.add_(1), flush)}
    for name, fn in calls.items():
        ops.reset_launch_counts()
        fn()
        res[f"{name}_launches"] = sum(ops.launch_counts().values())
        res[f"{name}_ms"] = cold_ms(fn, flush)
        for key, value in extra.get(name, {}).items():
            if key == "bound":
                res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = value[:2]
            else:
                res[f"{name}_{key}_ms"] = cold_ms(value, flush, iters=3,
                                                  warmup=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
