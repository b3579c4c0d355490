"""Device times of the two scan kernels at the serving shapes, by the method
of chip_smoke.py phase 11 (cold L2, CUDA events), and the profiler's device
time of each call.

    PYTHONPATH=src python tools/scan_times.py [--label L]

It imports ``repro_torch`` from the path and nothing else of this checkout,
so the same file times another checkout's kernels too:
``PYTHONPATH=<other>/src python tools/scan_times.py``.  Two
trees timed in turns (a, b, b, a) in one command compare on one card.
Prints one JSON line: the card, a one-element ``add_`` timed the same way
(the method's floor), and per call (``mlstm_scan`` at xlstm-125m's
(4, S, 4, 384), ``mamba_scan`` at Jamba's (4, S, 8192, 16), fp32 as served,
S = 256 for the prefill and 1 for a decode step that updates the state in
place) the event ms, and the profiler's device ms of one call in all and
by device kernel.  Where the tree's ``ops.mlstm`` takes ``n0``, the mLSTM calls
also carry the normalizer, as the model's kernel path does.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch

from repro_torch.kernels import ops

BATCH, PROMPT = 4, 256
MLSTM_H, MLSTM_HD = 4, 384
JAMBA_DI, JAMBA_N = 8192, 16


def cold_ms(fn, flush, iters=30, warmup=3):
    """Mean device ms of one call with a cold L2: the card spins ~1 ms
    first so the events bracket device time, and 64 MB are zeroed."""
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


def profiled(fn, flush, calls=20):
    """{device kernel of one call: mean device ms per call} from
    torch.profiler, each call after a cold-L2 flush (not counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name in ms:
            ms[e.name] += (e.time_range.end - e.time_range.start) / calls / 1e3
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_times: no CUDA device; this script times the "
                         "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def mlstm_inputs(S, state_scale):
        B, H, hd = BATCH, MLSTM_H, MLSTM_HD
        return ((randn(B, S, H, hd), randn(B, S, H, hd, scale=hd ** -0.5),
                 randn(B, S, H, hd), torch.sigmoid(randn(B, S, H)),
                 torch.sigmoid(randn(B, S, H) + 2.0)),
                randn(B, H, hd, hd, scale=state_scale),
                randn(B, H, hd, scale=state_scale))

    def mamba_inputs(S, state_scale):
        B, di, N = BATCH, JAMBA_DI, JAMBA_N
        return (randn(B, S, di), torch.nn.functional.softplus(randn(B, S, di)),
                -torch.exp(randn(di, N, scale=0.5)), randn(B, S, N),
                randn(B, S, N), randn(B, di, N, scale=state_scale))

    with_n = "n0" in inspect.signature(ops.mlstm).parameters
    pre, c_pre, n_pre = mlstm_inputs(PROMPT, 0.0)
    step, c_step, n_step = mlstm_inputs(1, 0.1)
    mpre = mamba_inputs(PROMPT, 0.0)
    mstep = mamba_inputs(1, 0.5)
    if with_n:
        calls = {
            "mlstm_prefill": lambda: ops.mlstm(*pre, c_pre, n0=n_pre),
            "mlstm_decode": lambda: ops.mlstm(*step, c_step, n0=n_step,
                                              out=c_step, n_out=n_step)}
    else:
        calls = {
            "mlstm_prefill": lambda: ops.mlstm(*pre, c_pre),
            "mlstm_decode": lambda: ops.mlstm(*step, c_step, out=c_step)}
    calls["mamba_prefill"] = lambda: ops.selective_scan(*mpre)
    calls["mamba_decode"] = lambda: ops.selective_scan(*mstep,
                                                       out=mstep[-1])

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    res = {"label": args.label, "card": smi.stdout.strip(),
           "torch": torch.__version__, "mlstm_carries_n": with_n,
           "floor_ms": cold_ms(lambda: one.add_(1), flush)}
    for name, fn in calls.items():
        res[f"{name}_ms"] = cold_ms(fn, flush)
        kernels = profiled(fn, flush)
        res[f"{name}_profiled_ms"] = sum(kernels.values())
        res[f"{name}_kernels_ms"] = {
            (k.split("::")[1].split("(")[0] if "::" in k else k[:60]): v
            for k, v in kernels.items()}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
