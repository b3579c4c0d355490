"""Profile one served wave, or one training step, on the card with
torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile [--arch A]
        [--n-layers L] [--out DIR] [--train]

(``A`` defaults to ``llama3.2-1b``, e.g. ``xlstm-125m``, ``gemma2-2b`` or
``jamba-v0.1-52b``; ``L`` cuts the depth to its first L layers, as
``--arch jamba-v0.1-52b --n-layers 16`` must to fit one 80 GB card;
``DIR`` defaults to ``build/profile``.)

Serves the same wave as chip_smoke.py (4 requests, 256-token prompts, 32
new tokens, bf16, random weights from seed 0), then profiles a second wave
and prints one JSON line: wall ms, device-busy ms (the union of kernel
intervals), the device's idle share, the kernels with the most device
time, and the device ms under each of the model's spans
(``span_device_ms``; ``repro_torch.obs``).  The profiler's table goes to
``DIR/serve_profile.txt``, its Chrome trace to ``DIR/serve_trace.json``.

With ``--train`` it profiles instead one training step as
``launch.train`` runs it at full width: fp32 parameters and AdamW moments,
batch 1 x 4,096 tokens of the synthetic stream, remat "full" (one warm-up
step first); the table and trace go to ``DIR/train_profile.txt`` and
``DIR/train_trace.json``.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterable

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..data import DataConfig, make_pipeline
from ..device import resolve
from ..models.lm import init_model
from ..optim import AdamWConfig, adamw_init
from . import steps
from .serve import ServeConfig, generate


def _busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3            # profiler times are in us


DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def span_device_ms(events: Iterable[dict]) -> Dict[str, float]:
    """{span name: device ms} from a Chrome trace's events: each device op
    (kernel, copy, memset) counts under the innermost ``repro_torch.*``
    span whose host interval holds its launch (tied by the correlation
    id), or under "(none)" when no span holds it."""
    spans, launches, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, corr = e.get("cat", ""), (e.get("args") or {}).get("correlation")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and e["name"].startswith("repro_torch."):
            spans.append((ts, ts + dur, e["name"]))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat in DEVICE_CATS:
            ops.append((corr, dur))
    spans.sort()
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = {}
    for corr, dur in ops:
        t = launches.get(corr)
        name = "(none)"
        if t is not None:
            # The latest-started span that still holds t is the innermost.
            for s, e, n in reversed(spans[:bisect.bisect_right(starts, t)]):
                if t <= e:
                    name = n
                    break
        out[name] = out.get(name, 0.0) + dur / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as published)")
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--train", action="store_true",
                    help="profile one full-width training step instead")
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    cfg = get_config(args.arch)
    if args.n_layers:
        print(f"[profile] {cfg.name}: depth cut from {cfg.n_layers} to "
              f"{args.n_layers} layers, widths as published")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.train:
        model = init_model(cfg, 0, device=dev)
        settings = steps.TrainSettings(
            remat="full", opt=AdamWConfig(lr=1e-3, weight_decay=0.01),
            warmup=2, stable=10**6, decay=1)
        opt = adamw_init(dict(model.named_parameters()), settings.opt)
        step_fn = steps.make_train_step(cfg, settings)
        data = make_pipeline(DataConfig(batch=1, seq_len=4096,
                                        vocab_size=cfg.vocab_size))

        def run(i):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
            step_fn(model, opt, b, i + 1)
    else:
        model = init_model(cfg, 0, dtype=torch.bfloat16, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                                device=dev)
        scfg = ServeConfig(max_new_tokens=32, max_len=512)

        def run(i):
            generate(cfg, model, prompts, scfg, device=dev)
    run(0)                                                     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(kernels)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    what = "train" if args.train else "serve"
    (out / f"{what}_profile.txt").write_text(table)
    trace = out / f"{what}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "what": "train step" if args.train else "served wave",
        "n_layers": cfg.n_layers, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "kernel_launches": len(kernels),
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
        "span_device_ms": span_device_ms(events)}))


if __name__ == "__main__":
    main()
