"""How far two fp32 evaluations of xlstm-125m part when they run free, and
what one mLSTM decode call of the kernel path costs the host.

    PYTHONPATH=src python -m repro_torch.launch.xlstm_probe [--device cpu]

For weight seeds 0 and 1 it prefills 4 random 256-token prompts and takes
8 greedy decode steps on each evaluation of the mLSTM cell:
  kernel      ``ops.mlstm`` (on the card ``mlstm_scan``; on the CPU it is
              the sequential recurrence, so this one is left out there)
  chunkwise   the plain chunkwise cell (the model's plain path)
  sequential  ``ref.mlstm_ref``, the sequential recurrence, in place of the
              chunkwise cell: no kernel anywhere
Every evaluation decodes the first one's greedy tokens.  For each pair it
prints one JSON line: the largest logit difference of every pass and the
greedy tokens that differ.  On the card it also prints the device
launches and host time of one ``ops.mlstm`` call at the decode shape, as
``blocks.mlstm_apply``'s kernel path makes it (C and the normalizer n
updated in place by ``mlstm_scan``).

chip_smoke.py bounds the kernel layer by layer; this script measures the
free-running gaps it does not bound.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve
from ..kernels import ops, ref
from ..models import blocks, init_model

SEEDS = (0, 1)
BATCH, PROMPT, STEPS, MAX_LEN = 4, 256, 8, 512


@contextlib.contextmanager
def evaluation(model, name):
    """Run the model's mLSTM layers through evaluation ``name``."""
    model.plain_kernels = name != "kernel"
    try:
        if name == "sequential":
            with mock.patch.object(blocks, "_mlstm_cell", ref.mlstm_ref):
                yield
        else:
            yield
    finally:
        model.plain_kernels = False


def free_run(model, prompts, names, steps):
    """Logits of every pass (prefill, then ``steps`` decode steps) under each
    evaluation; the decode steps take the first evaluation's greedy
    tokens."""
    vocab = model.cfg.vocab_size
    caches, passes = {}, [{}]
    for name in names:
        with evaluation(model, name):
            passes[0][name], caches[name], _ = model.prefill(
                {"tokens": prompts}, MAX_LEN)
    for t in range(steps):
        tok = passes[-1][names[0]][:, -1, :vocab].argmax(-1)[:, None]
        passes.append({})
        for name in names:
            with evaluation(model, name):
                passes[-1][name], caches[name] = model.decode_step(
                    {"tokens": tok}, caches[name], prompts.shape[1] + t)
    return passes


def gaps(passes, a, b, vocab):
    """Largest logit difference per pass, and greedy tokens that differ."""
    diffs = [float((p[a].float() - p[b].float()).abs().max()) for p in passes]
    differ = sum(int((p[a][:, -1, :vocab].argmax(-1)
                      != p[b][:, -1, :vocab].argmax(-1)).sum())
                 for p in passes)
    return {"pair": f"{a} vs {b}", "logit_max_abs_diff_per_pass": diffs,
            "max": max(diffs), "greedy_tokens_differ": differ,
            "greedy_tokens": len(passes) * passes[0][a].shape[0]}


def kernel_path_cost(dev, cfg, batch, calls=50):
    """Device launches and host microseconds of one mLSTM decode call of
    the kernel path (``ops.mlstm`` with C and n updated in place, one token),
    as each mLSTM layer makes per step."""
    H = cfg.n_heads
    hd = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = torch.randn((3, batch, 1, H, hd), generator=g, device=dev)
    i, f = torch.rand((2, batch, 1, H), generator=g, device=dev)
    c = torch.zeros((batch, H, hd, hd), device=dev)
    n = torch.zeros((batch, H, hd), device=dev)

    def call():
        ops.mlstm(q, k, v, i, f, c, n0=n, out=c, n_out=n)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    launches = sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    n_mlstm = sum(kind == "mlstm" for kind in cfg.full_pattern)
    return {"mlstm_decode_call_launches": launches,
            "mlstm_decode_call_us": host_us, "mlstm_layers": n_mlstm,
            "shape": f"q,k,v ({batch},1,{H},{hd})"}


def probe(cfg, dev, seeds=SEEDS, batch=BATCH, prompt=PROMPT, steps=STEPS):
    """One JSON line per weight seed and pair of evaluations; returns them."""
    names = ("kernel", "chunkwise", "sequential") if dev.type == "cuda" \
        else ("chunkwise", "sequential")
    results = []
    for seed in seeds:
        model = init_model(cfg, seed, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen, device=dev)
        passes = free_run(model, prompts, names, steps)
        for a, b in itertools.combinations(names, 2):
            res = {"arch": cfg.name, "weight_seed": seed,
                   "device": dev.type, "dtype": "float32",
                   **gaps(passes, a, b, cfg.vocab_size)}
            print(json.dumps(res), flush=True)
            results.append(res)
        del model
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config("xlstm-125m")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    probe(cfg, dev)
    if dev.type == "cuda":
        print(json.dumps(kernel_path_cost(dev, cfg, BATCH)))


if __name__ == "__main__":
    main()
