"""One run of one cell: set-up, the measured window, the metrics, then the
check against the reference.

Set-up builds the port's model (``repro_torch.models.lm.LM``, bf16) from
the configuration (``adapters/<model_type>.py``), draws every weight on
the device from the seed (``weights``), builds the kernels the model runs
into the checkout's ``build/kernels`` (only a first run compiles), and
serves one warm wave at the traffic's largest sizes.  The window then
drives the traffic's driver for ``seconds``.  With ``trace``, one slice of
the window is profiled and the per-layer metrics are read from it.  After
the window the peak memory is read, the port's state is freed, and the
reference checks the served tokens.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import check, registry, stats, weights
from perfbench.reference import decoder, precision
from perfbench.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


@dataclass
class RunView:
    """What a per-layer metric reader reads."""
    trace: object
    traced_wave: object
    waves: list
    t_start: float
    t_end: float
    plan: object
    batch: int


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def metric_entries(bench: dict, key: str, cell: str) -> List[dict]:
    """The entries of ``bench[key]`` that this cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is None and key == "per_layer":
            cells = e2e[m["moves"]].get("workloads")
        if cells is None or cell in cells:
            out.append(m)
    return out


def breakdown(trace) -> Dict[str, list]:
    """The device ops that took most time, and the longest idle stretches
    by what the host was doing when the op that ended each was launched,
    each summed by name, ten of each, in seconds."""
    ops: Dict[str, float] = {}
    for o in trace.device:
        ops[o.name] = ops.get(o.name, 0.0) + o.dur / 1e6
    idle: Dict[str, float] = {}
    for us, op in trace.gaps():
        label = "slice end" if op is None else \
            trace.host_at(op.launch) if op.launch is not None else "unknown"
        idle[label] = idle.get(label, 0.0) + us / 1e6
    top = lambda d: [[k[:120], v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: Optional[float] = None,
             repo: Path = registry.REPO, root: Path = registry.HERE,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None,
             patch: Optional[Callable] = None, control: bool = False,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Run ``cell`` once; returns the result line's object.  ``config``,
    ``traffic`` and ``limits`` replace the cell's files (the tests' small
    stand-ins), ``patch(model)`` breaks the port underneath (the tests'
    faults), and ``control`` also reads the float8 control."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = registry.benchmark(repo)
    wl = registry.workload(cell, repo)
    cfg = config or registry.data("configs", wl["config"], root)
    traffic = traffic or registry.data("traffic", wl["traffic"], root)
    limits = limits or registry.data("limits", cell, root)
    plan = registry.module("models", cfg["model_type"], root).plan(cfg)
    adapter = registry.module("adapters", cfg["model_type"], root)
    driver = registry.module("drivers", traffic["driver"], root)
    dev = torch.device(device)

    # -- set-up ----------------------------------------------------------
    from repro_torch.models.lm import LM
    build_s = 0.0
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        build_s = _build.build_all(adapter.KERNELS)
        torch.cuda.reset_peak_memory_stats(dev)
    model = LM(adapter.port_config(cfg), dtype=plan.dtype, device=dev)
    model.requires_grad_(False)
    weights.fill(dict(model.named_parameters()),
                 decoder.schema(plan), seed)
    if patch is not None:
        patch(model)
    vocab = plan.dims["vocab"]
    server = driver.Server(model, traffic, vocab, dev)
    tracer = Tracer() if trace else None
    if tracer is not None:
        tracer.warm()
    driver.warm(server, traffic, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    # -- the window -----------------------------------------------------
    waves, t_start, t_end = driver.run(server, traffic, seed, seconds,
                                       tracer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    e2e = stats.serving(waves, t_start, t_end, traffic["batch"])
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[perfbench] {cell} seed {seed}: set-up {setup_s:.3f} s (build "
        f"{build_s:.3f} s), {len(waves)} waves, {e2e['requests']} "
        f"requests, {e2e['gaps']} gaps in {seconds} s, peak "
        f"{peak / 1e9:.3f} GB")

    metrics: Dict[str, dict] = {}
    result: Dict[str, object] = {}
    if trace:
        t_trace = time.perf_counter()
        tr = tracer.trace()
        traced = next((w for w in waves if w.traced is not None), None)
        view = RunView(tr, traced, waves, t_start, t_end, plan,
                       traffic["batch"])
        for m in metric_entries(bench, "per_layer", cell):
            v = registry.module("metrics", m["name"], root).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            else:
                log(f"[perfbench] {m['name']}: nothing to read")
        busy_s = window_s = 0.0
        if tr is not None and tr.span[1] > tr.span[0]:
            busy_s, window_s = tr.busy() / 1e6, (tr.span[1] - tr.span[0]) / 1e6
            result["breakdown"] = breakdown(tr)
        log(f"[perfbench] trace read in {time.perf_counter() - t_trace:.3f} "
            f"s, {len(tr.device) if tr else 0} device ops")
    else:
        for m in metric_entries(bench, "end_to_end", cell):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # -- the check --------------------------------------------------------
    del model, server
    gc.collect()        # a planted fault ties the model into a cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    precision.exact()
    readings = check.compare(
        waves, traffic, seed, plan,
        lambda w: driver.prompts(traffic, seed, w.index, w.prompt_len,
                                 vocab), dev, control=control)
    correct, compared = check.judged(readings.get("program"), limits)
    reference_s = time.perf_counter() - t_ref
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=busy_s, window_s=window_s)
    result.update({
        "correct": correct,
        # Every request submitted in the window; none fails on its own (an
        # error ends the run), and a wave cut at the window's end is not
        # a failure.
        "attempted": traffic["batch"] * len(waves), "failed": 0,
        "metrics": metrics, "device": device_info,
        "build_s": build_s, "reference_s": reference_s,
        "waves": len(waves), "readings": readings,
        "compared": compared})
    for line in check.readings_text(compared):
        log(line)
    return result
