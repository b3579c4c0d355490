"""The port's spans and counters (``repro_torch.obs``) on the CPU, on the
small stand-ins of the benchmark's two configurations
(``perfbench/tests/tiny.py``: Jamba with attention, mamba and MoE layers;
MiniCPM with attention and dense FFNs).

Off, no span enters ``record_function`` and the served numbers are those
of a profiled run, bit for bit; on, the profiler's trace holds every span
of the model step, nested as the step nests them, and the MoE counters
equal counts made here from the router's choices."""
import json

import pytest
import torch

from perfbench import registry
from perfbench.tests import tiny
from perfbench.trace import Trace
from repro_torch import obs
from repro_torch.launch.profile import span_device_ms
from repro_torch.models import lm, moe

CELLS = sorted(tiny.CELLS)
B, S, STEPS = 2, 12, 2
MIXER = {"attn": "attn", "attn_local": "attn", "mamba": "mamba",
         "mlstm": "mlstm", "slstm": "slstm"}
MOE_CHILDREN = ["repro_torch.moe.route", "repro_torch.moe.dispatch",
                "repro_torch.moe.experts", "repro_torch.moe.combine"]


def built(cell):
    cfg = tiny.config(cell)
    mc = registry.module("adapters", cfg["model_type"]).port_config(cfg)
    model = lm.init_model(mc, 3, device="cpu")
    model.requires_grad_(False)
    return mc, model


def prompt(mc, length=S, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, mc.vocab_size, (B, length), generator=gen)


def serve(model, tokens, steps=STEPS):
    """A prefill and ``steps`` greedy decode steps: (logits, cache)."""
    logits, cache, pos = model.prefill({"tokens": tokens}, tokens.shape[1]
                                       + steps)
    out = [logits]
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, cache = model.decode_step({"tokens": tok}, cache, pos + i)
        out.append(logits)
    return out, cache


def profiled(fn, path=None):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return result


def leaves(cache):
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from leaves(cache[k])
    else:
        yield cache


@pytest.mark.parametrize("cell", CELLS)
def test_off_no_span_enters_record_function(cell, monkeypatch):
    mc, model = built(cell)
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    serve(model, prompt(mc))
    assert entered == []
    profiled(lambda: serve(model, prompt(mc)))
    assert "repro_torch.decode_step" in entered


@pytest.mark.parametrize("cell", CELLS)
def test_profiling_leaves_the_numbers_bit_identical(cell):
    mc, model = built(cell)
    tokens = prompt(mc)
    off_logits, off_cache = serve(model, tokens)
    on_logits, on_cache = profiled(lambda: serve(model, tokens))
    for a, b in zip(off_logits, on_logits):
        assert torch.equal(a, b)
    pairs = list(zip(leaves(off_cache), leaves(on_cache)))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)


def inside(m, outer):
    return outer.start <= m.start and m.end <= outer.end


@pytest.mark.parametrize("cell", CELLS)
def test_the_trace_holds_every_span_nested(cell, tmp_path):
    mc, model = built(cell)
    path = tmp_path / "trace.json"
    profiled(lambda: serve(model, prompt(mc)), path)
    marks = Trace.load(str(path)).marks
    steps = [m for m in marks
             if m.name in ("repro_torch.prefill", "repro_torch.decode_step")]
    assert [m.name for m in steps] == \
        ["repro_torch.prefill"] + ["repro_torch.decode_step"] * STEPS
    ours = [m for m in marks if m.name.startswith("repro_torch.")]
    assert all(any(inside(m, s) for s in steps) for m in ours)
    kinds = [MIXER[k] for k in mc.full_pattern]
    n_moe = sum(lm.layer_is_moe(mc, li) for li in range(mc.n_layers))
    n_ffn = sum("ffn" in model.layers[li] and not lm.layer_is_moe(mc, li)
                for li in range(mc.n_layers))
    assert (n_moe > 0) == (cell == "jamba-prefill")
    for s in steps:
        mine = [m for m in ours if inside(m, s) and m is not s]
        names = [m.name for m in mine]
        for kind in set(kinds):
            assert names.count(f"repro_torch.{kind}") == kinds.count(kind)
        assert names.count("repro_torch.ffn") == n_ffn
        assert names.count("repro_torch.embed") == 1
        assert names.count("repro_torch.head") == 1
        layers = [m for m in mine if m.name == "repro_torch.moe"]
        assert len(layers) == n_moe
        for layer in layers:
            kids = [m.name for m in mine if m.name in MOE_CHILDREN
                    and inside(m, layer)]
            assert kids == MOE_CHILDREN
        assert names.count("repro_torch.moe.route") == n_moe


def expected_counts(calls, mc):
    """(assignments, slots, kept) from the router's ids of each call: an
    expert keeps its first ``capacity`` assignments."""
    k, e = mc.experts_per_token, mc.n_experts
    total = [0, 0, 0]
    for ids in calls:
        t = ids.shape[0]
        cap = max(k, int(mc.capacity_factor * t * k / e))
        load = torch.bincount(ids.reshape(-1), minlength=e)
        total[0] += t * k
        total[1] += e * cap
        total[2] += int(load.clamp(max=cap).sum())
    return dict(zip(("moe.assignments", "moe.slots", "moe.kept"), total))


@pytest.mark.parametrize("cell", CELLS)
def test_moe_counters_equal_the_routers_choices(cell, monkeypatch):
    mc, model = built(cell)
    calls = {"prefill": [], "decode_step": []}
    route = moe._route

    def recording(cfg, router_w, x):
        gates, ids, aux = route(cfg, router_w, x)
        calls["prefill" if x.shape[0] > B else "decode_step"].append(ids)
        return gates, ids, aux

    monkeypatch.setattr(moe, "_route", recording)
    serve(model, prompt(mc))                # unprofiled: clears the last
    for v in calls.values():
        v.clear()
    profiled(lambda: serve(model, prompt(mc, seed=1)))
    got = obs.counters()
    if cell != "jamba-prefill":
        assert got == {} and calls == {"prefill": [], "decode_step": []}
        return
    for kind in calls:
        assert got[kind] == expected_counts(calls[kind], mc)
    assert got["prefill"]["moe.kept"] < got["prefill"]["moe.assignments"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_profiled_session_reports_its_own_counts(cell):
    mc, model = built(cell)
    n_moe = sum(lm.layer_is_moe(mc, li) for li in range(mc.n_layers))
    k = mc.experts_per_token
    for length in (S, S + 8):
        serve(model, prompt(mc), steps=1)   # unprofiled, between sessions
        profiled(lambda: serve(model, prompt(mc, length), steps=1))
        got = obs.counters()
        if not n_moe:
            assert got == {}
        else:
            assert got["prefill"]["moe.assignments"] == n_moe * B * length * k
            assert got["decode_step"]["moe.assignments"] == n_moe * B * k


def test_counts_sum_on_the_device_and_read_once():
    with obs.step("decode_step"):           # unprofiled: clears the last
        obs.count("x", 5)                   # off: nothing is counted
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.step("decode_step", B=1, S=1, pos=0):
            obs.count("hosts", 3)
            obs.count("hosts", 4)
            obs.count("kept", torch.tensor([True, False, True]))
            obs.count("kept", torch.tensor(5))
        obs.count("outside", 1)
    assert obs.counters() == {"decode_step": {"hosts": 7, "kept": 7},
                              obs.NO_STEP: {"outside": 1}}
    assert obs.counters() == obs.counters()     # reading changes nothing


def test_the_profiler_flag_follows_a_session():
    """``obs.on`` reads the flag torch flips at each profiler start and
    stop; a torch without it fails here."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert not obs.on()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert obs.on()
        assert obs.span("x") is not obs.OFF
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert obs.span("x") is obs.OFF


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_device_ms_takes_the_innermost_span():
    events = [ev("repro_torch.decode_step", "user_annotation", 0, 100),
              ev("repro_torch.attn", "user_annotation", 10, 20),
              ev("repro_torch.moe", "user_annotation", 40, 40),
              ev("repro_torch.moe.experts", "user_annotation", 50, 10),
              ev("perfbench.decode_step", "user_annotation", 0, 120),
              ev("cudaLaunchKernel", "cuda_runtime", 15, 1, corr=1),
              ev("cudaLaunchKernel", "cuda_runtime", 55, 1, corr=2),
              ev("cudaLaunchKernel", "cuda_runtime", 70, 1, corr=3),
              ev("cudaLaunchKernel", "cuda_runtime", 90, 1, corr=4),
              ev("cudaMemcpyAsync", "cuda_runtime", 110, 1, corr=5),
              ev("k1", "kernel", 200, 1000, corr=1),
              ev("k2", "kernel", 1300, 3000, corr=2),
              ev("k3", "kernel", 4400, 500, corr=3),
              ev("k4", "kernel", 5000, 250, corr=4),
              ev("copy", "gpu_memcpy", 5300, 2000, corr=5)]
    got = span_device_ms(json.loads(json.dumps(events)))
    assert got == {"repro_torch.attn": 1.0, "repro_torch.moe.experts": 3.0,
                   "repro_torch.moe": 0.5, "repro_torch.decode_step": 0.25,
                   "(none)": 2.0}
