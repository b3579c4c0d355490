"""The per-layer metrics that read the port's own spans and counters
(``repro_torch.obs``): each against a value computed by hand from a
hand-built trace (``user_annotation`` spans, ``cuda_runtime`` launches and
``kernel`` events tied by correlation ids) or from stubbed counters, each
None when what it reads is missing; then a small Jamba served on the CPU
through the harness, whose counter metrics come back with values."""
import sys

import pytest

from perfbench import harness, registry
from perfbench.drivers.waves import Wave
from perfbench.tests import tiny
from perfbench.trace import Trace

B, P = 2, 10            # batch, prompt tokens of the traced wave

# (span name, start, end) on the host; launches (correlation id, host
# time) and each op's device microseconds.
SPANS = [("perfbench.slice", 0, 10000),
         ("repro_torch.prefill", 100, 3000),
         ("repro_torch.mamba", 200, 400),
         ("repro_torch.moe", 500, 1500),
         ("repro_torch.moe.route", 520, 600),
         ("repro_torch.moe.dispatch", 620, 800),
         ("repro_torch.obs", 700, 750),
         ("repro_torch.moe.experts", 900, 1100),
         ("repro_torch.moe.combine", 1200, 1400),
         ("repro_torch.mamba", 1600, 1800),
         ("repro_torch.decode_step", 4000, 5000),
         ("repro_torch.obs", 4300, 4400),
         ("repro_torch.mamba", 4500, 4600),
         ("repro_torch.decode_step", 6000, 7000)]
LAUNCHES = {1: 250, 2: 300, 3: 550, 4: 650, 5: 720, 6: 950, 7: 1000,
            8: 1250, 9: 1700, 10: 4100, 11: 4200, 12: 4350, 13: 4550,
            14: 6100, 15: 6200, 16: 6300, 17: 2000}
DUR = {c: 10.0 * c for c in LAUNCHES}


def events(spans=SPANS):
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
            "dur": e - s} for n, s, e in spans]
    for corr, t in LAUNCHES.items():
        out.append({"ph": "X", "cat": "cuda_runtime", "name":
                    "cudaLaunchKernel", "ts": t, "dur": 5,
                    "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                    "ts": 8000 + 100 * corr, "dur": DUR[corr],
                    "args": {"correlation": corr}})
    return out


def view(trace, traced=(0, -1)):
    wave = Wave(0, P, 3, traced=traced)
    return harness.RunView(trace, wave, [wave], 0.0, 1.0, None, B)


def read(name, run):
    return registry.module("metrics", name).read(run)


TRACED = {
    # steps: ops 10, 11, 13 (12 counts) and 14, 15, 16
    "launches_per_step.decode": 3.0,
    # the prefill's two mamba spans: ops 1, 2, 9 (13 is a decode step's)
    "mamba_us_per_token.prefill": (DUR[1] + DUR[2] + DUR[9]) / (B * P),
    # route 3, dispatch 4 (5 counts), combine 8; experts 6 and 7 left out
    "moe_glue_us_per_token.prefill": (DUR[3] + DUR[4] + DUR[8]) / (B * P),
}


@pytest.mark.parametrize("name", sorted(TRACED))
def test_a_span_metric_reads_its_spans(name):
    got = read(name, view(Trace.from_events(events())))
    assert got == pytest.approx(TRACED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(TRACED))
def test_a_span_metric_without_its_spans_reads_nothing(name):
    harness_only = [s for s in SPANS if not s[0].startswith("repro_torch.")]
    assert read(name, view(Trace.from_events(events(harness_only)))) is None
    assert read(name, view(None)) is None


@pytest.mark.parametrize("name", ["mamba_us_per_token.prefill",
                                  "moe_glue_us_per_token.prefill"])
def test_a_prefill_metric_needs_the_prefill_traced(name):
    assert read(name, view(Trace.from_events(events()), (5, -1))) is None


COUNTS = {"prefill": {"moe.assignments": 400, "moe.slots": 500,
                      "moe.kept": 360},
          "decode_step": {"moe.assignments": 64, "moe.slots": 64,
                          "moe.kept": 60}}
COUNTED = {"moe_capacity_use.prefill": 72.0,
           "moe_dropped_share.prefill": 10.0,
           "moe_dropped_share.decode": 6.25}


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import obs
    box = {"value": COUNTS}
    monkeypatch.setattr(obs, "counters", lambda: box["value"])
    return box


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_a_counter_metric_reads_the_ports_counters(name, counters):
    assert read(name, view(None)) == pytest.approx(COUNTED[name])


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_a_counter_metric_without_counts_reads_nothing(name, counters,
                                                       monkeypatch):
    counters["value"] = {}
    assert read(name, view(None)) is None
    counters["value"] = COUNTS
    run = view(None)
    run.traced_wave = None
    assert read(name, run) is None
    import repro_torch                  # a port without counters:
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert read(name, view(None)) is None


def test_a_traced_tiny_jamba_reads_its_counters():
    cell = "jamba-prefill"
    cfg = tiny.config(cell)
    out = harness.run_cell(cell, 2 ** 31 + 21, 0.5, True, device="cpu",
                           config=cfg, traffic=tiny.traffic(cell),
                           log=lambda s: None)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in COUNTED:
        assert name in m, name
        assert 0.0 <= m[name] <= 100.0
    assert m["moe_capacity_use.prefill"] <= 100.0 / cfg["capacity_factor"]
