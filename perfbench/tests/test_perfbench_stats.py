"""The end-to-end arithmetic: every token, request and gap of the window
counts, and one stalled gap or one slow first token moves the tail."""
import itertools

import pytest
import torch

from perfbench import registry, stats

waves_mod = registry.module("drivers", "waves")


def wave(start, arrivals, i=0):
    w = waves_mod.Wave(i, 8, len(arrivals), start=start)
    w.arrivals = list(arrivals)
    return w


def steady():
    # two waves of 10 tokens, 10 ms apart, the second after the first
    a = [wave(0.0, [0.05 + 0.01 * k for k in range(10)])]
    a.append(wave(0.14, [0.2 + 0.01 * k for k in range(10)], 1))
    return a


def test_counts_every_token_in_the_window():
    out = stats.serving(steady(), 0.0, 1.0, 4)
    assert out["output_tokens_per_s"] == 4 * 20 / 1.0
    assert out["requests"] == 8 and out["gaps"] == 4 * 18
    assert out["ttft_p95_ms"] == pytest.approx(60.0)
    assert out["tpot_p95_ms"] == pytest.approx(10.0)


def test_tokens_after_the_window_do_not_count():
    out = stats.serving(steady(), 0.0, 0.205, 4)
    assert out["output_tokens_per_s"] == pytest.approx(4 * 11 / 0.205)
    assert out["requests"] == 8 and out["gaps"] == 4 * 9


def test_one_stalled_gap_moves_the_tail():
    base = stats.serving(steady(), 0.0, 1.0, 4)["tpot_p95_ms"]
    ws = steady()
    ws[1].arrivals[5:] = [t + 0.2 for t in ws[1].arrivals[5:]]
    out = stats.serving(ws, 0.0, 1.0, 4)
    assert out["tpot_p95_ms"] > base
    assert out["output_tokens_per_s"] == 80.0


def test_one_slow_first_token_moves_the_ttft_tail():
    base = stats.serving(steady(), 0.0, 1.0, 4)["ttft_p95_ms"]
    ws = steady()
    ws[1].arrivals = [t + 0.5 for t in ws[1].arrivals]
    assert stats.serving(ws, 0.0, 1.0, 4)["ttft_p95_ms"] > base + 100


def test_percentile():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)


def test_schedule_serves_every_size_in_each_block():
    """The order of sizes is fixed (no seed enters it): each block serves
    every prompt level and every new-token level once, the first wave is
    the largest, and ``levels`` blocks hold every pair once."""
    tr = registry.data("traffic", "conversation-b64")
    k = tr["levels"]
    ps, ns = waves_mod.levels(tr["prompt"], k), \
        waves_mod.levels(tr["new_tokens"], k)
    it = waves_mod.schedule(tr)
    blocks = [[next(it) for _ in range(k)] for _ in range(k)]
    for block in blocks:
        assert sorted(p for p, _ in block) == ps
        assert sorted(n for _, n in block) == ns
    assert blocks[0][0] == (max(ps), max(ns))
    assert len({w for b in blocks for w in b}) == k * k
    assert list(itertools.islice(waves_mod.schedule(tr), k * k)) == \
        [w for b in blocks for w in b]
    assert ps == [512, 832, 1280, 2048] and ns == [64, 102, 161, 256]
    assert waves_mod.max_len(tr) == 2304


@pytest.mark.parametrize("spec,n,span", [
    ({"prefill": True, "decode_steps": None}, 16, (0, -1)),
    ({"prefill": False, "decode_steps": 32}, 256, (1, 32)),
    ({"prefill": False, "decode_steps": 32, "at_end": True}, 256, (224, -1)),
    ({"prefill": False, "decode_steps": 32, "at_end": True}, 20, (1, -1)),
])
def test_traced_span(spec, n, span):
    assert waves_mod.traced_span(spec, n) == span


def test_worst_wave_reads_a_fault_confined_to_one_wave():
    """Jamba's limits: a wave whose every token lies 1.0 below the
    reference's best, beside a sound wave at 0.2, keeps the mean gap
    under its limit and fails the worst wave's."""
    from perfbench import check
    limits = registry.data("limits", "jamba-prefill")
    V = 5
    parts = []
    for gap in (0.2, 1.0):
        ref = torch.zeros(8, 16, V)
        ref[..., 0] = gap
        chosen = torch.ones(8, 16, dtype=torch.long)
        parts.append((check.gaps(ref, chosen), ref, chosen))
    got = check.summary(parts)
    assert got["mean_gap"] == pytest.approx(0.6)
    assert got["worst_wave_mean_gap"] == pytest.approx(1.0)
    ok, compared = check.judged(got, limits)
    assert not ok
    assert compared["mean_gap"]["value"] <= compared["mean_gap"]["limit"]
