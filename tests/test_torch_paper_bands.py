"""Twin of ``tests/test_paper_bands.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Paper-claim band tests: each benchmark's headline number must stay inside
the band the paper reports (EXPERIMENTS.md §Paper-validation).

Shorter horizons than benchmarks/ for CI speed; bands are correspondingly
loose but still falsifiable.
"""
import pytest

from repro_torch.core import (AZURE_BLOB, AZURE_BLOB_SEPARATE_ACL, AZURE_REDIS,
                              SLOW_REDIS)
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench

HORIZON = 500.0


def ycsb(theta=0.0, keys=10_000, read_ratio=0.5):
    return lambda nodes, seed: YCSBWorkload(
        nodes, theta=theta, keys_per_partition=keys, read_ratio=read_ratio,
        seed=seed)


def bench(proto, model, wl=None, elr=False, n=4):
    return run_bench(wl or ycsb(), model,
                     BenchConfig(protocol=proto, n_nodes=n,
                                 horizon_ms=HORIZON, elr=elr, seed=9))


def speedup(model, wl=None):
    c = bench("cornus", model, wl)
    t = bench("2pc", model, wl)
    assert c.commits > 50 and t.commits > 50
    return t.avg_latency_ms / c.avg_latency_ms


def test_fig5_speedup_band():
    """Blob speedup in (1.2, 1.9]; Redis smaller but > 1.05."""
    assert 1.2 < speedup(AZURE_BLOB) < 1.95
    assert 1.05 < speedup(AZURE_REDIS) < 1.5


def test_fig5_separate_acl_no_gain():
    s = speedup(AZURE_BLOB_SEPARATE_ACL)
    assert 0.9 < s < 1.15, f"separate-ACL blob should show ~no gain, got {s}"


def test_fig6_readonly_monotone():
    lo = speedup(AZURE_BLOB, ycsb(read_ratio=0.5))            # ~0% RO txns
    hi = speedup(AZURE_BLOB, ycsb(read_ratio=0.8 ** (1 / 16)))  # ~80% RO
    assert lo > hi - 0.05, (lo, hi)
    assert lo > 1.2


def test_fig7_contention_shrinks_gain():
    lo = speedup(AZURE_REDIS, ycsb(theta=0.0, keys=1000))
    hi = speedup(AZURE_REDIS, ycsb(theta=0.9, keys=1000))
    assert hi < lo + 0.05, (lo, hi)
    assert 0.9 < hi < 1.3   # abort-dominated regime: gap nearly closes


def test_fig10_cl_ordering():
    """cornus < CL < 2PC on slow storage."""
    r = {p: run_bench(ycsb(), SLOW_REDIS,
                      BenchConfig(protocol=p, n_nodes=4, horizon_ms=6000.0,
                                  seed=9))
         for p in ("cornus", "cl", "2pc")}
    assert r["cornus"].avg_latency_ms < r["cl"].avg_latency_ms \
        < r["2pc"].avg_latency_ms


def test_fig9_elr():
    cfgs = dict(wl=ycsb(theta=0.9, keys=100))
    base = run_bench(cfgs["wl"], AZURE_REDIS,
                     BenchConfig(protocol="cornus", n_nodes=4,
                                 horizon_ms=800.0, seed=5))
    elr = run_bench(cfgs["wl"], AZURE_REDIS,
                    BenchConfig(protocol="cornus", n_nodes=4,
                                horizon_ms=800.0, seed=5, elr=True))
    assert elr.throughput_tps > base.throughput_tps * 1.02


def test_fig8_bounded_termination():
    from repro_torch.core import (Cluster, ProtocolConfig, Sim, SimStorage,
                                  TxnSpec)
    sim = Sim()
    nodes = [f"n{i}" for i in range(8)]
    cl = Cluster(sim, SimStorage(sim, AZURE_REDIS, seed=1), nodes,
                 ProtocolConfig(protocol="cornus"))
    cl.fail("n0", 1.0)
    cl.run_txn(TxnSpec(txn_id="t", coordinator="n0", participants=nodes))
    sim.run(until=60_000)
    times = [o.termination_ms for o in cl.outcomes.values()
             if o.ran_termination and o.termination_ms > 0]
    assert times, "termination protocol never ran"
    assert max(times) < 25.0, f"unbounded-looking termination: {max(times)}"


def test_table3_rtt_model():
    from repro_torch.core import rtt_table
    want = {"2pc": 5.0, "cornus": 3.0, "cornus-opt1": 2.5, "2pc-coloc": 3.0,
            "cornus-coloc": 2.0, "paxos-commit": 1.5}
    got = {k: v["total"] for k, v in rtt_table().items()}
    assert got == want
