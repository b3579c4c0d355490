"""Twin of ``tests/test_txn_bench.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Sundial-like substrate sanity: locks, workloads, bench orderings."""
import random

import pytest

from conftest import hypothesis_or_stubs

from repro_torch.core.storage import AZURE_BLOB, AZURE_REDIS
from repro_torch.txn import (BenchConfig, LockMode, LockTable, TPCCWorkload,
                             YCSBWorkload, run_bench, zipf_sampler)

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()


def test_nowait_lock_semantics():
    lt = LockTable("p0")
    assert lt.try_lock("t1", "k", LockMode.SHARED)
    assert lt.try_lock("t2", "k", LockMode.SHARED)
    assert not lt.try_lock("t3", "k", LockMode.EXCLUSIVE)  # conflict -> abort
    assert not lt.try_lock("t1", "k", LockMode.EXCLUSIVE)  # upgrade blocked
    lt.release_all("t2")
    assert lt.try_lock("t1", "k", LockMode.EXCLUSIVE)      # upgrade ok now
    lt.release_all("t1")
    assert lt.try_lock("t3", "k", LockMode.EXCLUSIVE)


@settings(max_examples=20, deadline=None)
@given(st.floats(0.0, 0.99), st.integers(0, 999))
def test_zipf_sampler_in_range(theta, seed):
    rng = random.Random(seed)
    s = zipf_sampler(1000, theta, rng)
    xs = [s() for _ in range(500)]
    assert all(0 <= x < 1000 for x in xs)
    if theta > 0.8:  # strong skew concentrates on low ranks
        assert sum(1 for x in xs if x < 10) > len(xs) * 0.2


def test_ycsb_txn_shape():
    w = YCSBWorkload(["n0", "n1", "n2"], theta=0.5, seed=1)
    t = w.next_txn("n0")
    assert len(t.accesses) == 16
    assert set(t.participants) <= {"n0", "n1", "n2"}
    assert t.is_distributed  # 16 accesses over 3 nodes


def test_tpcc_txn_shape():
    w = TPCCWorkload(["n0", "n1"], n_warehouses=4, seed=2)
    kinds = set()
    for _ in range(50):
        t = w.next_txn("n0")
        kinds.add(t.txn_id.split("-")[1])
        assert len(t.accesses) >= 2
    assert kinds == {"payment", "neworder"}


def test_cornus_beats_2pc_on_latency():
    """Core claim (Fig 5): same workload, Cornus < 2PC caller latency."""
    results = {}
    for proto in ("cornus", "2pc"):
        cfg = BenchConfig(protocol=proto, n_nodes=4, horizon_ms=600.0, seed=11)
        r = run_bench(lambda nodes, seed: YCSBWorkload(nodes, seed=seed),
                      AZURE_BLOB, cfg)
        results[proto] = r
        assert r.commits > 100
    speedup = results["2pc"].avg_latency_ms / results["cornus"].avg_latency_ms
    assert 1.1 < speedup < 2.2, f"speedup {speedup:.2f} out of paper band"
    # Cornus's commit phase is (nearly) eliminated.
    assert results["cornus"].breakdown()["commit"] < 0.2
    assert results["2pc"].breakdown()["commit"] > 5.0


def test_elr_improves_high_contention_throughput():
    """Fig 9: speculative precommit (ELR) helps under contention."""
    outs = {}
    for elr in (False, True):
        cfg = BenchConfig(protocol="cornus", n_nodes=4, horizon_ms=600.0,
                          elr=elr, seed=5)
        r = run_bench(lambda nodes, seed: YCSBWorkload(
            nodes, theta=0.9, keys_per_partition=100, seed=seed),
            AZURE_REDIS, cfg)
        outs[elr] = r
    assert outs[True].throughput_tps > outs[False].throughput_tps * 1.05


def test_single_partition_fast_path():
    cfg = BenchConfig(protocol="cornus", n_nodes=1, horizon_ms=300.0)
    r = run_bench(lambda nodes, seed: YCSBWorkload(nodes, seed=seed),
                  AZURE_REDIS, cfg)
    # Single node => nothing distributed => no distributed-txn latencies.
    assert r.commits == 0 and r.latencies == []
