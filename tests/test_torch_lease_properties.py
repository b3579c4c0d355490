"""Twin of ``tests/test_lease_properties.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Property-based tests of lease semantics under failover schedules.

Hypothesis drives random replica fail/recover schedules, lease terms, and
batch windows through the deterministic sim and asserts the lease layer's
contract: batched and unbatched runs reach identical commit/abort
decisions, AC1-AC3 hold whatever the failover/lease-expiry interleaving,
every slot decides exactly once, and exactly one leaseholder serves
fast-path ops per epoch.
"""
from __future__ import annotations

import pytest

from conftest import hypothesis_or_stubs

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

from repro_torch.core import (AZURE_REDIS, BatchConfig, Cluster, Decision,
                              ProtocolConfig, ReplicatedSimStorage, Sim,
                              TxnSpec, Vote)

HORIZON = 500_000.0

# One replica outage with guaranteed recovery: quorum returns eventually,
# so every run terminates and decisions are vote-determined (the executor
# timeouts are set far above any outage + lease-renewal stall).
outage = st.tuples(st.integers(0, 2), st.floats(0.0, 60.0),
                   st.floats(60.0, 400.0))


def run_cluster(n, votes_yes, seed, window_ms, fails, lease_ms,
                protocol="cornus"):
    sim = Sim()
    batch = BatchConfig(window_ms=window_ms, serial=window_ms > 0)
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3,
                                   seed=seed, batch=batch,
                                   lease_ms=lease_ms)
    for idx, at, rec in fails:
        storage.fail_replica(idx, at, rec)
    nodes = [f"n{i}" for i in range(n)]
    tmo = 5_000.0
    cluster = Cluster(sim, storage, nodes,
                      ProtocolConfig(protocol=protocol,
                                     vote_timeout_ms=tmo,
                                     decision_timeout_ms=tmo,
                                     votereq_timeout_ms=tmo,
                                     termination_retry_ms=tmo,
                                     coop_retry_ms=tmo))
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes,
                   votes={nd: v for nd, v in zip(nodes, votes_yes)})
    cluster.run_txn(spec)
    sim.run(until=HORIZON)
    decisions = {node: s["decision"]
                 for (node, t), s in cluster.local.items()
                 if t == "t" and s["decision"] is not None}
    return decisions, storage


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 5).flatmap(lambda n: st.tuples(
    st.just(n),
    st.lists(st.booleans(), min_size=n, max_size=n),
    st.integers(0, 10_000),
    st.floats(0.1, 5.0),
    st.lists(outage, max_size=2),
    st.sampled_from([20.0, 80.0, 200.0]),
)))
def test_batched_equals_unbatched_decisions_under_failover(params):
    """Across random failover + lease-expiry schedules (with generous
    protocol timeouts so outages stall ops rather than abort txns):
    window=0 and window=w runs reach IDENTICAL per-node decisions, and
    both satisfy AC1-AC3."""
    n, votes, seed, window, fails, lease_ms = params
    d0, _ = run_cluster(n, votes, seed, 0.0, fails, lease_ms)
    d1, _ = run_cluster(n, votes, seed, window, fails, lease_ms)
    assert d0 == d1, (d0, d1)
    for d in (d0, d1):
        assert len(set(d.values())) <= 1, f"split brain: {d}"
        if not all(votes):
            assert Decision.COMMIT not in d.values()
        else:
            assert set(d.values()) <= {Decision.COMMIT}


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000),
       st.lists(outage, max_size=3),
       st.floats(0.0, 5.0),
       st.sampled_from([15.0, 60.0, 200.0]),
       st.lists(st.floats(0.0, 100.0), min_size=2, max_size=8))
def test_single_winner_per_slot_across_epochs(seed, fails, window,
                                              lease_ms, delays):
    """Racing writers on one slot under random failover + lease-expiry
    schedules: every caller observes the SAME first value whatever epoch
    served it, and the merged replica state agrees."""
    sim = Sim()
    batch = BatchConfig(window_ms=window, serial=window > 0)
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3,
                                   seed=seed, batch=batch,
                                   lease_ms=lease_ms)
    for idx, at, rec in fails:
        storage.fail_replica(idx, at, rec)
    results = {}

    def proposer(name, value, delay):
        def gen():
            yield sim.timeout(delay)
            results[name] = yield storage.log_once("p0", "t", value,
                                                   writer=name)
        sim.process(gen())

    for w, delay in enumerate(delays):
        value = Vote.VOTE_YES if w % 2 == 0 else Vote.ABORT
        proposer(f"w{w}", value, delay)
    sim.run(until=HORIZON)
    assert len(results) == len(delays), results
    assert len(set(results.values())) == 1, results
    assert storage.snapshot().get(("p0", "t")) == \
        next(iter(results.values()))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000),
       st.lists(outage, max_size=3),
       st.sampled_from([15.0, 60.0, 200.0]),
       st.floats(0.0, 4.0))
def test_one_leaseholder_serves_fast_path_per_epoch(seed, fails, lease_ms,
                                                    window):
    """Observability invariant: epochs strictly increase and, per epoch,
    exactly one holder ever serves fast-path ops."""
    sim = Sim()
    batch = BatchConfig(window_ms=window, serial=window > 0)
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3,
                                   seed=seed, batch=batch,
                                   lease_ms=lease_ms)
    for idx, at, rec in fails:
        storage.fail_replica(idx, at, rec)

    def writers():
        for i in range(12):
            def gen(i=i):
                yield sim.timeout(i * 25.0)
                yield storage.log_once("p", f"t{i}", Vote.VOTE_YES,
                                       writer="p")
            sim.process(gen())

    writers()
    sim.run(until=HORIZON)
    epochs = [e for e, _h, _t in storage.lease_history]
    assert epochs == sorted(set(epochs)), epochs
    for epoch, by_holder in storage.fast_ops_by_epoch.items():
        assert len(by_holder) == 1, \
            f"epoch {epoch} served by {sorted(by_holder)}"


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
def test_hypothesis_is_exercising_failovers():
    """Meta-check: the strategies above include genuinely failing leaders
    (guards against silently degenerating to the no-failure path)."""
    d, storage = run_cluster(3, [True, True, True], 0, 2.0,
                             [(0, 0.0, 300.0)], 50.0)
    assert set(d.values()) == {Decision.COMMIT}
    assert storage.lease_acquisitions >= 1
