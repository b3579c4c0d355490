"""Twin of ``tests/test_elasticity_properties.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Property-based tests of elastic membership under chaos.

Hypothesis replays random join/leave/kill/lease-expiry schedules through
the deterministic sim and the threaded store and asserts the
reconfiguration contract: AC1-AC3 hold across config changes, every slot
decides exactly once whatever configs served it, scheduled changes all
install once quorum allows, and a removed replica's stale writes can
never be chosen (retired ids are never consulted again).
"""
from __future__ import annotations

import pytest

from conftest import hypothesis_or_stubs

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

from repro_torch.core import (AZURE_REDIS, BatchConfig, Cluster, Decision,
                              ProtocolConfig, ReplicatedSimStorage,
                              ReplicatedStore, Sim, TxnSpec, Vote)

HORIZON = 500_000.0

# One replica outage with guaranteed recovery (same shape as the lease
# property suite): quorum returns eventually, so every run terminates.
outage = st.tuples(st.integers(0, 2), st.floats(0.0, 60.0),
                   st.floats(60.0, 400.0))

# A live membership-change schedule: 1-2 changes to R in {3,4,5} at
# random times, possibly overlapping the outages (the store serializes
# changes and waits out total outages).
reconfig = st.tuples(st.floats(5.0, 300.0), st.integers(3, 5))


def expected_installs(schedule) -> int:
    """Changes that actually flip membership: the store serializes them in
    schedule order, and a change to the current R is a no-op."""
    cur, installs = 3, 0
    for _at, n in sorted(schedule, key=lambda c: c[0]):
        if n != cur:
            cur, installs = n, installs + 1
    return installs


def run_cluster(n, votes_yes, seed, window_ms, fails, lease_ms, changes,
                protocol="cornus"):
    sim = Sim()
    batch = BatchConfig(window_ms=window_ms, serial=window_ms > 0)
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3,
                                   seed=seed, batch=batch,
                                   lease_ms=lease_ms)
    for idx, at, rec in fails:
        storage.fail_replica(idx, at, rec)
    for at, n_new in changes:
        storage.schedule_reconfigure(at, n_new)
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


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 5).flatmap(lambda n: st.tuples(
    st.just(n),
    st.lists(st.booleans(), min_size=n, max_size=n),
    st.integers(0, 10_000),
    st.floats(0.0, 4.0),
    st.lists(outage, max_size=2),
    st.sampled_from([20.0, 80.0, 200.0]),
    st.lists(reconfig, min_size=1, max_size=2),
)))
def test_ac_invariants_hold_across_config_changes(params):
    """AC1-AC3 across random join/leave/kill/lease-expiry schedules: all
    nodes reach ONE decision, COMMIT only on unanimous YES, and every
    effective scheduled change installs (the schedule completes)."""
    n, votes, seed, window, fails, lease_ms, changes = params
    d, storage = run_cluster(n, votes, seed, window, fails, lease_ms,
                             changes)
    assert len(d) == n, f"undecided nodes: {d}"
    assert len(set(d.values())) == 1, f"split brain: {d}"
    if not all(votes):
        assert Decision.COMMIT not in d.values()
    else:
        assert set(d.values()) == {Decision.COMMIT}
    assert storage.reconfigurations == expected_installs(changes)
    for _started, cutover, installed, old_n, new_n in \
            storage.reconfig_history:
        assert installed >= cutover and old_n != new_n


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000),
       st.lists(outage, max_size=2),
       st.floats(0.0, 4.0),
       st.sampled_from([15.0, 60.0, 200.0]),
       st.lists(st.floats(0.0, 200.0), min_size=2, max_size=8),
       st.lists(reconfig, min_size=1, max_size=2))
def test_single_winner_per_slot_across_configs(seed, fails, window,
                                               lease_ms, delays, changes):
    """Racing writers on one slot while membership changes mid-race:
    every caller observes the SAME first value whatever config served it,
    and the merged member state agrees."""
    sim = Sim()
    batch = BatchConfig(window_ms=window, serial=window > 0)
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3,
                                   seed=seed, batch=batch,
                                   lease_ms=lease_ms)
    for idx, at, rec in fails:
        storage.fail_replica(idx, at, rec)
    for at, n_new in changes:
        storage.schedule_reconfigure(at, n_new)
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


# ---------------------------------------------------------------------------
# Threaded store: removed replicas and chaos schedules
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000),
       st.sampled_from([Vote.VOTE_YES, Vote.ABORT]),
       st.sampled_from([Vote.VOTE_YES, Vote.ABORT]),
       st.integers(2, 40))
def test_removed_replica_stale_writes_never_chosen(seed, chosen, stale,
                                                   stale_epoch):
    """Retire a replica, then poison its volume with arbitrarily
    high-ballot stale state: reads, re-proposals, snapshots, and a later
    joiner's state transfer must never surface the poisoned value —
    retired ids are simply never consulted again."""
    store = ReplicatedStore(n_replicas=3, seed=seed)
    assert store.log_once("p", "t1", chosen, writer="w") == chosen
    removed = max(store.membership.replica_ids)
    store.remove_replica(removed)
    assert removed not in store.membership.replica_ids
    # Poison the retired volume: a fabricated high-ballot acceptance and a
    # divergent decided slot.
    store.replicas[removed].accept(("p", "t1"), (stale_epoch, 1, removed),
                                   stale)
    store.replicas[removed].repair(("p", "t2"), stale, 1, True)
    # The chosen value survives on every path.
    assert store.log_once("p", "t1", stale, writer="w2") == chosen
    assert store.snapshot().get(("p", "t1")) == chosen
    assert ("p", "t2") not in store.snapshot()
    # A NEW joiner transfers state from members only: the poison does not
    # propagate, and the fresh id is never the retired one.
    new_id = store.add_replica()
    assert new_id != removed
    assert store.replicas[new_id].read(("p", "t2"))[0] is None
    assert store.log_once("p", "t1", stale, writer="w3") == chosen


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000),
       st.lists(st.sampled_from(["grow", "shrink", "kill", "revive",
                                 "write"]),
                min_size=4, max_size=14))
def test_threaded_chaos_schedule_keeps_decisions_stable(seed, ops):
    """Random interleavings of join/leave/kill/revive with first-write
    races: a decided slot's value never changes across any membership
    trajectory, and the final snapshot agrees with every return value."""
    store = ReplicatedStore(n_replicas=3, seed=seed)
    decided = {}
    killed = None
    k = 0
    for op in ops:
        m = store.membership.replica_ids
        if op == "grow" and store.n < 6:
            store.add_replica()
        elif op == "shrink" and store.n > 3:
            store.remove_replica(max(m))
        elif op == "kill" and killed is None and store.n >= 3:
            # Keep quorum: fail one member only.
            killed = max(m)
            store.fail_replica(killed)
        elif op == "revive" and killed is not None:
            if killed in store.membership.replica_ids:
                store.revive_replica(killed)
            else:
                store.recover_replica(killed)   # retired while dead
            killed = None
        elif op == "write":
            txn = f"t{k}"
            k += 1
            first = store.log_once("p", txn, Vote.VOTE_YES, writer="w")
            again = store.log_once("p", txn, Vote.ABORT, writer="w2")
            assert first == again == Vote.VOTE_YES
            decided[("p", txn)] = first
    if killed is not None and killed in store.membership.replica_ids:
        store.recover_replica(killed)
    snap = store.snapshot()
    for key, value in decided.items():
        assert snap.get(key) == value, (key, snap.get(key), value)


def test_lease_hands_over_across_reconfiguration():
    """The group-commit identity survives a config change: the holder's
    lease is reinstalled at the bump ballot, not silently dropped."""
    store = ReplicatedStore(n_replicas=3, seed=7)
    lease = store.acquire_lease("leader-0", duration_s=60.0)
    assert lease is not None
    store.set_replication(5, holder="leader-0")
    after = store.current_lease()
    assert after is not None and after.holder == "leader-0"
    assert after.epoch > lease.epoch
    assert store.n == 5
    assert store.log_once("p", "tx", Vote.VOTE_YES,
                          writer="leader-0") == Vote.VOTE_YES


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
def test_hypothesis_is_exercising_reconfigurations():
    """Meta-check: the strategies above genuinely install config changes
    mid-run (guards against degenerating to the fixed-membership path)."""
    d, storage = run_cluster(3, [True, True, True], 0, 2.0,
                             [(0, 0.0, 300.0)], 50.0,
                             [(10.0, 5), (150.0, 3)])
    assert set(d.values()) == {Decision.COMMIT}
    assert storage.reconfigurations == 2
    assert [(o, n) for (_s, _c, _i, o, n)
            in storage.reconfig_history] == [(3, 5), (5, 3)]
