"""Twin of ``tests/test_leases.py`` on the port's modules (``repro_torch.core``
/ ``repro_torch.txn``): the same assertions on the same seeds.

Leader leases & epoch ballots: the post-failover phase-1-free fast path.

A new leader acquires an epoch lease with ONE bulk prepare round and then
serves every slot with owner-ballot single accepts (batched flushes
included), so a replica outage no longer degrades the replicated log to
per-op prepare+accept forever.  Safety never rests on lease timing: an
expired or superseded leaseholder's accepts fail at the replicas and fall
back to the full proposer.
"""
from __future__ import annotations

import pytest

from repro_torch.core import (AZURE_REDIS, Cluster, Decision, LatencyModel,
                              ProtocolConfig, RegionTopology,
                              ReplicatedSimStorage, ReplicatedStore, Sim,
                              StoreLease, TxnSpec, Vote,
                              predicted_caller_latency_ms)
from repro_torch.core.storage import OWNER_BALLOT, BatchConfig
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench


# ---------------------------------------------------------------------------
# Sim storage: lease acquisition and the restored fast path
# ---------------------------------------------------------------------------
def _log_once_seq(storage, sim, n, part="p", writer="p", spacing=10.0):
    lat = {}

    def one(i):
        def gen():
            yield sim.timeout(i * spacing)
            t0 = sim.now
            got = yield storage.log_once(part, f"t{i}", Vote.VOTE_YES,
                                         writer=writer)
            lat[i] = (sim.now - t0, got)
        sim.process(gen())

    for i in range(n):
        one(i)
    sim.run(until=100_000.0)
    return lat


def test_failover_leader_acquires_lease_once_then_serves_fast():
    """Replica 0 dead from t=0: the first op pays one bulk prepare round
    (the epoch acquisition); every subsequent op is a single owner-ballot
    accept — not per-op prepare+accept."""
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1)
    st.fail_replica(0, at=0.0)
    lat = _log_once_seq(st, sim, 8)
    assert all(v == Vote.VOTE_YES for _, v in lat.values())
    assert st.lease_acquisitions == 1
    assert st.fast_path_ops == 8 and st.fallback_ops == 0
    (epoch, holder, _t), = st.lease_history
    assert epoch == 2 and holder == 1
    # The acquisition is amortized: later ops are strictly cheaper than
    # the first (which waited out the bulk prepare).
    assert max(lat[i][0] for i in range(1, 8)) < lat[0][0]


def test_no_failure_keeps_implicit_epoch1_lease():
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1)
    lat = _log_once_seq(st, sim, 4)
    assert all(v == Vote.VOTE_YES for _, v in lat.values())
    assert st.lease_acquisitions == 0 and st.lease_history == []
    assert st.fast_path_ops == 4 and st.fallback_ops == 0


def test_lease_expiry_renews_with_fresh_epoch():
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1,
                              lease_ms=25.0)
    st.fail_replica(0, at=0.0)
    _log_once_seq(st, sim, 6, spacing=30.0)   # every op outlives the lease
    assert st.lease_acquisitions >= 2
    epochs = [e for e, _h, _t in st.lease_history]
    assert epochs == sorted(set(epochs)), "epochs must strictly increase"
    assert st.lease_expiries >= 1


def test_returning_initial_leader_supersedes_failover_lease():
    """Replica 0 recovers after replica 1 took an epoch: routing goes back
    to replica 0, which must acquire a FRESH epoch (its implicit epoch-1
    promise is stale) — and every op still decides exactly once."""
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1)
    st.fail_replica(0, at=0.0, recover_at=50.0)
    lat = _log_once_seq(st, sim, 8, spacing=20.0)
    assert all(v == Vote.VOTE_YES for _, v in lat.values())
    holders = [h for _e, h, _t in st.lease_history]
    assert holders[0] == 1 and 0 in holders[1:]
    epochs = [e for e, _h, _t in st.lease_history]
    assert epochs == sorted(set(epochs))


def test_superseded_leaseholder_falls_back_safely():
    """A slot-level terminator races the leaseholder on one slot: exactly
    one value wins, both callers observe it (single-winner-per-slot across
    epochs)."""
    for seed in range(8):
        sim = Sim()
        st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=seed)
        st.fail_replica(0, at=0.0)
        results = {}

        def prop(name, value, delay):
            def gen():
                yield sim.timeout(delay)
                results[name] = yield st.log_once("p", "t", value,
                                                  writer=name)
            sim.process(gen())

        prop("p", Vote.VOTE_YES, 0.0)
        prop("q", Vote.ABORT, float(seed % 4))
        sim.run(until=100_000.0)
        assert len(set(results.values())) == 1, (seed, results)
        assert st.snapshot()[("p", "t")] == results["p"]


def test_postfailover_batched_flush_uses_lease_ballot():
    """Concurrent same-partition writes AFTER failover still coalesce into
    one accept round (the gate is "current leaseholder", not "initial
    leader")."""
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1,
                              batch=BatchConfig(window_ms=2.0, serial=True))
    st.fail_replica(0, at=0.0)
    evs = [st.log_once("p", f"t{i}", Vote.VOTE_YES, writer=f"w{i}")
           for i in range(10)]
    sim.run(until=100_000.0)
    assert all(ev.value == Vote.VOTE_YES for ev in evs)
    assert st._ingress.max_batch_seen == 10
    assert st.lease_acquisitions == 1
    assert st.fast_path_ops == 10 and st.fallback_ops == 0


def test_postfailover_caller_latency_returns_to_table3():
    """Zero service times, uniform topology, leader 0 dead: once the lease
    is acquired, a cornus commit costs EXACTLY the Table-3 RTT count again
    — the fast path is fully restored, not approximately restored."""
    rtt = 20.0
    topo = RegionTopology.uniform("t3", ("r0",), rtt)
    model = LatencyModel("null", conditional_write_ms=0.0,
                         plain_write_ms=0.0, read_ms=0.0, jitter=0.0)
    sim = Sim()
    storage = ReplicatedSimStorage(sim, model, n_replicas=3, seed=0,
                                   topology=topo, lease_ms=1e9)
    storage.fail_replica(0, at=0.0)
    nodes = ["c", "p0", "p1"]
    tmo = 50.0 * rtt
    cfg = ProtocolConfig(protocol="cornus", topology=topo,
                         vote_timeout_ms=tmo, decision_timeout_ms=tmo,
                         votereq_timeout_ms=tmo, termination_retry_ms=tmo,
                         coop_retry_ms=tmo)
    cl = Cluster(sim, storage, nodes, cfg)
    cl.run_txn(TxnSpec(txn_id="t1", coordinator="c",
                       participants=["p0", "p1"]))
    sim.run(until=5_000.0)
    first = cl.outcomes[("t1", "c")]
    assert first.decision == Decision.COMMIT
    cl.run_txn(TxnSpec(txn_id="t2", coordinator="c",
                       participants=["p0", "p1"]))
    sim.run(until=10_000.0)
    second = cl.outcomes[("t2", "c")]
    assert second.decision == Decision.COMMIT
    predicted = predicted_caller_latency_ms("cornus", rtt)
    # First commit additionally waits out the one-time bulk prepare.
    assert predicted < first.caller_latency_ms <= predicted + 2 * rtt
    assert second.caller_latency_ms == predicted
    assert storage.lease_acquisitions == 1


# ---------------------------------------------------------------------------
# Acceptance: post-failover steady-state throughput within 1.2x of prefail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", ["cornus", "2pc"])
def test_postfailover_throughput_within_bound(proto):
    def wl(nodes, seed):
        return YCSBWorkload(nodes, accesses_per_txn=4, partition_theta=0.9,
                            keys_per_partition=10_000, seed=seed)

    tput = {}
    for name, fails in (("prefail", ()), ("postfail", ((0, 0.0),))):
        cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=8,
                          horizon_ms=300.0, replication=3, seed=3,
                          storage_serial=True, batch_max=64,
                          timeout_ms=60.0, replica_failures=fails)
        r = run_bench(wl, AZURE_REDIS, cfg)
        tput[name] = r.throughput_tps
        if name == "postfail":
            assert r.lease_acquisitions >= 1
            assert r.fast_path_ops > 10 * max(r.fallback_ops, 1)
    assert tput["prefail"] <= 1.2 * tput["postfail"], tput


# ---------------------------------------------------------------------------
# Regression: _finish_fallback must route via the first ALIVE replica
# ---------------------------------------------------------------------------
def test_fallback_log_waits_out_total_outage_instead_of_scattering():
    """A batched plain log whose flush finds every replica dead: the
    fallback must wait for a leader, NOT scatter from dead replica 0's
    position (`_leader_idx() or 0` conflated "leader is 0" with "nobody
    is alive")."""
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1,
                              batch=BatchConfig(window_ms=5.0, serial=True))
    ev = st.log("p", "t", Vote.COMMIT, writer="p")
    for i in range(3):
        st.fail_replica(i, at=1.0, recover_at=500.0)
    sim.run(until=400.0)
    assert not ev.triggered
    trips_during_outage = st.round_trips
    sim.run(until=450.0)     # still down: no futile scatter spinning
    assert st.round_trips == trips_during_outage
    sim.run(until=100_000.0)
    assert ev.value == Vote.COMMIT
    assert st.snapshot()[("p", "t")] == Vote.COMMIT


# ---------------------------------------------------------------------------
# Threaded ReplicatedStore leases (wall-clock bounded)
# ---------------------------------------------------------------------------
def test_threaded_store_lease_grants_fast_path_to_holder():
    st = ReplicatedStore(n_replicas=3)
    lease = st.acquire_lease("h0", duration_s=30.0)
    assert isinstance(lease, StoreLease) and lease.epoch == 2
    assert st.log_once("pX", "t1", Vote.VOTE_YES, writer="h0") \
        == Vote.VOTE_YES
    # Non-owner slot, but leaseholder: served on the fast path.
    assert st.fast_path_ops == 1 and st.fallback_ops == 0
    # A competing CAS still wins the slot race rules (single winner).
    assert st.log_once("pX", "t1", Vote.ABORT, writer="other") \
        == Vote.VOTE_YES


def test_threaded_store_expired_lease_falls_back():
    st = ReplicatedStore(n_replicas=3)
    st.acquire_lease("h0", duration_s=0.0)          # born expired
    assert st.current_lease() is None
    assert st.log_once("pX", "t1", Vote.VOTE_YES, writer="h0") \
        == Vote.VOTE_YES
    assert st.fallback_ops == 1                     # paid prepare+accept
    assert st.read_state("pX", "t1") == Vote.VOTE_YES


def test_partial_lease_recovery_pins_slot_off_fast_path():
    """The reporter of an in-flight value dies BETWEEN the bulk prepare
    and the recovery accept round, so the re-propose misses quorum: the
    slot must be PINNED — a later conflicting write through the valid
    lease goes via the full proposer and adopts the possibly-chosen value
    instead of overwriting it at the epoch ballot."""
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1)
    key = ("p", "tV")
    # V chosen in epoch 1 by {r0, r2}; the proposer crashed before learn.
    st.replicas[0].accept(key, OWNER_BALLOT, Vote.VOTE_YES)
    st.replicas[2].accept(key, OWNER_BALLOT, Vote.VOTE_YES)
    st.fail_replica(0, at=0.0)
    # r2 reports V during prepare_epoch (~t=1.4) but is down for the
    # recovery accept (~t=3.8); it recovers with its epoch-1 accept only.
    st.fail_replica(2, at=2.5, recover_at=30.0)
    out = {}

    def trigger():
        out["t0"] = yield st.log_once("q", "t0", Vote.VOTE_YES, writer="q")

    sim.process(trigger())
    sim.run(until=40.0)
    assert st.lease_acquisitions == 1
    assert key in st._pinned, "unrecovered in-flight slot must be pinned"

    def conflicting():
        out["v"] = yield st.log_once("p", "tV", Vote.ABORT, writer="w")

    sim.process(conflicting())
    sim.run(until=100_000.0)
    assert out["v"] == Vote.VOTE_YES, \
        "fast path must not overwrite the possibly-chosen value"
    assert st.snapshot()[key] == Vote.VOTE_YES
    assert key not in st._pinned, "settled slot should be unpinned"


def test_threaded_partial_recovery_pins_slot():
    """Threaded store: a recovery re-propose that cannot reach quorum
    (slot promises held above the new epoch ballot) pins the slot, and
    the leaseholder's conflicting CAS adopts the in-flight value."""
    st = ReplicatedStore(n_replicas=3)
    key = ("p", "t")
    st.replicas[0].accept(key, OWNER_BALLOT, Vote.VOTE_YES)
    # Competing slot-level proposer promoted promises on a majority above
    # the epoch-2 ballot the lease will use.
    st.replicas[1].prepare(key, (9, 2, 99))
    st.replicas[2].prepare(key, (9, 2, 99))
    st.acquire_lease("h1", duration_s=30.0)
    assert key in st._pinned
    assert st.log_once("p", "t", Vote.ABORT, writer="h1") == Vote.VOTE_YES
    assert st.read_state("p", "t") == Vote.VOTE_YES


def test_threaded_store_get_data_prefers_fresh_rewrite():
    """A replica that was down during a payload rewrite recovers with its
    old copy intact (crash, not amnesia): quorum readers must pick the
    freshest version, not whichever alive replica answers first."""
    st = ReplicatedStore(n_replicas=3)
    st.put_data("h0", "s", b"v1")
    st.fail_replica(0)
    st.put_data("h0", "s", b"v2")       # lands on replicas 1, 2 only
    st.recover_replica(0)
    assert st.get_data("h0", "s") == b"v2"


def test_threaded_store_lease_completes_inflight_slots():
    """An accepted-but-undecided value left by a crashed proposer is
    completed by the next lease acquisition (Multi-Paxos recovery), so
    round-1 accepts can never contradict a possibly-chosen value."""
    st = ReplicatedStore(n_replicas=3)
    # Simulate a proposer that died after a quorum of accepts, pre-learn.
    for r in st.replicas:
        r.accept(("p", "t"), OWNER_BALLOT, Vote.VOTE_YES)
    st.acquire_lease("h1", duration_s=30.0)
    # The lease must have completed the slot with the in-flight value;
    # the leaseholder's own CAS of a DIFFERENT value must lose.
    assert st.log_once("p", "t", Vote.ABORT, writer="h1") == Vote.VOTE_YES
    assert st.read_state("p", "t") == Vote.VOTE_YES
