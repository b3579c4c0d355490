"""The port's commit core (``repro_torch.core`` and ``repro_torch.txn``)
against the JAX package's, on the CPU.

Cross-package parity: the protocol registry and every strategy's
capability flags, one generator-process program on both discrete-event
kernels, one seeded single-threaded op script on both threaded
``ReplicatedStore``s (replica logs, membership, counters, GC journal),
and the store factory.  Then the torch twins of the reference's threaded
``ReplicatedStore`` tests (tests/test_replicated_store.py), lease-keeper
tests (tests/test_store_api.py) and wall-clock harness tests
(tests/test_wallclock.py).  ``Vote`` and ``Decision`` are distinct enums
in the two packages, so values are compared by ``.name``.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.stores as jstores  # noqa: E402
import repro.txn.threaded as jthreaded  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.stores as tstores  # noqa: E402
from repro_torch.ckpt.commit import CornusCheckpointer  # noqa: E402
from repro_torch.core import (Decision, DecisionCacheConfig,  # noqa: E402
                              FileStore, LeaseKeeper, MemoryStore,
                              QuorumUnavailable, ReplicatedStore, Vote)
from repro_torch.txn.threaded import (WALLCLOCK_BACKENDS,  # noqa: E402
                                      WallclockConfig, run_wallclock,
                                      wallclock_rows)

PROTOCOLS = ["cornus", "2pc", "cl", "cornus-opt1", "paxos-commit"]
FLAGS = ("participant_logs", "vote_via_log_once", "eager_decision_record",
         "forwards_votes", "readonly_prepare_skip", "preferred_storage_mode")


def _name(v):
    return None if v is None else v.name


# ---------------------------------------------------------------------------
# Protocols and the discrete-event kernel
# ---------------------------------------------------------------------------
def test_registered_protocols_match():
    assert tcore.registered_protocols() == jcore.registered_protocols()
    assert tcore.registered_protocols() == sorted(PROTOCOLS)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_capability_flags_match(protocol):
    t, j = tcore.get_protocol(protocol), jcore.get_protocol(protocol)
    assert t.__name__ == j.__name__ and t.name == j.name == protocol
    for flag in FLAGS:
        assert getattr(t, flag, None) == getattr(j, flag, None), flag
    assert ([c.__name__ for c in t.__mro__]
            == [c.__name__ for c in j.__mro__])


def test_protocol_config_and_topologies_match():
    assert (dataclasses.asdict(tcore.ProtocolConfig())
            == dataclasses.asdict(jcore.ProtocolConfig()))
    for name in ("INTRA_ZONE", "CROSS_ZONE", "CROSS_REGION"):
        t, j = getattr(tcore, name), getattr(jcore, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for a in t.regions:
            for b in t.regions:
                assert t.rtt_ms(a, b) == j.rtt_ms(a, b)
        assert t.max_rtt_ms == j.max_rtt_ms


def _sim_program(core):
    """Processes that wait on timeouts, manual events, any_of / all_of and a
    cancelled timer; returns the (time, tag, value) trace."""
    sim = core.Sim()
    trace = []
    gate = sim.event()

    def worker(i):
        yield sim.timeout(0.5 * i, f"w{i}")
        trace.append((sim.now, "woke", i))
        got = yield sim.any_of([gate, sim.timeout(1.0 + i, "late")])
        trace.append((sim.now, "any", i, got))
        vals = yield sim.all_of([sim.timeout(0.25 * j, j) for j in range(3)])
        trace.append((sim.now, "all", i, tuple(vals)))
        return i * 10

    def opener():
        yield sim.timeout(1.2)
        gate.trigger("open")
        trace.append((sim.now, "gate"))

    done = [sim.process(worker(i)) for i in range(4)]
    sim.process(opener())
    fired = sim.timer(0.7, lambda: trace.append((sim.now, "timer", 1)))
    dead = sim.timer(0.9, lambda: trace.append((sim.now, "timer", 2)))
    dead.cancel()
    join = sim.all_of(done)
    join.subscribe(lambda ev: trace.append((sim.now, "joined", ev.value)))
    sim.run(until=2.0)
    trace.append((sim.now, "paused", bool(fired)))
    sim.run()
    trace.append((sim.now, "end"))
    return trace


def test_sim_traces_match():
    t, j = _sim_program(tcore), _sim_program(jcore)
    assert t == j
    assert any(e[1] == "joined" for e in t) and (0.9, "timer", 2) not in t


# ---------------------------------------------------------------------------
# Threaded ReplicatedStore: one op script through both packages
# ---------------------------------------------------------------------------
def _replica_logs(store):
    out = []
    for r in store.replicas:
        slots = {}
        for key, s in sorted(r._slots.items()):
            slots[key] = (s.promised, s.acc_ballot, _name(s.acc_value),
                          s.decided, _name(s.value), s.gen, s.writer,
                          s.corrupt)
        out.append((r.index, r.epoch_promised, slots,
                    sorted(r._payloads.items())))
    return out


def _replicated_script(core):
    store = core.ReplicatedStore(
        n_replicas=3, seed=11,
        lifecycle=core.LifecycleConfig(gc=True))
    V = core.Vote
    got = []
    got.append(store.log_once("p0", "t0", V.VOTE_YES, writer="p0"))
    got.append(store.log_once("p0", "t0", V.ABORT, writer="term"))
    got.append(store.log("p0", "t0", V.COMMIT, writer="p0"))
    lease = store.acquire_lease("leader", duration_s=60.0)
    got.append((lease.epoch, lease.holder, lease.ballot))
    for i in range(4):
        got.append(store.log_once(f"p{i % 2}", f"t{i + 1}", V.VOTE_YES,
                                  writer="leader"))
    store.fail_replica(2)
    got.append(store.log_once("p1", "t5", V.ABORT, writer="p1"))
    got.append(store.log("p1", "t5", V.ABORT, writer="p1"))
    got.append(store.revive_replica(2))
    got.append(store.set_replication(5, holder="leader"))
    got.append(store.log_once("p0", "t6", V.VOTE_YES, writer="leader"))
    got.append(store.set_replication(3, holder="leader"))
    got.append(store.log("p0", "t6", V.COMMIT, writer="leader"))
    got.append(store.read_state("p1", "t5"))
    got.append(store.gc_pass(now=1.0))
    got.append(store.watermark_lag())
    counters = {k: getattr(store, k) for k in (
        "cas_attempts", "cas_losses", "lease_acquisitions", "fast_path_ops",
        "fallback_ops", "state_transfers", "reconfigurations",
        "gc_truncations", "n", "quorum")}
    return {
        "results": [_name(g) if hasattr(g, "name") else g for g in got],
        "logs": _replica_logs(store),
        "alive": list(store._alive),
        "membership": [(m.config_id, m.replica_ids)
                       for m in store.membership_history],
        "counters": counters,
        "gc_log": [dataclasses.astuple(e) for e in store.gc_log],
        "watermarks": dict(store.watermarks),
        "snapshot": {k: v.name for k, v in store.snapshot().items()},
    }


def test_replicated_store_script_matches():
    t = _replicated_script(tcore)
    j = _replicated_script(jcore)
    # Results hold MembershipConfig objects of each package: compare fields.
    norm = [(r.config_id, r.replica_ids) if hasattr(r, "replica_ids") else r
            for r in t["results"]]
    jnorm = [(r.config_id, r.replica_ids) if hasattr(r, "replica_ids") else r
             for r in j["results"]]
    assert norm == jnorm
    for key in ("logs", "alive", "membership", "counters", "gc_log",
                "watermarks", "snapshot"):
        assert t[key] == j[key], key
    assert t["counters"]["fast_path_ops"] > 0
    assert t["counters"]["state_transfers"] > 0
    assert t["counters"]["reconfigurations"] >= 2
    assert t["counters"]["gc_truncations"] > 0
    sizes = [len(ids) for _, ids in t["membership"]]
    assert sizes[0] == 3 and 5 in sizes and sizes[-1] == 3


# ---------------------------------------------------------------------------
# The store factory
# ---------------------------------------------------------------------------
def test_store_config_and_registry_match():
    """The port's StoreConfig carries the reference's fields in its order,
    each with the reference's default; the registries hold the same
    backends, and both agree on which names are simulated."""
    jf = [f.name for f in dataclasses.fields(jstores.StoreConfig)]
    tf = [f.name for f in dataclasses.fields(tstores.StoreConfig)]
    assert tf == jf
    assert (dataclasses.asdict(tstores.StoreConfig())
            == dataclasses.asdict(jstores.StoreConfig()))
    assert tstores.registered_stores() == jstores.registered_stores()
    assert {"sim", "replicated-sim"} <= set(tstores.registered_stores())
    for name in jstores.registered_stores():
        assert tstores.is_simulated(name) == jstores.is_simulated(name)


@pytest.mark.parametrize("backend,cls", [
    ("memory", "MemoryStore"), ("replicated", "ReplicatedStore")])
@pytest.mark.parametrize("delay,batching", [(0.0, False), (0.5, True)])
def test_build_store_builds_the_same_classes(backend, cls, delay, batching):
    kw = dict(backend=backend, service_delay_ms=delay, batching=batching)
    t = tstores.build_store(tstores.StoreConfig(**kw))
    j = jstores.build_store(jstores.StoreConfig(**kw))
    assert type(t).__name__ == type(j).__name__
    inner_t = t.inner if batching else t
    inner_j = j.inner if batching else j
    assert type(inner_t).__name__ == type(inner_j).__name__
    assert type(inner_t).__name__.endswith(cls)


def test_simulated_and_unknown_backends_are_refused():
    """A simulated backend without ``sim=`` raises the reference's
    ValueError; an unknown name still raises KeyError."""
    for backend in ("sim", "replicated-sim"):
        msgs = []
        for stores in (tstores, jstores):
            with pytest.raises(ValueError, match="needs sim=") as e:
                stores.build_store(stores.StoreConfig(backend=backend))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for stores in (tstores, jstores):
        with pytest.raises(KeyError, match="registered: file, memory, "
                                           "replicated, replicated-sim, "
                                           "sim"):
            stores.build_store(stores.StoreConfig(backend="nope"))
        with pytest.raises(KeyError, match="registered"):
            stores.is_simulated("nope")


@pytest.mark.parametrize("backend,kw", [
    ("sim", {}), ("replicated-sim", {"replication": 3}),
    ("replicated-sim", {"replication": 3, "mode": "coloc",
                        "topology": "CROSS_REGION"})])
def test_simulated_backends_build_the_reference_classes(backend, kw):
    built = []
    for core, stores in ((tcore, tstores), (jcore, jstores)):
        args = dict(kw)
        if "topology" in args:
            args["topology"] = getattr(core, args["topology"])
        store = stores.build_store(
            stores.StoreConfig(backend=backend, seed=4, **args),
            sim=core.Sim())
        built.append(store)
    t, j = built
    assert type(t).__name__ == type(j).__name__
    assert type(t).__name__ == {"sim": "SimStorage",
                                "replicated-sim": "ReplicatedSimStorage"}[
                                    backend]
    for attr in ("n_replicas", "mode", "replica_regions", "op_timeout_ms",
                 "lease_ms"):
        assert getattr(t, attr, None) == getattr(j, attr, None), attr


@pytest.mark.parametrize("knob", ["chaos_drop_p", "chaos_delay_ms",
                                  "chaos_jitter_ms"])
def test_chaos_knobs_wrap_in_chaos_store(knob):
    for stores in (tstores, jstores):
        store = stores.build_store(stores.StoreConfig(
            backend="memory", seed=2, **{knob: 0.1}))
        assert type(store).__name__ == "ChaosStore"
        assert type(store.inner).__name__ == "MemoryStore"
        plain = stores.build_store(stores.StoreConfig(backend="memory"))
        assert type(plain).__name__ == "MemoryStore"


def test_batching_store_coalesces_and_keeps_first_writer_wins():
    """More writer threads than cores race two values into each slot of a
    group-committed quorum store with a short switch interval: every
    writer of a slot sees one winner, and the store reads it back."""
    import os
    import sys
    writers, slots = max(16, 2 * (os.cpu_count() or 1)), 8
    store = tcore.BatchingStore(ReplicatedStore(n_replicas=5, seed=9),
                                window_s=0.0005, max_batch=16)
    results = [dict() for _ in range(writers)]

    def writer(w):
        for t in range(slots):
            v = Vote.VOTE_YES if w % 2 == 0 else Vote.ABORT
            results[w][t] = store.log_once(f"p{t % 3}", f"t{t}", v,
                                           writer=f"w{w}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _join_all([threading.Thread(target=writer, args=(w,))
                   for w in range(writers)])
    finally:
        sys.setswitchinterval(old)
    for t in range(slots):
        winners = {results[w][t] for w in range(writers)}
        assert len(winners) == 1, (t, winners)
        assert store.read_state(f"p{t % 3}", f"t{t}") in winners
    assert store.batched_ops == writers * slots
    assert store.round_trips < writers * slots


# ---------------------------------------------------------------------------
# Twins of tests/test_replicated_store.py (threaded ReplicatedStore)
# ---------------------------------------------------------------------------
def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()


def test_log_once_decided_exactly_once_under_concurrent_writers():
    for trial in range(60):
        store = ReplicatedStore(n_replicas=3, seed=trial)
        results = {}

        def owner():
            results["o"] = store.log_once("p1", "t", Vote.VOTE_YES,
                                          writer="p1")

        def terminator():
            results["t"] = store.log_once("p1", "t", Vote.ABORT, writer="p2")

        _join_all([threading.Thread(target=owner),
                   threading.Thread(target=terminator)])
        assert results["o"] == results["t"], (trial, results)
        assert store.read_state("p1", "t") == results["o"]


def test_log_once_under_minority_replica_failure():
    store = ReplicatedStore(n_replicas=3)
    store.fail_replica(2)
    assert store.log_once("p", "t1", Vote.VOTE_YES, writer="p") \
        == Vote.VOTE_YES
    assert store.log_once("p", "t1", Vote.ABORT, writer="q") == Vote.VOTE_YES
    assert store.cas_losses == 1


def test_recovered_replica_is_read_repaired():
    store = ReplicatedStore(n_replicas=3)
    store.fail_replica(2)
    store.log_once("p", "t1", Vote.VOTE_YES, writer="p")
    store.log("p", "t1", Vote.COMMIT, writer="p")
    store.recover_replica(2)
    assert store.replicas[2].read(("p", "t1"))[0] is None
    assert store.read_state("p", "t1") == Vote.COMMIT
    assert store.replicas[2].read(("p", "t1"))[0] == Vote.COMMIT


def test_majority_down_is_unavailable_not_wrong():
    store = ReplicatedStore(n_replicas=3)
    store.fail_replica(0)
    store.fail_replica(1)
    with pytest.raises(QuorumUnavailable):
        store.log_once("p", "t", Vote.VOTE_YES, writer="p")
    with pytest.raises(QuorumUnavailable):
        store.read_state("p", "t")


def test_log_decision_is_sticky():
    store = ReplicatedStore(n_replicas=3)
    store.log("p", "t", Vote.COMMIT, writer="p")
    assert store.log("p", "t", Vote.VOTE_YES, writer="p") == Vote.COMMIT
    assert store.read_state("p", "t") == Vote.COMMIT


def test_many_concurrent_slots_and_writers():
    store = ReplicatedStore(n_replicas=5, seed=3)
    results = [dict() for _ in range(8)]

    def worker(w):
        for s in range(16):
            v = Vote.VOTE_YES if w % 2 == 0 else Vote.ABORT
            results[w][s] = store.log_once("p", f"t{s}", v, writer=f"w{w}")

    _join_all([threading.Thread(target=worker, args=(w,)) for w in range(8)])
    for s in range(16):
        winners = {results[w][s] for w in range(8)}
        assert len(winners) == 1, (s, winners)


# ---------------------------------------------------------------------------
# Twins of tests/test_store_api.py's LeaseKeeper tests
# ---------------------------------------------------------------------------
def test_lease_keeper_unsupported_store_is_slow_path():
    keeper = LeaseKeeper(MemoryStore(), holder="h0")
    assert not keeper.supported
    assert keeper.ensure() is None and keeper.failures == 0


def test_lease_keeper_acquires_and_reuses():
    store = ReplicatedStore(n_replicas=3, seed=1)
    keeper = LeaseKeeper(store, holder="h0", duration_s=60.0)
    lease = keeper.ensure()
    assert lease is not None and lease.holder == "h0"
    assert keeper.acquisitions == 1
    assert keeper.ensure() is lease
    assert keeper.acquisitions == 1 and keeper.renewals == 0


def test_lease_keeper_renews_near_expiry():
    store = ReplicatedStore(n_replicas=3, seed=1)
    keeper = LeaseKeeper(store, holder="h0", duration_s=1e-4)
    first = keeper.ensure()
    assert first is not None
    time.sleep(2e-4)
    second = keeper.ensure()
    assert second is not None and second.epoch > first.epoch
    assert keeper.renewals >= 1


def test_lease_keeper_defers_to_live_peer():
    store = ReplicatedStore(n_replicas=3, seed=1)
    store.acquire_lease("peer", duration_s=60.0)
    keeper = LeaseKeeper(store, holder="h0")
    assert keeper.ensure() is None
    assert keeper.acquisitions == 0


def test_lease_keeper_degrades_on_quorum_loss():
    store = ReplicatedStore(n_replicas=3, seed=1)
    store.fail_replica(0)
    store.fail_replica(1)
    keeper = LeaseKeeper(store, holder="h0")
    assert keeper.ensure() is None
    assert keeper.failures == 1
    assert keeper.degradations == 1 and keeper.degraded
    store.recover_replica(0)
    assert keeper.ensure() is not None
    assert keeper.reengagements == 1 and not keeper.degraded


def test_lease_keeper_logs_degradation_transitions(caplog):
    store = ReplicatedStore(n_replicas=3, seed=1)
    store.fail_replica(0)
    store.fail_replica(1)
    keeper = LeaseKeeper(store, holder="h0")
    with caplog.at_level(logging.INFO, logger="repro_torch.core.control"):
        keeper.ensure()
        keeper.ensure()
        store.recover_replica(0)
        keeper.ensure()
    slow = [r for r in caplog.records if "slow path" in r.message]
    fast = [r for r in caplog.records if "re-engaged" in r.message]
    assert len(slow) == 1 and slow[0].levelno == logging.WARNING
    assert len(fast) == 1 and fast[0].levelno == logging.INFO
    assert keeper.degradations == 2


# ---------------------------------------------------------------------------
# Twins of tests/test_wallclock.py
# ---------------------------------------------------------------------------
def small(protocol, backend, **kw):
    base = dict(protocol=protocol, backend=backend, workers=2,
                txns_per_worker=16, service_delay_ms=0.3,
                straggler_every=4, straggler_delay_ms=30.0,
                terminators=2, seed=5)
    base.update(kw)
    return WallclockConfig(**base)


def test_rows_cover_table3():
    rows = wallclock_rows()
    assert set(rows) == {"2pc", "cornus", "cornus-opt1", "2pc-coloc",
                         "cornus-coloc", "paxos-commit"}
    for protocol, backend in rows.values():
        assert backend in WALLCLOCK_BACKENDS.values()
    assert rows == jthreaded.wallclock_rows()


def test_wallclock_config_and_backends_match():
    assert WALLCLOCK_BACKENDS == jthreaded.WALLCLOCK_BACKENDS
    t = dataclasses.asdict(WallclockConfig())
    j = dataclasses.asdict(jthreaded.WallclockConfig())
    t.pop("decisions")
    j.pop("decisions")
    assert t == j
    assert (dataclasses.asdict(WallclockConfig().decisions)
            == dataclasses.asdict(jthreaded.WallclockConfig().decisions))


@pytest.mark.parametrize("protocol", ["cornus", "2pc"])
def test_memory_rows_commit_and_storm_counters(protocol):
    r = run_wallclock(small(protocol, "memory"))
    assert r.commits + r.terminated == 2 * 16
    assert r.commits > 0
    assert r.throughput_tps > 0
    assert r.terminated > 0
    assert r.singleflight_hits > 0
    assert r.decisions_pushed > 0
    if protocol == "cornus":
        assert r.decision_cache_hits > 0


def test_replicated_row_rides_the_lease_fast_path():
    r = run_wallclock(small("cornus", "replicated"))
    assert r.commits > 0
    assert r.lease_acquisitions >= 1
    assert r.fast_path_ops > 0


def test_storm_off_means_no_control_counters():
    r = run_wallclock(small("cornus", "memory", straggler_every=0,
                            decisions=DecisionCacheConfig()))
    assert r.commits == 2 * 16
    assert r.decision_cache_hits == 0
    assert r.singleflight_hits == 0
    assert r.decisions_pushed == 0


def test_checkpointer_acquires_lease_on_replicated_store():
    store = ReplicatedStore(n_replicas=3, seed=2)
    hosts = ["h0", "h1"]
    cps = {h: CornusCheckpointer(store, h, hosts, straggler_timeout_s=2.0)
           for h in hosts}
    for h in hosts:
        assert cps[h].vote(1, b"shard") == Vote.VOTE_YES
    d, forced = cps["h0"].resolve(1)
    assert d == Decision.COMMIT and forced == 0
    assert store.lease_acquisitions >= 1
    assert store.fast_path_ops > 0


def test_checkpointer_degrades_when_lease_unavailable():
    store = ReplicatedStore(n_replicas=3, seed=2)
    cp = CornusCheckpointer(store, "h0", ["h0", "h1"],
                            straggler_timeout_s=0.1, poll_interval_s=0.01)
    store.fail_replica(0)
    store.fail_replica(1)
    assert cp._writer() == "h0"
    assert cp.lease.failures == 1
    store.recover_replica(0)
    store.recover_replica(1)
    out = cp.save(7, b"payload")
    assert out.decision == Decision.ABORT
    assert store.lease_acquisitions >= 1


def test_checkpointer_on_plain_store_never_touches_leases(tmp_path):
    store = FileStore(str(tmp_path))
    cp = CornusCheckpointer(store, "h0", ["h0"])
    assert not cp.lease.supported
    out = cp.save(1, b"x")
    assert out.decision == Decision.COMMIT
