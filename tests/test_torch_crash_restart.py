"""Twin of ``tests/test_crash_restart.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Crash–restart replay: a crashed node comes back with its durable log
intact, runs the registered protocol's recovery (Table 1/2 "During
Recovery") against live traffic, and the history checker certifies the
result.

Also pins the zombie-round fence: protocol rounds started before a crash
must stop acting after the restart (crash–restart incarnation epochs) —
without the fence, a pre-crash participant round parked on a decision wait
resumes after the restart and presumed-abort-logs ABORT over the decision
recovery already reached (an AC3 violation the chaos sweep caught).
"""
import pytest

from repro_torch.core import (AZURE_REDIS, Cluster, Decision, FaultSchedule,
                              ProtocolConfig, Sim, SimStorage, TxnSpec, Vote,
                              get_protocol)
from repro_torch.core.history import HistoryRecorder, check_run
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench

ALL_PROTOCOLS = ["cornus", "2pc", "cl", "cornus-opt1", "paxos-commit"]


def _cluster(proto, n, seed=0):
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=seed)
    storage.history = HistoryRecorder(sim)
    nodes = [f"n{i}" for i in range(n)]
    return sim, storage, Cluster(sim, storage, nodes,
                                 ProtocolConfig(protocol=proto)), nodes


def _decisions(cluster, txn="t"):
    return {node: st["decision"]
            for (node, t), st in cluster.local.items()
            if t == txn and st["decision"] is not None}


def _certify(cluster, storage, proto):
    violations = check_run(cluster.ctx, storage=storage,
                           participant_logs=get_protocol(
                               proto).participant_logs)
    assert violations == [], (proto, violations)


# ---------------------------------------------------------------------------
# Durable-log replay through the automatic restart path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_coordinator_crash_restart_replays_durable_log(proto):
    """The coordinator crashes mid-protocol and RESTARTS (no manual
    recover_txn): the restart scans its unresolved txns, runs recovery off
    the durable log, and every node converges on one certified decision."""
    sim, storage, cluster, nodes = _cluster(proto, 4, seed=11)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cluster.schedule_crash_restart("n0", at=1.0, restart_at=5_000.0)
    cluster.run_txn(spec)
    sim.run(until=500_000.0)

    assert cluster.crash_restarts == 1
    assert cluster.recoveries_run >= 1, proto
    rec = cluster.outcomes[("t", "n0:recovery")]
    assert rec.decision != Decision.UNDETERMINED, proto
    decisions = _decisions(cluster)
    assert set(decisions) == set(nodes), (proto, decisions)
    assert set(decisions.values()) == {rec.decision}, (proto, decisions)
    _certify(cluster, storage, proto)


@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_participant_crash_restart_replays_durable_log(proto):
    """A participant crashes and restarts: its recovery must land on the
    SAME decision the survivors reached, with the vote it logged before
    the crash still in the durable slot (protocols that log votes)."""
    sim, storage, cluster, nodes = _cluster(proto, 3, seed=5)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cluster.schedule_crash_restart("n2", at=2.5, restart_at=2_000.0)
    cluster.run_txn(spec)
    sim.run(until=100_000.0)

    assert cluster.crash_restarts == 1
    decisions = _decisions(cluster)
    assert "n0" in decisions and "n1" in decisions, (proto, decisions)
    assert len(set(decisions.values())) == 1, (proto, decisions)
    want = next(iter(decisions.values()))
    # Resolved either by recovery or (if it decided pre-crash) locally.
    rec = cluster.outcomes.get(("t", "n2:recovery"))
    got = rec.decision if rec is not None else decisions.get("n2")
    assert got == want, (proto, got, want)
    if get_protocol(proto).participant_logs and rec is not None:
        # Recovery re-logged the decision durably in n2's own slot.
        state = storage.store.read_state("n2", "t")
        assert state == (Vote.COMMIT if want == Decision.COMMIT
                         else Vote.ABORT), (proto, state)
    _certify(cluster, storage, proto)


@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_restart_during_own_termination_round(proto):
    """A participant restarts while INSIDE its own termination round (the
    coordinator is down, so the 2PC family's cooperative termination is
    guaranteed still blocked at crash time).  The pre-crash round is fenced
    by the incarnation bump; recovery — not the zombie — resolves, and once
    the coordinator itself restarts everyone converges."""
    sim, storage, cluster, nodes = _cluster(proto, 4, seed=3)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    # Coordinator out for a long window; participants time out at ~25 ms
    # and enter termination, where n1 crashes and later restarts.
    cluster.schedule_crash_restart("n0", at=1.0, restart_at=800.0)
    cluster.schedule_crash_restart("n1", at=40.0, restart_at=90.0)
    cluster.run_txn(spec)
    sim.run(until=500_000.0)

    assert cluster.crash_restarts == 2
    assert cluster.recoveries_run >= 1, proto
    decisions = _decisions(cluster)
    assert set(decisions) == set(nodes), (proto, decisions)
    assert len(set(decisions.values())) == 1, (proto, decisions)
    _certify(cluster, storage, proto)


# ---------------------------------------------------------------------------
# Zombie-round fence (incarnation epochs)
# ---------------------------------------------------------------------------
def test_incarnation_epochs_fence_zombie_rounds():
    """A round captures its epoch at entry; after the node's crash–restart
    the OLD epoch is fenced forever even though alive() is true again."""
    sim, storage, cluster, nodes = _cluster("cornus", 3)
    proto = cluster.protocol
    ep = proto.epoch("n1")
    assert proto.live("n1", ep)
    cluster.schedule_crash_restart("n1", at=5.0, restart_at=20.0)
    sim.run(until=10.0)
    assert not cluster.alive("n1") and not proto.live("n1", ep)
    sim.run(until=30.0)
    assert cluster.alive("n1")          # restarted...
    assert not proto.live("n1", ep)     # ...but the old incarnation is dead
    assert proto.live("n1", proto.epoch("n1"))
    assert proto.epoch("n1") == ep + 1


def test_repeated_restarts_bump_epoch_each_time():
    sim, storage, cluster, nodes = _cluster("2pc", 3)
    cluster.schedule_crash_restart("n2", at=5.0, restart_at=10.0)
    cluster.schedule_crash_restart("n2", at=20.0, restart_at=25.0)
    sim.run(until=50.0)
    assert cluster.transport.incarnation("n2") == 2
    assert cluster.crash_restarts == 2


# ---------------------------------------------------------------------------
# Certified under live traffic (bench-level regression of the AC3 zombie
# bug and the recoverability path), incl. inside a reconfiguration window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", ["cornus", "2pc"])
def test_crash_mix_traffic_is_certified(proto):
    """Seeded crash-heavy chaos under closed-loop traffic: zero checker
    violations and at least one restart actually exercised."""
    nodes = [f"n{i}" for i in range(4)]
    sched = FaultSchedule.generate(9, nodes, 250.0, 0, "crash")
    cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=2,
                      horizon_ms=250.0, seed=9, retry_fresh_ids=True,
                      chaos=sched, record_history=True)
    res = run_bench(lambda n, seed: YCSBWorkload(n, seed=seed),
                    AZURE_REDIS, cfg)
    assert res.violations == 0, res.violation_details
    assert res.crash_restarts >= 1
    assert res.commits > 0


def test_restart_inside_reconfiguration_window_is_certified():
    """Coordinator node crash–restarts while the replicated store is
    mid-reconfiguration (R 3 → 5): recovery runs against the changing
    quorum and the history still certifies clean."""
    cfg = BenchConfig(protocol="cornus", n_nodes=4, threads_per_node=2,
                      horizon_ms=250.0, seed=3, replication=3,
                      retry_fresh_ids=True, record_history=True,
                      reconfigurations=((80.0, 5),),
                      crash_restarts=(("n0", 60.0, 140.0),))
    res = run_bench(lambda n, seed: YCSBWorkload(n, seed=seed),
                    AZURE_REDIS, cfg)
    assert res.violations == 0, res.violation_details
    assert res.crash_restarts == 1
    assert res.commits > 0
