"""Twin of ``tests/test_commit_protocols.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Pluggable commit-protocol API: registry, recovery across every registered
protocol (Table 1/2 "During Recovery"), the two forwarding Table-3 rows
(cornus-opt1 / paxos-commit), and the unified read-only fast path that fixed
the CL accounting drift.
"""
import pytest

from repro_torch.core import (AZURE_REDIS, CROSS_ZONE, Cluster, Decision,
                              LatencyModel, ProtocolConfig, RegionTopology,
                              ReplicatedSimStorage, Sim, SimStorage, TxnSpec,
                              Vote, get_protocol, registered_protocols)
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench

ALL_PROTOCOLS = ["cornus", "2pc", "cl", "cornus-opt1", "paxos-commit"]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
def test_registry_contents_and_errors():
    assert registered_protocols() == sorted(ALL_PROTOCOLS)
    for name in ALL_PROTOCOLS:
        assert get_protocol(name).name == name
    with pytest.raises(KeyError, match="unknown commit protocol"):
        get_protocol("3pc")


def test_coordinator_log_alias_removed_registry_is_the_door():
    import repro_torch.core
    assert not hasattr(repro_torch.core, "CoordinatorLogCluster")
    sim = Sim()
    cl = Cluster(sim, SimStorage(sim, AZURE_REDIS), ["n0", "n1"],
                 ProtocolConfig(protocol="cl"))
    assert cl.protocol.name == "cl"


def test_run_bench_rejects_unknown_protocol():
    with pytest.raises(KeyError, match="unknown commit protocol"):
        run_bench(lambda nodes, seed: YCSBWorkload(nodes, seed=seed),
                  AZURE_REDIS, BenchConfig(protocol="nope", horizon_ms=10.0))


# ---------------------------------------------------------------------------
# Recovery, parameterized over every registered protocol
# ---------------------------------------------------------------------------
def _cluster(proto, n, seed=0):
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=seed)
    nodes = [f"n{i}" for i in range(n)]
    return sim, storage, Cluster(sim, storage, nodes,
                                 ProtocolConfig(protocol=proto)), nodes


def _decisions(cluster, txn="t"):
    return {node: st["decision"]
            for (node, t), st in cluster.local.items()
            if t == txn and st["decision"] is not None}


@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_recovered_participant_resolves_consistently(proto):
    """A participant that crashes mid-protocol and later recovers must
    resolve the txn to the SAME decision the survivors reached."""
    sim, storage, cluster, nodes = _cluster(proto, 3, seed=5)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cluster.fail("n2", 2.5, recover_at=2_000.0)
    cluster.run_txn(spec)
    sim.run(until=2_000.0)
    survivors = _decisions(cluster)
    assert "n0" in survivors and "n1" in survivors, survivors
    assert len(set(survivors.values())) == 1

    done = cluster.recover_txn(spec, "n2")
    sim.run(until=100_000.0)
    rec = cluster.outcomes[("t", "n2:recovery")]
    assert rec.decision != Decision.UNDETERMINED, proto
    assert rec.decision == next(iter(survivors.values())), \
        (proto, rec.decision, survivors)


@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_coordinator_failure_then_recover_resolves(proto):
    """The coordinator dies mid-protocol and recovers: its recovery pass
    must resolve the transaction (termination for the Cornus family, the
    decision/presumed-abort log for the 2PC family) — and once it has,
    every blocked participant must eventually learn the same decision."""
    sim, storage, cluster, nodes = _cluster(proto, 4, seed=11)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cluster.fail("n0", 1.0, recover_at=5_000.0)
    cluster.run_txn(spec)
    sim.run(until=5_000.0)

    cluster.recover_txn(spec, "n0")
    sim.run(until=500_000.0)
    rec = cluster.outcomes[("t", "n0:recovery")]
    assert rec.decision != Decision.UNDETERMINED, proto
    decisions = _decisions(cluster)
    # Everyone — coordinator included — converged on one decision.
    assert set(decisions) == set(nodes), (proto, decisions)
    assert set(decisions.values()) == {rec.decision}, (proto, decisions)


def test_cornus_coordinator_recovery_uses_termination():
    """Cornus coordinator recovery resolves via the storage-CAS termination
    protocol (bounded, no peer round-trips needed): the participants' log
    slots carry the evidence."""
    sim, storage, cluster, nodes = _cluster("cornus", 3, seed=2)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cluster.fail("n0", 1.0, recover_at=3_000.0)
    cluster.run_txn(spec)
    sim.run(until=3_000.0)
    cluster.recover_txn(spec, "n0")
    sim.run(until=50_000.0)
    rec = cluster.outcomes[("t", "n0:recovery")]
    assert rec.decision != Decision.UNDETERMINED
    # The decision is durable in the participants' slots, not a peer's RAM.
    states = [storage.store.read_state(p, "t") for p in ("n1", "n2")]
    want = Vote.COMMIT if rec.decision == Decision.COMMIT else Vote.ABORT
    assert want in states, (rec.decision, states)


# ---------------------------------------------------------------------------
# Unified read-only fast path (the old CL accounting drift)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", ALL_PROTOCOLS)
def test_readonly_fast_path_unified(proto):
    """All-read-only txns take the shared fast path in EVERY protocol:
    measured (not hardcoded) caller latency, and remote participants ARE
    notified so their locks release."""
    sim, storage, cluster, nodes = _cluster(proto, 3)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes,
                   read_only=frozenset(nodes), read_only_known_upfront=True)
    # Start mid-simulation so a hardcoded 0.0 would be distinguishable
    # from a measured start-relative latency.
    sim.run(until=7.0)
    done = cluster.run_txn(spec)
    sim.run(until=1_000.0)
    out = done.value
    assert out.decision == Decision.COMMIT
    assert out.caller_latency_ms == 0.0          # measured: now - t0
    assert out.done_at_ms >= 7.0
    decisions = _decisions(cluster)
    assert set(decisions) == set(nodes), (proto, decisions)
    assert set(decisions.values()) == {Decision.COMMIT}


# ---------------------------------------------------------------------------
# Vote forwarding (cornus-opt1 / paxos-commit)
# ---------------------------------------------------------------------------
ZERO_LAT = LatencyModel("null", conditional_write_ms=0.0, plain_write_ms=0.0,
                        read_ms=0.0, jitter=0.0)


def test_forwarded_vote_delivers_decided_value_once():
    """coloc acceptor forwarding: the forward target gets the slot's DECIDED
    value exactly once, even when a termination ABORT won the CAS race."""
    for delay, want in ((0.0, Vote.VOTE_YES), (50.0, Vote.ABORT)):
        sim = Sim()
        topo = RegionTopology.uniform("u", ("r0",), 10.0)
        storage = ReplicatedSimStorage(sim, ZERO_LAT, n_replicas=3,
                                       topology=topo, mode="coloc")
        got = []

        def run():
            if delay:
                # Terminator's ABORT decides the slot first.
                yield storage.log_once("p", "t", Vote.ABORT, writer="peer")
                yield sim.timeout(delay)
            yield storage.log_once("p", "t", Vote.VOTE_YES, writer="p",
                                   forward_to="c",
                                   on_forward=lambda v: got.append(
                                       (sim.now, v)))

        sim.process(run())
        sim.run(until=10_000.0)
        assert len(got) == 1, got
        assert got[0][1] == want, (delay, got)


def test_leader_forwarding_parallel_with_reply():
    """leader mode (cornus-opt1): the leader pushes the vote to the forward
    target in parallel with the reply hop — both land at the same instant
    under a uniform topology (the coordinator saves the extra half-RTT
    participant→coordinator message that plain Cornus still needs)."""
    sim = Sim()
    topo = RegionTopology.uniform("u", ("r0",), 10.0)
    storage = ReplicatedSimStorage(sim, ZERO_LAT, n_replicas=3,
                                   topology=topo, mode="leader")
    got, reply = [], []

    def run():
        v = yield storage.log_once("p", "t", Vote.VOTE_YES, writer="p",
                                   forward_to="c",
                                   on_forward=lambda v: got.append(sim.now))
        reply.append((sim.now, v))

    sim.process(run())
    sim.run(until=10_000.0)
    assert got and reply
    # to-leader 5 + accept round 10 (leader self-ack + acceptor RTT) + 5
    assert got[0] == reply[0][0] == 20.0


@pytest.mark.parametrize("proto", ["cornus-opt1", "paxos-commit"])
def test_forward_protocols_run_bench_end_to_end(proto):
    """BenchConfig(protocol=<forwarding row>) runs through run_bench by
    registry lookup only — single store AND replicated deployments."""
    wl = lambda nodes, seed: YCSBWorkload(nodes, seed=seed)
    r = run_bench(wl, AZURE_REDIS,
                  BenchConfig(protocol=proto, n_nodes=4, horizon_ms=400.0,
                              seed=3))
    assert r.commits > 50, (proto, r.commits)
    # Replicated: storage_mode=None lets the registry pick the protocol's
    # preferred deployment (coloc for paxos-commit, leader for cornus-opt1).
    r3 = run_bench(wl, AZURE_REDIS,
                   BenchConfig(protocol=proto, n_nodes=4, horizon_ms=400.0,
                               replication=3, topology=CROSS_ZONE, seed=3))
    assert r3.commits > 0, (proto, r3.commits)


def test_forwarding_shaves_the_predicted_rtts():
    """Against the same replicated deployment, the measured caller-latency
    ordering matches Table 3: paxos-commit < cornus-opt1 < cornus."""
    from repro_torch.core import measured_caller_latency_ms
    lat = {p: measured_caller_latency_ms(p, 20.0)
           for p in ("paxos-commit", "cornus-opt1", "cornus")}
    assert lat["paxos-commit"] < lat["cornus-opt1"] < lat["cornus"], lat
