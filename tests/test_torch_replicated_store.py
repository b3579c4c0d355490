"""Twin of ``tests/test_replicated_store.py`` from its RegionTopology
section on (the threaded ``ReplicatedStore`` tests before it are held by
tests/test_torch_commit_core.py under their own names), on the port's
modules (``repro_torch.core`` / ``repro_torch.txn``): the same assertions,
parametrisations and hypothesis settings.

Replicated-storage quorum LogOnce (extended paper §6).

The store must behave like a single CAS register: under concurrent writers,
minority replica failures, and any interleaving of replica fail/recover
schedules, every caller of log_once observes the SAME first value (Paxos
Commit's "first value accepted by a majority wins").

The ``*_matches_the_reference`` cases run the same seeded inputs through
the JAX package's modules and compare with ``==`` (``Vote`` and
``Decision`` are distinct enums in the two packages, so by name).  These
tests import no torch: the port's commit core is standard library only.
"""
from __future__ import annotations

import dataclasses

import pytest

from conftest import hypothesis_or_stubs

import repro.core as jcore
import repro.txn as jtxn
import repro_torch.core as tcore
import repro_torch.txn as ttxn
from repro_torch.core import (AZURE_REDIS, CROSS_REGION, CROSS_ZONE,
                              INTRA_ZONE, Decision, RegionTopology,
                              ReplicatedSimStorage, Sim, Vote,
                              measured_caller_latency_ms,
                              predicted_caller_latency_ms)

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()
PACKAGES = ((tcore, ttxn), (jcore, jtxn))


def _name(v):
    return None if v is None else v.name


# ---------------------------------------------------------------------------
# RegionTopology
# ---------------------------------------------------------------------------
def test_region_topology_lookup_and_presets():
    assert INTRA_ZONE.rtt_ms("zone-a", "zone-a") == INTRA_ZONE.intra_ms
    assert CROSS_ZONE.rtt_ms("zone-a", "zone-b") == 2.0
    # Symmetric regardless of argument order.
    assert CROSS_REGION.rtt_ms("us-east", "eu-west") \
        == CROSS_REGION.rtt_ms("eu-west", "us-east") == 76.0
    assert CROSS_REGION.max_rtt_ms == 140.0
    uni = RegionTopology.uniform("u", ("a", "b"), 7.0)
    assert uni.rtt_ms("a", "a") == uni.rtt_ms("a", "b") == 7.0
    pl = CROSS_REGION.place_round_robin(["n0", "n1", "n2", "n3"])
    assert pl["n0"] == "us-east" and pl["n3"] == "us-east"


@pytest.mark.parametrize("preset", ["INTRA_ZONE", "CROSS_ZONE",
                                    "CROSS_REGION"])
def test_region_presets_match_the_reference(preset):
    """Every preset's regions, every pairwise RTT, the worst RTT and the
    round-robin placement are the reference's."""
    t, j = getattr(tcore, preset), getattr(jcore, preset)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.max_rtt_ms == j.max_rtt_ms
    regions = list(t.regions) + ["elsewhere"]
    for a in regions:
        for b in regions:
            assert t.rtt_ms(a, b) == j.rtt_ms(a, b), (a, b)
    nodes = [f"n{i}" for i in range(7)]
    assert t.place_round_robin(nodes) == j.place_round_robin(nodes)


# ---------------------------------------------------------------------------
# Simulated quorum store: deterministic interleaving sweep
# ---------------------------------------------------------------------------
def _race_one(seed, mode, n_replicas, fails, delays, core=tcore):
    """Three proposers race on one slot under a replica outage schedule;
    returns the dict of returned values (must be a singleton set)."""
    sim = core.Sim()
    storage = core.ReplicatedSimStorage(sim, core.AZURE_REDIS,
                                        n_replicas=n_replicas, seed=seed,
                                        mode=mode)
    for idx, at, rec in fails:
        if idx < n_replicas:
            storage.fail_replica(idx, at, rec)
    results = {}

    def proposer(name, value, delay):
        def gen():
            yield sim.timeout(delay)
            got = yield storage.log_once("p0", "t", value, writer=name)
            results[name] = got
        sim.process(gen())

    proposer("p0", core.Vote.VOTE_YES, delays[0])   # slot owner
    proposer("q1", core.Vote.ABORT, delays[1])      # termination peer
    proposer("q2", core.Vote.ABORT, delays[2])      # second terminator
    sim.run(until=200_000.0)
    return results


SCHEDULES = [
    (),
    ((0, 0.0, float("inf")),),
    ((1, 2.0, 30.0),),
    ((0, 0.0, 25.0), (2, 10.0, 60.0)),
]


@pytest.mark.parametrize("mode", ["leader", "coloc"])
def test_sim_quorum_race_single_decision_sweep(mode):
    """Deterministic sweep over seeds, outage schedules, and proposer
    offsets: no interleaving yields divergent decisions."""
    schedules = [
        (),
        (((0, 0.0, float("inf"))),),
        ((1, 2.0, 30.0),),
        ((0, 0.0, 25.0), (2, 10.0, 60.0)),
    ]
    # normalize: first entry above is a 3-tuple, keep consistent
    schedules[1] = ((0, 0.0, float("inf")),)
    for seed in range(10):
        for fails in schedules:
            res = _race_one(seed, mode, 3, fails,
                            delays=(0.0, seed % 5, (seed * 3) % 7))
            assert len(res) == 3, (seed, fails, res)
            assert len(set(res.values())) == 1, (seed, fails, res)


@pytest.mark.parametrize("mode", ["leader", "coloc"])
@pytest.mark.parametrize("n_replicas", [3, 5])
def test_sim_quorum_race_matches_the_reference(mode, n_replicas):
    """The sweep above on both packages: the same winner for every
    proposer, seed and outage schedule."""
    for seed in range(10):
        for fails in SCHEDULES:
            delays = (0.0, seed % 5, (seed * 3) % 7)
            got = [{k: _name(v) for k, v in
                    _race_one(seed, mode, n_replicas, fails, delays,
                              core=core).items()}
                   for core in (tcore, jcore)]
            assert got[0] == got[1], (seed, fails)


def test_sim_recovered_replica_catches_up():
    sim = Sim()
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=1)
    storage.fail_replica(2, at=0.0, recover_at=500.0)
    done = {}

    def gen():
        got = yield storage.log_once("p", "t", Vote.VOTE_YES, writer="p")
        done["v"] = got
    sim.process(gen())
    sim.run(until=400.0)
    assert done["v"] == Vote.VOTE_YES
    assert storage.replicas[2].read(("p", "t"))[0] is None
    sim.run(until=1000.0)

    def rd():
        done["r"] = yield storage.read_state("p", "t")
    sim.process(rd())
    sim.run(until=2000.0)
    assert done["r"] == Vote.VOTE_YES
    sim.run(until=3000.0)   # let the async repair push land
    assert storage.replicas[2].read(("p", "t"))[0] == Vote.VOTE_YES


# ---------------------------------------------------------------------------
# Hypothesis: no interleaving of replica failures yields divergent decisions
# (skipped, but still collected, when hypothesis is not installed)
# ---------------------------------------------------------------------------
outage = st.tuples(st.integers(0, 4), st.floats(0.0, 50.0),
                   st.floats(50.0, 500.0))


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 10_000),
       mode=st.sampled_from(["leader", "coloc"]),
       n_replicas=st.sampled_from([3, 5]),
       fails=st.lists(outage, max_size=3),
       delays=st.tuples(st.floats(0.0, 20.0), st.floats(0.0, 20.0),
                        st.floats(0.0, 20.0)))
def test_no_failure_interleaving_diverges(seed, mode, n_replicas, fails,
                                          delays):
    """Every proposer sees the same decided value, and the merged on-disk
    state agrees with it, under randomized outage schedules (all outages
    recover, so quorum is eventually available)."""
    sim = Sim()
    storage = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=n_replicas,
                                   seed=seed, mode=mode)
    for idx, at, rec in fails:
        if idx < n_replicas:
            storage.fail_replica(idx, at, rec)
    results = {}

    def proposer(name, value, delay):
        def gen():
            yield sim.timeout(delay)
            got = yield storage.log_once("p0", "t", value, writer=name)
            results[name] = got
        sim.process(gen())

    proposer("p0", Vote.VOTE_YES, delays[0])
    proposer("q1", Vote.ABORT, delays[1])
    proposer("q2", Vote.ABORT, delays[2])
    sim.run(until=500_000.0)
    assert len(results) == 3, results
    assert len(set(results.values())) == 1, results
    decided = next(iter(results.values()))
    assert storage.snapshot().get(("p0", "t")) == decided


# ---------------------------------------------------------------------------
# Protocol integration over the replicated store
# ---------------------------------------------------------------------------
GEO_PLACEMENT = {"n0": "us-east", "n1": "us-west", "n2": "eu-west",
                 "n3": "us-west"}


def _geo_run(proto, fail=(), core=tcore, txn=ttxn):
    placement = dict(GEO_PLACEMENT)

    def wl(nodes, seed):
        return txn.GeoYCSBWorkload(nodes, placement, "us-east",
                                   accesses_per_txn=4, seed=seed)

    cfg = txn.BenchConfig(protocol=proto, n_nodes=4, horizon_ms=1500.0,
                          replication=3, topology=core.CROSS_REGION,
                          placement=placement,
                          replica_regions=["us-east", "us-west", "eu-west"],
                          replica_failures=fail, coordinator_nodes=["n0"],
                          seed=7)
    return txn.run_bench(wl, core.AZURE_REDIS, cfg)


def test_geo_ycsb_r3_with_replica_failure_cornus_beats_2pc():
    """Acceptance: Cornus and 2PC both complete geo-YCSB against the R=3
    quorum store with the coordinator-region replica down, and Cornus's
    caller latency stays ahead (no decision-log quorum round)."""
    res = {p: _geo_run(p, fail=((0, 0.0),)) for p in ("cornus", "2pc")}
    for p, r in res.items():
        assert r.commits > 0 and r.gaveups == 0, (p, r.commits, r.gaveups)
    assert res["cornus"].avg_latency_ms < res["2pc"].avg_latency_ms, \
        {p: r.avg_latency_ms for p, r in res.items()}


@pytest.mark.parametrize("proto", ["cornus", "2pc"])
def test_geo_run_matches_the_reference(proto):
    """The geo run above on both packages: every BenchResult field."""
    got = [dataclasses.asdict(_geo_run(proto, fail=((0, 0.0),), core=core,
                                       txn=txn))
           for core, txn in PACKAGES]
    assert got[0] == got[1]


def _termination_run(core=tcore):
    sim = core.Sim()
    topo = core.CROSS_ZONE
    nodes = [f"n{i}" for i in range(4)]
    placement = topo.place_round_robin(nodes)
    storage = core.ReplicatedSimStorage(sim, core.AZURE_REDIS, n_replicas=3,
                                        seed=3, topology=topo,
                                        placement=placement, mode="leader")
    cfg = core.ProtocolConfig(protocol="cornus", topology=topo,
                              placement=placement,
                              vote_timeout_ms=60.0, decision_timeout_ms=60.0,
                              votereq_timeout_ms=60.0,
                              termination_retry_ms=60.0)
    cl = core.Cluster(sim, storage, nodes, cfg)
    cl.fail("n0", 1.0)
    cl.run_txn(core.TxnSpec(txn_id="t", coordinator="n0",
                            participants=nodes))
    sim.run(until=60_000.0)
    return cl, storage


def test_cornus_termination_bounded_over_replicated_store():
    """Coordinator dies before sending the decision: every surviving
    participant resolves through the quorum-CAS termination protocol in
    bounded time, they all agree, and the merged replica state matches —
    Cornus stays non-blocking on replicated storage."""
    cl, storage = _termination_run()
    survivors = [o for (t, n), o in cl.outcomes.items() if n != "n0"]
    assert len(survivors) == 3, "a participant blocked"
    decisions = {o.decision for o in survivors}
    assert len(decisions) == 1 and Decision.UNDETERMINED not in decisions
    for o in survivors:
        assert o.ran_termination
        assert o.termination_ms < 1_000.0   # bounded, no blocking
    # Merged replica state carries the same outcome for every partition
    # that logged a decision record.
    snap = storage.snapshot()
    decided = next(iter(decisions))
    want = Vote.COMMIT if decided == Decision.COMMIT else Vote.ABORT
    logged = [v for (p, t), v in snap.items() if v.is_decision()]
    assert logged and all(v == want for v in logged), snap


def test_cornus_termination_matches_the_reference():
    """The coordinator failure above on both packages: every outcome's
    decision and timings, and the merged replica snapshot."""
    seen = []
    for core in (tcore, jcore):
        cl, storage = _termination_run(core)
        outs = sorted((k, o.decision.name, o.ran_termination,
                       o.termination_ms, o.done_at_ms)
                      for k, o in cl.outcomes.items())
        snap = sorted((k, v.name) for k, v in storage.snapshot().items())
        seen.append((outs, snap, storage.requests, storage.round_trips))
    assert seen[0] == seen[1]


def test_table3_measured_matches_predicted():
    """The replicated simulator reproduces the analytic Table-3 RTT counts
    EXACTLY (zero service times, uniform topology) for all six rows —
    including the forwarding rows cornus-opt1 (Paxos leader forwards the
    vote, 2.5 RTT) and paxos-commit (acceptors forward, 1.5 RTT)."""
    from repro_torch.core import SIMULATED_RTT_ROWS
    assert set(SIMULATED_RTT_ROWS) == {"2pc", "cornus", "cornus-opt1",
                                       "2pc-coloc", "cornus-coloc",
                                       "paxos-commit"}
    for proto in SIMULATED_RTT_ROWS:
        measured = measured_caller_latency_ms(proto, 20.0)
        predicted = predicted_caller_latency_ms(proto, 20.0)
        assert measured == predicted, (proto, measured, predicted)


@pytest.mark.parametrize("rtt", [7.0, 20.0])
def test_table3_matches_the_reference(rtt):
    assert tcore.SIMULATED_RTT_ROWS == jcore.SIMULATED_RTT_ROWS
    for proto in tcore.SIMULATED_RTT_ROWS:
        assert tcore.measured_caller_latency_ms(proto, rtt) \
            == jcore.measured_caller_latency_ms(proto, rtt)
        assert tcore.predicted_caller_latency_ms(proto, rtt) \
            == jcore.predicted_caller_latency_ms(proto, rtt)
