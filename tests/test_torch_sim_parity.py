"""The port's discrete-event half of the commit core against the JAX
package's, on the CPU, held with ``==``.

Each grid cell runs one seeded ``run_bench`` through both packages and
compares ``dataclasses.asdict(BenchResult)`` field by field: latencies,
breakdowns, storage and lease accounting, storm and fault counters,
violation lists, GC and recovery spans.  The grid covers every registered
protocol on ``sim``; ``replicated-sim`` at R = 3 in leader and coloc
modes; a batch window and the "auto" window; the four termination-storm
controls; seeded fault schedules with the history checker; a lifecycle
with GC and scrub; crash-restarts, replica failures and reconfigurations;
TPC-C and Geo-YCSB.  Then ``Cluster`` outcomes on a scripted run,
``FaultSchedule.generate``'s JSON, a repro bundle written by one package
and read by the other, and ``ChaosStore`` over each package's
``MemoryStore``.  ``Vote`` and ``Decision`` are distinct enums in the two
packages, so their values are compared by ``.name``.
"""
from __future__ import annotations

import dataclasses

import pytest

import repro.core as jcore
import repro.txn as jtxn
import repro_torch.core as tcore
import repro_torch.txn as ttxn

NODES = ["n0", "n1", "n2", "n3"]
GEO_PLACEMENT = {"n0": "us-east", "n1": "us-west", "n2": "eu-west",
                 "n3": "us-west"}
PACKAGES = ((tcore, ttxn), (jcore, jtxn))


def _name(v):
    return None if v is None else v.name


def _workload(txn, kind, kw):
    if kind == "ycsb":
        return lambda nodes, seed: txn.YCSBWorkload(nodes, seed=seed, **kw)
    if kind == "tpcc":
        return lambda nodes, seed: txn.TPCCWorkload(nodes, seed=seed, **kw)
    assert kind == "geo"
    return lambda nodes, seed: txn.GeoYCSBWorkload(
        nodes, GEO_PLACEMENT, "us-east", seed=seed, **kw)


def _bench(core, txn, wl, model, cfg):
    """One cell on one package: names of the package's constants (model,
    topology) and a ``chaos`` tuple of ``FaultSchedule.generate``'s
    arguments after ``nodes`` are resolved in that package."""
    cfg = dict(cfg)
    if "topology" in cfg:
        cfg["topology"] = getattr(core, cfg["topology"])
    if "chaos" in cfg:
        seed, horizon, n_replicas, mix = cfg["chaos"]
        cfg["chaos"] = core.FaultSchedule.generate(seed, NODES, horizon,
                                                   n_replicas, mix)
    base = dict(n_nodes=4, threads_per_node=4, horizon_ms=200.0, seed=11)
    base.update(cfg)
    res = txn.run_bench(_workload(txn, *wl), getattr(core, model),
                        txn.BenchConfig(**base))
    return dataclasses.asdict(res)


YCSB = ("ycsb", {})
STORM = dict(decision_cache=True, termination_singleflight=True,
             decision_push=True, termination_dedup=True, timeout_ms=3.0,
             retry_fresh_ids=True)
LIFECYCLE = dict(checksums=True, gc=True, scrub=True, gc_interval_ms=25.0,
                 scrub_interval_ms=40.0)

GRID = {
    # Every registered protocol on the single simulated service.
    **{f"sim-{p}": (YCSB, "AZURE_REDIS", dict(protocol=p))
       for p in ("cornus", "2pc", "cl", "cornus-opt1", "paxos-commit")},
    "sim-blob-cornus": (YCSB, "AZURE_BLOB", dict(protocol="cornus")),
    "sim-cornus-elr-skew": (("ycsb", dict(theta=0.9, keys_per_partition=200)),
                            "AZURE_REDIS", dict(protocol="cornus", elr=True)),
    # replicated-sim at R = 3, leader and coloc, on two topologies.
    **{f"r3-{p}-{m}": (YCSB, "AZURE_REDIS",
                       dict(protocol=p, replication=3, storage_mode=m))
       for p in ("cornus", "2pc") for m in ("leader", "coloc")},
    "r3-cornus-opt1": (YCSB, "AZURE_REDIS",
                       dict(protocol="cornus-opt1", replication=3)),
    "r3-paxos-commit-cross-zone": (YCSB, "AZURE_REDIS", dict(
        protocol="paxos-commit", replication=3, topology="CROSS_ZONE")),
    # Storage group commit: a fixed serial window, and "auto".
    "sim-window": (("ycsb", dict(partition_theta=0.9)), "AZURE_REDIS", dict(
        protocol="cornus", batch_window_ms=0.5, storage_serial=True)),
    "sim-auto": (("ycsb", dict(partition_theta=0.9)), "AZURE_REDIS", dict(
        protocol="2pc", batch_window_ms="auto", storage_serial=True,
        batch_max_window_ms=2.0)),
    "r3-auto": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", replication=3, batch_window_ms="auto",
        storage_serial=True, batch_max=8)),
    # The four storm controls, storm-tight static timeouts.
    "sim-storm-cornus": (YCSB, "AZURE_REDIS", dict(protocol="cornus",
                                                   **STORM)),
    "sim-storm-2pc-lanes": (YCSB, "AZURE_REDIS", dict(
        protocol="2pc", per_lane_timeouts=True, storage_serial=True,
        **STORM)),
    "r3-storm": (YCSB, "AZURE_REDIS", dict(protocol="cornus",
                                           replication=3, **STORM)),
    # Seeded fault schedules with the history checker.
    "chaos-full": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, chaos=(5, 200.0, 0, "full"),
        record_history=True, retry_fresh_ids=True)),
    "chaos-2pc-partition": (YCSB, "AZURE_REDIS", dict(
        protocol="2pc", threads_per_node=2,
        chaos=(6, 200.0, 0, "partition"), record_history=True)),
    "chaos-r3-torn": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, replication=3,
        chaos=(7, 200.0, 3, "torn"), record_history=True,
        retry_fresh_ids=True)),
    "chaos-r3-skew": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, replication=3,
        chaos=(8, 200.0, 3, "skew"), record_history=True)),
    "chaos-r3-rot-lifecycle": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, replication=3,
        chaos=(9, 200.0, 3, "rot"), record_history=True,
        retry_fresh_ids=True, lifecycle=LIFECYCLE)),
    # Lifecycle with GC and scrub, then crash-restarts on top.
    "r3-lifecycle": (YCSB, "AZURE_REDIS", dict(
        protocol="2pc", threads_per_node=2, replication=3,
        record_history=True, lifecycle=LIFECYCLE)),
    "sim-lifecycle-crash": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, record_history=True,
        retry_fresh_ids=True,
        lifecycle=dict(checksums=True, gc=True, gc_interval_ms=25.0),
        crash_restarts=(("n1", 150.0, 170.0),))),
    "sim-crash-2pc": (YCSB, "AZURE_REDIS", dict(
        protocol="2pc", threads_per_node=2, record_history=True,
        crash_restarts=(("n0", 60.0, 120.0),))),
    # Replica outages and live membership change.
    "r3-replica-failures": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", replication=3, timeout_ms=60.0,
        replica_failures=((0, 40.0, 120.0), (2, 90.0)))),
    "r3-reconfigurations": (YCSB, "AZURE_REDIS", dict(
        protocol="cornus", threads_per_node=2, replication=3,
        record_history=True, reconfigurations=((60.0, 5), (140.0, 3)),
        crash_restarts=(("n2", 80.0, 130.0),))),
    # The paper's other workloads.
    "tpcc-cornus": (("tpcc", dict(n_warehouses=4)), "AZURE_REDIS",
                    dict(protocol="cornus")),
    "tpcc-2pc-hot": (("tpcc", dict(n_warehouses=2)), "AZURE_BLOB",
                     dict(protocol="2pc", horizon_ms=400.0)),
    "geo-r3": (("geo", dict(accesses_per_txn=4)), "AZURE_REDIS", dict(
        protocol="cornus", horizon_ms=1500.0, replication=3,
        topology="CROSS_REGION", placement=GEO_PLACEMENT,
        replica_regions=["us-east", "us-west", "eu-west"],
        coordinator_nodes=["n0"], seed=7)),
}


# The one cell that the port's 2PC repair moves (ROADMAP "Deliberate
# divergences"), by field: the port's value minus the reference's.  At the
# storm-tight 3 ms timeouts a participant asks the coordinator for the
# decision while it forces its commit record; the reference's coordinator
# presumes abort (one ABORT write, its own decision ABORT) and still
# reports COMMIT to its client, while the port's answers "unknown" and the
# participant learns COMMIT when it asks again.  Every other field is equal.
REPAIR_MOVES = {"sim-storm-2pc-lanes": {"storage_requests": -1}}


@pytest.mark.parametrize("cell", sorted(GRID))
def test_bench_results_are_equal(cell):
    wl, model, cfg = GRID[cell]
    t, j = (_bench(core, txn, wl, model, cfg) for core, txn in PACKAGES)
    assert list(t) == list(j)
    moved = REPAIR_MOVES.get(cell, {})
    for key in j:
        want = j[key] + moved[key] if key in moved else j[key]
        assert t[key] == want, key
    assert t["commits"] > 0


def test_grid_reaches_every_path():
    """The grid is not vacuous: each knob it sets shows in the counters
    it drives (run on the port; the results equal the reference's)."""
    def run(cell):
        return _bench(tcore, ttxn, *GRID[cell])

    assert run("sim-window")["storage_round_trips"] < \
        run("sim-window")["storage_requests"]
    storm = run("r3-storm")
    assert storm["terminations"] > 0 and storm["decision_cache_hits"] > 0
    assert storm["singleflight_hits"] > 0 and storm["decisions_pushed"] > 0
    chaos = run("chaos-full")
    assert chaos["violations"] == 0
    assert chaos["msgs_dropped"] + chaos["msgs_delayed"] > 0
    rot = run("chaos-r3-rot-lifecycle")
    assert rot["violations"] == 0 and rot["crash_restarts"] > 0
    assert run("r3-lifecycle")["gc_truncations"] > 0
    assert run("r3-reconfigurations")["reconfig_history"]
    assert run("r3-replica-failures")["lease_acquisitions"] > 0
    crash = run("sim-crash-2pc")
    assert crash["crash_restarts"] == 1 and crash["recoveries_run"] > 0
    assert run("sim-lifecycle-crash")["recovery_spans"]


# ---------------------------------------------------------------------------
# Cluster, schedules, bundles, ChaosStore
# ---------------------------------------------------------------------------
def _cluster_script(core, proto):
    """Three transactions on one Cluster: a clean commit, a NO vote, and a
    coordinator that dies mid-round and crash-restarts; then a recovered
    participant resolving the third."""
    sim = core.Sim()
    storage = core.SimStorage(sim, core.AZURE_BLOB, seed=3)
    cl = core.Cluster(sim, storage, NODES, core.ProtocolConfig(protocol=proto))
    cl.run_txn(core.TxnSpec(txn_id="a", coordinator="n0",
                            participants=NODES))
    cl.run_txn(core.TxnSpec(txn_id="b", coordinator="n1",
                            participants=NODES,
                            votes={"n3": False}))
    spec = core.TxnSpec(txn_id="c", coordinator="n2", participants=NODES)
    cl.schedule_crash_restart("n2", 100.0 + 5.0, 400.0)
    sim._schedule(100.0, lambda: cl.run_txn(spec))
    sim._schedule(900.0, lambda: cl.recover_txn(spec, "n3"))
    sim.run(until=5_000.0)
    outcomes = {k: (_name(o.decision), o.caller_latency_ms, o.done_at_ms,
                    o.prepare_ms, o.commit_ms, o.ran_termination,
                    o.termination_ms)
                for k, o in cl.outcomes.items()}
    local = {k: _name(s.get("decision")) for k, s in cl.local.items()}
    snap = {k: _name(v) for k, v in storage.store.snapshot().items()}
    return (outcomes, local, dict(cl.blocked), snap, cl.crash_restarts,
            cl.recoveries_run, list(cl.recovery_spans), sim.now)


@pytest.mark.parametrize("proto", ["cornus", "2pc", "cl"])
def test_cluster_script_outcomes_match(proto):
    t = _cluster_script(tcore, proto)
    assert t == _cluster_script(jcore, proto)
    assert t[0]                     # outcomes were recorded


@pytest.mark.parametrize("mix", ["messages", "partition", "crash", "torn",
                                 "skew", "full", "rot"])
def test_fault_schedule_json_matches(mix):
    t = tcore.FaultSchedule.generate(13, NODES, 300.0, 3, mix)
    j = jcore.FaultSchedule.generate(13, NODES, 300.0, 3, mix)
    assert t.to_json() == j.to_json()
    assert tcore.FaultSchedule.from_json(j.to_json()).to_dict() == \
        j.to_dict()


def test_repro_bundle_round_trips_across_packages(tmp_path):
    sched = tcore.FaultSchedule.generate(4, NODES, 250.0, 0, "full")
    cfgd = {"protocol": "cornus", "seed": 4, "horizon_ms": 250.0}
    tpath = tcore.write_repro_bundle(sched, cfgd, ["[AC1] txn=t: mixed"],
                                     out_dir=str(tmp_path / "t"))
    jpath = jcore.write_repro_bundle(
        jcore.FaultSchedule.generate(4, NODES, 250.0, 0, "full"), cfgd,
        ["[AC1] txn=t: mixed"], out_dir=str(tmp_path / "j"))
    with open(tpath) as f, open(jpath) as g:
        assert f.read() == g.read()
    back, cfg2 = jcore.load_repro_bundle(tpath)
    assert back.to_dict() == sched.to_dict() and cfg2 == cfgd
    back, cfg2 = tcore.load_repro_bundle(jpath)
    assert back.to_dict() == sched.to_dict() and cfg2 == cfgd


def _chaos_store_script(core):
    store = core.ChaosStore(core.MemoryStore(), seed=21, drop_p=0.4,
                            delay_ms=0.05, jitter_ms=0.1, max_retries=3,
                            retry=core.RetryPolicy(base_ms=0.05,
                                                   max_ms=0.2))
    V = core.Vote
    trace = []
    for i in range(12):
        p, t = f"p{i % 3}", f"t{i // 3}"
        vote = V.VOTE_YES if i % 4 else V.ABORT
        trace.append(_name(store.log_once(p, t, vote, writer=f"w{i}")))
        trace.append(_name(store.log(p, f"x{i}", V.COMMIT)))
        trace.append(_name(store.read_state(p, t)))
    return (trace, store.ops_delayed, store.ops_dropped, store.retries,
            {k: _name(v) for k, v in store.snapshot().items()})


def test_chaos_store_over_memory_store_matches():
    t = _chaos_store_script(tcore)
    assert t == _chaos_store_script(jcore)
    assert t[2] > 0 and t[1] > 0    # drops and delays were injected
