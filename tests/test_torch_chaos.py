"""Twin of ``tests/test_chaos.py`` on the port's modules (``repro_torch.core``
/ ``repro_torch.txn``): the same assertions on the same seeds.

Chaos plane (core.chaos) + atomicity checker (core.history).

Covers the fault-injection machinery in isolation (schedules, nemesis
plans, retry policy, circuit breaker, threaded-store decorator, repro
bundles), the idempotent delivery guard, the checker's detection of each
violation class on crafted evidence, and end-to-end chaotic runs that must
come out machine-certified (zero AC1–AC3 / writer-of / recoverability
violations).
"""
import json
import os
from types import SimpleNamespace

import pytest

from conftest import hypothesis_or_stubs
from repro_torch.core import (AZURE_REDIS, Cluster, Decision, MemoryStore,
                              ProtocolConfig, Sim, TxnSpec, Vote)
from repro_torch.core.chaos import (ChaosStore, CircuitBreaker, FaultSchedule,
                                    Nemesis, RetryPolicy, load_repro_bundle,
                                    write_repro_bundle)
from repro_torch.core.history import (HistoryRecorder, check_history,
                                      collect_decisions)
from repro_torch.core.protocols.transport import Transport
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

wl = lambda nodes, seed: YCSBWorkload(nodes, seed=seed)
NODES = ["n0", "n1", "n2", "n3"]


# ---------------------------------------------------------------------------
# FaultSchedule: determinism + serialization
# ---------------------------------------------------------------------------
def test_schedule_generation_is_deterministic():
    a = FaultSchedule.generate(7, NODES, 500.0, 3, "full")
    b = FaultSchedule.generate(7, NODES, 500.0, 3, "full")
    assert a.to_dict() == b.to_dict()
    c = FaultSchedule.generate(8, NODES, 500.0, 3, "full")
    assert a.to_dict() != c.to_dict()


@pytest.mark.parametrize("mix", ["messages", "partition", "crash", "torn",
                                 "skew", "full"])
def test_schedule_json_round_trip(mix):
    sched = FaultSchedule.generate(3, NODES, 400.0, 3, mix)
    back = FaultSchedule.from_json(sched.to_json())
    assert back.to_dict() == sched.to_dict()


def test_schedule_generate_rejects_unknown_mix():
    with pytest.raises(ValueError, match="unknown fault mix"):
        FaultSchedule.generate(0, NODES, 100.0, 0, "nonsense")


# ---------------------------------------------------------------------------
# Nemesis plans: partitions, torn writes, clock skew
# ---------------------------------------------------------------------------
def _nemesis(**kw):
    sim = Sim()
    sched = FaultSchedule(seed=1, **kw)
    return sim, Nemesis(sched, sim)


def test_partition_cuts_links_then_heals():
    from repro_torch.core.chaos import NetPartition
    sim, nem = _nemesis(partitions=[NetPartition(
        at=10.0, heal_at=50.0, side_a=("n0",), side_b=("n1",),
        symmetric=True)])
    sim._schedule(20.0, lambda: None)
    sim.run(until=20.0)
    assert nem.message_plan("n0", "n1") is None      # cut
    assert nem.message_plan("n1", "n0") is None      # symmetric
    assert nem.message_plan("n0", "n2") is not None  # unaffected link
    sim._schedule(60.0, lambda: None)
    sim.run(until=60.0)
    assert nem.message_plan("n0", "n1") is not None  # healed


def test_torn_write_keeps_prefix_inside_window_only():
    from repro_torch.core.chaos import TornWrite
    sim, nem = _nemesis(torn=[TornWrite(at=5.0, until=30.0, p=1.0, keep=1)])
    sim._schedule(10.0, lambda: None)
    sim.run(until=10.0)
    assert nem.torn_targets([0, 1, 2]) == [0]
    sim._schedule(40.0, lambda: None)
    sim.run(until=40.0)
    assert nem.torn_targets([0, 1, 2]) == [0, 1, 2]


def test_clock_skew_active_inside_window_only():
    from repro_torch.core.chaos import ClockSkew
    sim, nem = _nemesis(skews=[ClockSkew(at=5.0, until=30.0, skew_ms=25.0)])
    assert nem.skew_ms() == 0.0
    sim._schedule(10.0, lambda: None)
    sim.run(until=10.0)
    assert nem.skew_ms() == 25.0
    sim._schedule(40.0, lambda: None)
    sim.run(until=40.0)
    assert nem.skew_ms() == 0.0


# ---------------------------------------------------------------------------
# Idempotent delivery guard (transport regression)
# ---------------------------------------------------------------------------
def test_duplicate_slot_delivery_is_suppressed_and_counted():
    sim = Sim()
    tr = Transport(sim, ["n0", "n1"], ProtocolConfig())
    assert tr._deliver_guarded("n0", "t", "decision", Decision.COMMIT,
                               batch=True)
    assert not tr._deliver_guarded("n0", "t", "decision", Decision.COMMIT,
                                   batch=True)
    assert tr.deliveries == 1
    assert tr.duplicate_deliveries == 1
    assert tr.slot("n0", "t", "decision").value == Decision.COMMIT


# ---------------------------------------------------------------------------
# Retry policy + circuit breaker
# ---------------------------------------------------------------------------
def test_retry_policy_backoff_is_jittered_exponential():
    import random
    pol = RetryPolicy(base_ms=4.0, factor=2.0, max_ms=64.0)
    rng = random.Random(0)
    for attempt in range(1, 9):
        raw = min(4.0 * 2.0 ** (attempt - 1), 64.0)
        b = pol.backoff_ms(attempt, rng)
        assert 0.5 * raw <= b <= 1.5 * raw


def test_circuit_breaker_trips_half_opens_and_recloses():
    br = CircuitBreaker(threshold=3, cooldown_ms=40.0)
    assert br.state("p") == CircuitBreaker.CLOSED
    for _ in range(3):
        br.note_failure("p", now=0.0)
    assert br.state("p") == CircuitBreaker.OPEN
    assert br.trips == 1
    assert br.admission_delay_ms("p", now=10.0) > 0.0  # held out while OPEN
    assert br.admission_delay_ms("p", now=100.0) == 0.0  # cooldown elapsed
    assert br.state("p") == CircuitBreaker.HALF_OPEN
    assert br.half_opens == 1
    br.note_success("p")
    assert br.state("p") == CircuitBreaker.CLOSED
    br.note_failure("p", now=200.0)                # single failure: stays
    assert br.state("p") == CircuitBreaker.CLOSED
    assert br.state("q") == CircuitBreaker.CLOSED  # per-partition isolation


def test_circuit_breaker_failed_probe_retrips():
    br = CircuitBreaker(threshold=2, cooldown_ms=10.0)
    br.note_failure("p", now=0.0)
    br.note_failure("p", now=0.0)
    assert br.state("p") == CircuitBreaker.OPEN
    assert br.admission_delay_ms("p", now=20.0) == 0.0   # half-open probe
    br.note_failure("p", now=20.0)                       # probe failed
    assert br.state("p") == CircuitBreaker.OPEN
    assert br.trips == 2


# ---------------------------------------------------------------------------
# Threaded-store chaos decorator
# ---------------------------------------------------------------------------
def test_chaos_store_drops_retry_then_force_through():
    store = ChaosStore(MemoryStore(), seed=3, drop_p=1.0, max_retries=2,
                       retry=RetryPolicy(base_ms=0.01, max_ms=0.02))
    assert store.log_once("p", "t", Vote.VOTE_YES,
                          writer="p") == Vote.VOTE_YES
    assert store.ops_dropped > 0
    assert store.retries > 0
    # Dropped attempts never mutate state twice: slot decided exactly once.
    assert store.read_state("p", "t") == Vote.VOTE_YES


def test_chaos_store_injects_delay():
    store = ChaosStore(MemoryStore(), seed=1, delay_ms=0.1)
    assert store.log_once("p", "t", Vote.ABORT, writer="q") == Vote.ABORT
    assert store.ops_delayed > 0


def test_store_config_wraps_chaos_store():
    from repro_torch.core import StoreConfig, build_store
    plain = build_store(StoreConfig(backend="memory"))
    assert not isinstance(plain, ChaosStore)
    wrapped = build_store(StoreConfig(backend="memory", chaos_drop_p=0.5))
    assert isinstance(wrapped, ChaosStore)


# ---------------------------------------------------------------------------
# Failure-repro bundles
# ---------------------------------------------------------------------------
def test_repro_bundle_round_trip(tmp_path):
    sched = FaultSchedule.generate(5, NODES, 200.0, 3, "full")
    cfgd = {"protocol": "cornus", "seed": 5, "horizon_ms": 200.0}
    path = write_repro_bundle(sched, cfgd, ["[AC1] txn=t: mixed"],
                              out_dir=str(tmp_path))
    with open(path) as f:
        payload = json.load(f)
    assert payload["schema"] == 1
    assert payload["violations"] == ["[AC1] txn=t: mixed"]
    back, cfg2 = load_repro_bundle(path)
    assert back.to_dict() == sched.to_dict()
    assert cfg2 == cfgd


def test_repro_bundle_honours_env_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CHAOS_REPRO_DIR", str(tmp_path / "failures"))
    sched = FaultSchedule.generate(1, NODES, 100.0, 0, "messages")
    path = write_repro_bundle(sched, {"protocol": "2pc"}, [])
    assert path.startswith(str(tmp_path / "failures"))
    assert os.path.exists(path)


# ---------------------------------------------------------------------------
# Checker: each violation class on crafted evidence
# ---------------------------------------------------------------------------
def _ctx(local=None, outcomes=None, specs=None):
    return SimpleNamespace(local=local or {}, outcomes=outcomes or {},
                           specs=specs or {})


def _spec(txn="t", coordinator="n0", participants=("n0", "n1"),
          read_only=(), **kw):
    return TxnSpec(txn_id=txn, coordinator=coordinator,
                   participants=list(participants),
                   read_only=frozenset(read_only), **kw)


def test_checker_flags_mixed_decisions_ac1():
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT},
                      ("n1", "t"): {"decision": Decision.ABORT}},
               specs={"t": _spec()})
    rules = [v.rule for v in check_history(None, ctx)]
    assert "AC1" in rules


def test_checker_flags_commit_over_no_vote_ac2():
    spec = _spec(votes={"n1": False})
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT},
                      ("n1", "t"): {"decision": Decision.COMMIT}},
               specs={"t": spec})
    rules = [v.rule for v in check_history(None, ctx)]
    assert "AC2" in rules


def test_checker_flags_changed_decision_ac3():
    out = SimpleNamespace(decision=Decision.ABORT)
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT}},
               outcomes={("t", "n0:recovery"): out},
               specs={"t": _spec(participants=("n0",))})
    rules = [v.rule for v in check_history(None, ctx)]
    assert "AC3" in rules


def test_checker_flags_foreign_yes_vote_writer_of():
    sim = Sim()
    hist = HistoryRecorder(sim)
    ev = sim.event()
    hist.record(ev, "log_once", "n1", "t", Vote.VOTE_YES, writer="n2")
    ev.trigger(Vote.VOTE_YES)
    sim.run(until=1.0)
    rules = [v.rule for v in check_history(hist, _ctx())]
    assert "writer-of" in rules


def test_checker_flags_unrecoverable_commit():
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT},
                      ("n1", "t"): {"decision": Decision.COMMIT}},
               specs={"t": _spec()})
    viols = check_history(None, ctx,
                          snapshot={("n0", "t"): Vote.COMMIT})  # n1 missing
    assert any(v.rule == "recoverability" for v in viols)


def test_checker_recoverability_consults_coordinator_for_cl():
    """participant_logs=False (CL): empty participant slots are BY DESIGN;
    only the coordinator's batched record certifies recoverability."""
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT},
                      ("n1", "t"): {"decision": Decision.COMMIT}},
               specs={"t": _spec()})
    snap = {("n0", "t"): Vote.COMMIT}
    assert not [v for v in check_history(None, ctx, snapshot=snap,
                                         participant_logs=False)]
    assert [v.rule for v in check_history(None, ctx, snapshot={},
                                          participant_logs=False)] \
        == ["recoverability"]


def test_checker_ignores_read_only_participants_trivial_commit():
    """§3.6: a known-upfront read-only participant concludes COMMIT the
    moment its reads finish — that conclusion carries no information and
    must not count as disagreement."""
    spec = _spec(participants=("n0", "n1", "n2"), read_only=("n2",))
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.ABORT},
                      ("n1", "t"): {"decision": Decision.ABORT},
                      ("n2", "t"): {"decision": Decision.COMMIT}},
               specs={"t": spec})
    assert check_history(None, ctx) == []


def test_collect_decisions_merges_live_and_recovery():
    out = SimpleNamespace(decision=Decision.COMMIT)
    und = SimpleNamespace(decision=Decision.UNDETERMINED)
    ctx = _ctx(local={("n0", "t"): {"decision": Decision.COMMIT}},
               outcomes={("t", "n1:recovery"): out, ("t", "n2"): und})
    d = collect_decisions(ctx)
    assert d == {"t": {"n0": Decision.COMMIT,
                       "n1:recovery": Decision.COMMIT}}


# ---------------------------------------------------------------------------
# End-to-end: chaotic runs come out machine-certified
# ---------------------------------------------------------------------------
def _chaotic(proto, seed, mix="full", replication=1, horizon=300.0):
    sched = FaultSchedule.generate(seed, NODES, horizon,
                                   replication if replication > 1 else 0,
                                   mix)
    cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=2,
                      horizon_ms=horizon, seed=seed,
                      replication=replication, retry_fresh_ids=True,
                      chaos=sched, record_history=True)
    return run_bench(wl, AZURE_REDIS, cfg)


@pytest.mark.parametrize("proto", ["cornus", "2pc"])
def test_chaotic_run_certified_and_fault_counters_wired(proto):
    res = _chaotic(proto, seed=1)
    assert res.violations == 0, res.violation_details
    assert res.commits > 0
    assert res.gaveups == 0
    assert res.msgs_dropped + res.msgs_delayed + res.msgs_duplicated > 0
    assert res.crash_restarts > 0 and res.recoveries_run > 0
    bd = res.breakdown()
    for key in ("msgs_dropped", "duplicate_deliveries", "guard_retries",
                "breaker_trips", "crash_restarts", "recoveries_run",
                "violations", "torn_writes"):
        assert key in bd


def test_chaotic_run_replicated_torn_writes_certified():
    res = _chaotic("cornus", seed=2, replication=3)
    assert res.violations == 0, res.violation_details
    assert res.torn_writes > 0
    assert res.commits > 0


def test_chaos_runs_are_deterministic():
    a = _chaotic("cornus", seed=4, mix="messages")
    b = _chaotic("cornus", seed=4, mix="messages")
    assert (a.commits, a.aborts, a.msgs_dropped, a.msgs_delayed,
            a.recoveries_run) == \
           (b.commits, b.aborts, b.msgs_dropped, b.msgs_delayed,
            b.recoveries_run)


def test_no_chaos_run_reports_checker_not_run_and_zero_counters():
    cfg = BenchConfig(protocol="cornus", n_nodes=4, threads_per_node=2,
                      horizon_ms=100.0, seed=0)
    res = run_bench(wl, AZURE_REDIS, cfg)
    assert res.violations == -1            # checker not armed
    assert res.msgs_dropped == 0 and res.guard_retries == 0
    assert res.crash_restarts == 0


def test_message_duplication_suppressed_by_delivery_guard():
    from repro_torch.core.chaos import LinkChaos
    sched = FaultSchedule(seed=9, links=[LinkChaos(
        src="*", dst="*", at=0.0, until=300.0, dup_p=1.0)])
    cfg = BenchConfig(protocol="cornus", n_nodes=4, threads_per_node=2,
                      horizon_ms=300.0, seed=9, retry_fresh_ids=True,
                      chaos=sched, record_history=True)
    res = run_bench(wl, AZURE_REDIS, cfg)
    assert res.violations == 0, res.violation_details
    assert res.msgs_duplicated > 0
    assert res.duplicate_deliveries > 0    # the guard absorbed the copies


# ---------------------------------------------------------------------------
# Property: any generated schedule keeps the run certified (repro bundle
# written on failure so the seed can be replayed)
# ---------------------------------------------------------------------------
@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
@given(seed=st.integers(min_value=0, max_value=10_000),
       mix=st.sampled_from(["messages", "partition", "crash", "full"]))
@settings(max_examples=8, deadline=None)
def test_property_chaos_never_violates_atomicity(seed, mix):
    res = _chaotic("cornus", seed=seed, mix=mix, horizon=200.0)
    if res.violations:
        sched = FaultSchedule.generate(seed, NODES, 200.0, 0, mix)
        path = write_repro_bundle(
            sched, {"protocol": "cornus", "n_nodes": 4,
                    "threads_per_node": 2, "horizon_ms": 200.0,
                    "seed": seed, "replication": 1,
                    "retry_fresh_ids": True},
            res.violation_details)
        raise AssertionError(
            f"violations under seed={seed} mix={mix} "
            f"(repro bundle: {path}): {res.violation_details}")
