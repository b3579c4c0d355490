"""Twin of ``tests/test_termination_storm.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Termination-storm controls: storage-side decision cache + singleflight +
decision push, compute-side termination dedup, adaptive (EWMA, re-arming)
timeouts, fresh retry ids — and the AnyOf subscription-leak fix they lean on.

The scenario: under a serial log lane, queueing pushes write latency past a
static protocol timeout, and every timed-out participant races a LogOnce
termination round against the same queue — load multiplies and the paper's
cornus-over-2PC ordering inverts.  The controls kill the storm on three
layers while keeping the no-failure Table-3 critical path EXACT.
"""
from __future__ import annotations

import pytest

from repro_torch.core import (AZURE_REDIS, Cluster, Decision,
                              DecisionCacheConfig, ProtocolConfig,
                              ReplicatedSimStorage, Sim, SimStorage,
                              SIMULATED_RTT_ROWS, Transport, TxnSpec, Vote,
                              measured_caller_latency_ms,
                              predicted_caller_latency_ms)
from repro_torch.txn import (AdaptiveTimeouts, BenchConfig, YCSBWorkload,
                             median_of_trials, run_bench)

ALL_ON = DecisionCacheConfig(cache=True, singleflight=True, push=True)


# ---------------------------------------------------------------------------
# Sim kernel: AnyOf detaches its subscriptions (the leak satellite)
# ---------------------------------------------------------------------------
def test_anyof_detaches_losing_subscriptions():
    """A long-lived loser event must not keep the composite's callback (and
    the composite) alive after the race is decided."""
    sim = Sim()
    slot = sim.event()                  # long-lived (like a transport slot)
    av = sim.any_of([slot, sim.timeout(1.0)])
    sim.run()
    assert av.value == (1, None)
    assert slot.callbacks == []         # detached when the timeout won


def test_transport_wait_leaves_no_slot_callbacks():
    """Every timed-out wait() on a persistent message slot detaches fully —
    long contention runs used to accumulate one dead callback per wait."""
    sim = Sim()
    tr = Transport(sim, ["a", "b"], ProtocolConfig())
    for _ in range(50):
        tr.wait("b", "t", "k", 1.0)
    sim.run()
    assert tr.slot("b", "t", "k").callbacks == []


# ---------------------------------------------------------------------------
# Re-arming waits (adaptive timeout providers)
# ---------------------------------------------------------------------------
def test_wait_rearms_when_provider_raises_deadline():
    """A wait armed while the policy was cold must stretch to the policy's
    later, higher value instead of reporting a spurious timeout."""
    sim = Sim()
    tr = Transport(sim, ["a", "b"], ProtocolConfig())
    values = iter([5.0, 20.0, 20.0, 20.0])
    ev = tr.wait("b", "t", "k", lambda: next(values))
    sim._schedule(15.0, lambda: tr.deliver("b", "t", "k", "late"))
    sim.run()
    assert ev.value == ("msg", "late")  # 15 > 5, but the deadline grew to 20

    # A plain float keeps the single-deadline behaviour exactly.
    sim2 = Sim()
    tr2 = Transport(sim2, ["a", "b"], ProtocolConfig())
    ev2 = tr2.wait("b", "t", "k", 5.0)
    sim2._schedule(15.0, lambda: tr2.deliver("b", "t", "k", "late"))
    sim2.run()
    assert ev2.value == ("timeout", None)


def test_adaptive_timeouts_policy_is_raise_only_and_capped():
    class _Stats:
        write_lat_ewma = None
        write_lat_dev = 0.0

    cold = _Stats()
    pol = AdaptiveTimeouts(cold, seed=1, jitter=0.0)
    assert pol.timeout_ms("vote", 25.0) == 25.0     # no observations: base

    warm = _Stats()
    warm.write_lat_ewma, warm.write_lat_dev = 50.0, 10.0
    pol = AdaptiveTimeouts(warm, seed=1, jitter=0.0)
    assert pol.timeout_ms("vote", 25.0) == pytest.approx(
        4.0 * 50.0 + 8.0 * 10.0)                    # tracks the EWMA
    assert pol.timeout_ms("vote", 1000.0) == 1000.0  # never below the floor

    hot = _Stats()
    hot.write_lat_ewma, hot.write_lat_dev = 10_000.0, 0.0
    pol = AdaptiveTimeouts(hot, seed=1, jitter=0.0)
    assert pol.timeout_ms("vote", 25.0) == 64.0 * 25.0   # capped

    jit = AdaptiveTimeouts(warm, seed=1, jitter=0.25)
    vals = {jit.timeout_ms("vote", 25.0) for _ in range(20)}
    lo = 4.0 * 50.0 + 8.0 * 10.0
    assert all(lo <= v < lo * 1.25 for v in vals)    # raise-only jitter
    assert len(vals) > 1                             # ...and desynchronized


def test_storage_observes_write_latency():
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=0)
    assert st.write_lat_ewma is None
    st.log("p", "t", Vote.COMMIT, writer="p")
    sim.run()
    assert st.write_lat_ewma is not None and st.write_lat_ewma > 0


# ---------------------------------------------------------------------------
# Storage-side decision cache
# ---------------------------------------------------------------------------
def test_decision_cache_answers_post_decision_log_once():
    """Once any slot of a txn holds a terminal record, a later LogOnce for
    that txn is answered from the index — no CAS runs, no slot mutates."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=0, decisions=ALL_ON)
    a = st.log_once("p1", "t", Vote.ABORT, writer="term")
    sim.run()
    assert a.value == Vote.ABORT
    b = st.log_once("p2", "t", Vote.VOTE_YES, writer="p2")
    c = st.log_once("p2", "t", Vote.ABORT, writer="another-term")
    sim.run()
    assert b.value == Vote.ABORT and c.value == Vote.ABORT
    assert st.decision_cache_hits == 2
    assert st.store.read_state("p2", "t") is None    # the CAS never ran
    # A different txn is unaffected.
    d = st.log_once("p2", "u", Vote.VOTE_YES, writer="p2")
    sim.run()
    assert d.value == Vote.VOTE_YES
    assert st.decision_cache_hits == 2


def test_decision_cache_inactive_by_default():
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=0)
    st.log_once("p1", "t", Vote.ABORT, writer="term")
    sim.run()
    b = st.log_once("p2", "t", Vote.VOTE_YES, writer="p2")
    sim.run()
    assert b.value == Vote.VOTE_YES                  # full CAS, no cache
    assert st.decision_cache_hits == 0
    assert st.store.read_state("p2", "t") == Vote.VOTE_YES


def test_replicated_decision_cache_skips_the_paxos_round():
    sim = Sim()
    st = ReplicatedSimStorage(sim, AZURE_REDIS, n_replicas=3, seed=0,
                              decisions=ALL_ON)
    a = st.log_once("p1", "t", Vote.ABORT, writer="term")
    sim.run()
    assert a.value == Vote.ABORT
    rounds_before = st.round_trips
    b = st.log_once("p2", "t", Vote.VOTE_YES, writer="p2")
    sim.run()
    assert b.value == Vote.ABORT
    assert st.decision_cache_hits == 1
    assert st.round_trips == rounds_before           # no quorum scatter paid


def test_singleflight_coalesces_identical_inflight_cas():
    """Two racing terminators CASing the same value into one slot share ONE
    round; content and writer are exactly what back-to-back CASes give."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=1,
                    decisions=DecisionCacheConfig(singleflight=True))
    a = st.log_once("p", "t", Vote.ABORT, writer="t1")
    b = st.log_once("p", "t", Vote.ABORT, writer="t2")
    sim.run()
    assert a.value == Vote.ABORT and b.value == Vote.ABORT
    assert st.singleflight_hits == 1
    assert st.round_trips == 1
    assert st.store.writer_of("p", "t") == "t1"


def test_watch_decision_fires_once_on_first_terminal_record():
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=0, decisions=ALL_ON)
    got = []
    st.watch_decision("t", got.append)
    st.log_once("p1", "t", Vote.VOTE_YES, writer="p1")   # not terminal
    sim.run()
    assert got == []
    st.log_once("p2", "t", Vote.ABORT, writer="term")
    st.log("p1", "t", Vote.ABORT, writer="p1")
    sim.run()
    assert got == [Vote.ABORT]                       # first terminal only
    late = []
    st.watch_decision("t", late.append)              # already decided
    assert late == [Vote.ABORT]
    assert st.decisions_pushed == 2


# ---------------------------------------------------------------------------
# Protocol integration: push prevents terminations, cache absorbs the rest
# ---------------------------------------------------------------------------
def _dead_participant_cluster(push: bool, seed: int = 2):
    """n2 dies before voting: the coordinator's vote wait times out and it
    runs the termination protocol; n1 is left waiting for the decision."""
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=seed, decisions=ALL_ON)
    nodes = ["n0", "n1", "n2"]
    cfg = ProtocolConfig(protocol="cornus", push_decisions=push,
                         termination_dedup=True)
    cl = Cluster(sim, storage, nodes, cfg)
    cl.fail("n2", 0.0)
    cl.run_txn(TxnSpec(txn_id="t", coordinator="n0", participants=nodes))
    sim.run(until=10_000.0)
    decisions = {n: s["decision"] for (n, t), s in cl.local.items()
                 if s["decision"] is not None}
    return cl, storage, decisions


def test_decision_push_spares_waiting_participants_the_termination():
    cl_off, st_off, d_off = _dead_participant_cluster(push=False)
    cl_on, st_on, d_on = _dead_participant_cluster(push=True)
    # Same decisions either way (the push changes round trips, not outcomes)
    assert d_on == d_off == {"n0": Decision.ABORT, "n1": Decision.ABORT}
    # Without push n1 times out and terminates too; its whole round is
    # answered from the decision cache (the coordinator's ABORT landed).
    assert cl_off.ctx.terminations == 2
    assert st_off.decision_cache_hits > 0
    # With push the coordinator's first terminal CAS is delivered straight
    # into n1's decision slot: only ONE termination ever runs.
    assert cl_on.ctx.terminations == 1
    assert st_on.decisions_pushed >= 1


def test_termination_dedup_joins_inflight_run():
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=3, decisions=ALL_ON)
    nodes = ["n0", "n1", "n2"]
    cfg = ProtocolConfig(protocol="cornus", termination_dedup=True)
    cl = Cluster(sim, storage, nodes, cfg)
    spec = TxnSpec(txn_id="t", coordinator="n0", participants=nodes)
    cl.fail("n0", 0.0)                  # coordinator never sends a decision
    from repro_torch.core import TxnOutcome
    outs = [TxnOutcome(txn_id="t", node="n1",
                       decision=Decision.UNDETERMINED) for _ in range(3)]
    procs = [sim.process(cl.protocol.run_termination(spec, "n1", o))
             for o in outs]
    sim.run(until=10_000.0)
    got = {p.value for p in procs}
    assert got == {Decision.ABORT}      # one run, one shared decision
    assert cl.ctx.terminations == 1
    assert cl.ctx.dedup_hits == 2
    assert cl.ctx.term_inflight == {}   # cleaned up


# ---------------------------------------------------------------------------
# Table 3 stays EXACT with the full storm-control stack enabled
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("row", sorted(SIMULATED_RTT_ROWS))
def test_table3_exact_with_storm_controls_enabled(row):
    """On the no-failure critical path none of the storm machinery may
    fire: the measured caller latency lands EXACTLY on the predicted
    Table-3 RTT multiple (equality, not a tolerance)."""
    measured = measured_caller_latency_ms(row, 20.0, storm_control=True)
    assert measured == predicted_caller_latency_ms(row, 20.0)


# ---------------------------------------------------------------------------
# The storm itself: before/after on the nobatch serial lane
# ---------------------------------------------------------------------------
def _contention_wl(nodes, seed):
    return YCSBWorkload(nodes, accesses_per_txn=4, partition_theta=0.9,
                        keys_per_partition=10_000, seed=seed)


STORM_CONTROL = dict(decision_cache=True, termination_singleflight=True,
                     decision_push=True, termination_dedup=True,
                     retry_fresh_ids=True)


def test_storm_controls_restore_cornus_over_2pc_on_nobatch():
    """The acceptance scenario in miniature: R=3 serial nobatch lanes under
    hot-partition skew.  Static no-load timeouts storm (few commits, many
    terminations); with the controls on, terminations vanish, throughput
    recovers by an order of magnitude, and cornus is no longer behind 2PC."""
    def run(proto, **kw):
        cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=8,
                          horizon_ms=300.0, replication=3, seed=3,
                          storage_serial=True, batch_max=1, **kw)
        return run_bench(_contention_wl, AZURE_REDIS, cfg)

    stormy = run("cornus", timeout_ms=25.0)          # the old static world
    cornus = run("cornus", **STORM_CONTROL)          # adaptive + controls
    twopc = run("2pc", **STORM_CONTROL)
    assert stormy.terminations > 20                  # the storm is real
    assert cornus.terminations <= 2
    assert cornus.commits >= 5 * max(stormy.commits, 1)
    assert cornus.commits >= twopc.commits           # paper ordering holds
    assert cornus.gaveups == 0


def test_retry_fresh_ids_unpoisons_terminated_txns():
    """A quorum outage forces in-flight txns through termination-ABORT;
    their LogOnce slots stay terminal forever.  Retrying the same txn id
    can then only re-abort (burning every attempt into a gaveup); a fresh
    incarnation id commits once storage recovers."""
    def run(fresh):
        def wl(nodes, seed):
            return YCSBWorkload(nodes, accesses_per_txn=4, seed=seed)
        cfg = BenchConfig(protocol="cornus", n_nodes=2, threads_per_node=1,
                          horizon_ms=400.0, replication=3, seed=5,
                          timeout_ms=20.0, max_attempts=10,
                          retry_fresh_ids=fresh,
                          replica_failures=((0, 0.0, 100.0),
                                            (1, 0.0, 100.0)))
        return run_bench(wl, AZURE_REDIS, cfg)

    stale, fresh = run(False), run(True)
    assert stale.gaveups >= 1                        # poisoned ids give up
    assert fresh.gaveups == 0
    assert fresh.commits > stale.commits


# ---------------------------------------------------------------------------
# Counters + percentiles ride BenchResult / breakdown()
# ---------------------------------------------------------------------------
def test_benchresult_percentiles_and_counters():
    cfg = BenchConfig(protocol="cornus", n_nodes=4, threads_per_node=8,
                      horizon_ms=300.0, replication=3, seed=3,
                      storage_serial=True, batch_max=1, **STORM_CONTROL)
    r = run_bench(_contention_wl, AZURE_REDIS, cfg)
    assert r.commits > 0
    assert 0 < r.p50_latency_ms <= r.p95_latency_ms <= r.p99_latency_ms
    bd = r.breakdown()
    assert bd["p50"] == r.p50_latency_ms and bd["p95"] == r.p95_latency_ms
    assert r.decisions_pushed > 0
    for f in ("terminations", "dedup_hits", "decision_cache_hits",
              "singleflight_hits"):
        assert getattr(r, f) >= 0


# ---------------------------------------------------------------------------
# median_of_trials: process fan-out is bit-identical to serial
# ---------------------------------------------------------------------------
@pytest.mark.filterwarnings("ignore:os.fork")
def test_median_of_trials_parallel_matches_serial():
    cfg = BenchConfig(protocol="cornus", n_nodes=4, horizon_ms=120.0, seed=7)
    wl = lambda nodes, seed: YCSBWorkload(nodes, seed=seed)
    serial = median_of_trials(wl, AZURE_REDIS, cfg, trials=3, processes=1)
    par = median_of_trials(wl, AZURE_REDIS, cfg, trials=3, processes=3)
    assert serial.commits == par.commits
    assert serial.avg_latency_ms == par.avg_latency_ms
    assert serial.latencies == par.latencies


def test_median_of_trials_stays_serial_once_cuda_started(monkeypatch):
    """The port's fork rule: without an explicit ``processes``, trials run
    serially in a process whose torch has started CUDA (the reference goes
    serial whenever jax is imported), with the serial result."""
    import sys
    import types

    import repro_torch.txn.executor as executor

    cfg = BenchConfig(protocol="cornus", n_nodes=4, horizon_ms=60.0, seed=7)
    wl = lambda nodes, seed: YCSBWorkload(nodes, seed=seed)
    serial = median_of_trials(wl, AZURE_REDIS, cfg, trials=3, processes=1)
    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", fake)
    assert executor._cuda_started()

    def no_fork(*a, **k):
        raise AssertionError("forked a process that has started CUDA")

    monkeypatch.setattr(executor.multiprocessing, "get_context", no_fork)
    guarded = median_of_trials(wl, AZURE_REDIS, cfg, trials=3)
    assert guarded.latencies == serial.latencies
    assert guarded.avg_latency_ms == serial.avg_latency_ms
