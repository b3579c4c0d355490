"""Twin of ``tests/test_store_parity.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Sim-vs-threaded store parity: the SAME operation schedule replayed on
``SimStorage`` (discrete-event) and ``MemoryStore`` (real threads' store)
must converge to the SAME log state, writer winners, derived decisions —
and, with the unified control plane on, the same decision-cache counters.

Plus properties of the threaded control plane under genuinely concurrent
racing terminators: one winner per slot, txn-level agreement, and counter
conservation (every ``log_once`` call is exactly one of performed /
cache-answered / singleflight-joined).  Property-based when hypothesis is
installed; seeded deterministic versions always run.
"""
from __future__ import annotations

import random
import threading
import time

import pytest

from conftest import hypothesis_or_stubs

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

from repro_torch.core import (AZURE_REDIS, Decision, DecisionCacheConfig,
                              MemoryStore, Sim, SimStorage, Vote,
                              global_decision)

ALL_ON = DecisionCacheConfig(cache=True, singleflight=True, push=True)
NODES = ["p0", "p1", "p2", "p3"]


# ---------------------------------------------------------------------------
# Differential parity: one schedule, two backends
# ---------------------------------------------------------------------------
def make_schedule(seed: int, n_txns: int = 6):
    """Deterministic interleaved op list: per txn, participants CAS their
    VOTE-YES while a terminator may CAS ABORT anywhere in the sequence."""
    rng = random.Random(seed)
    ops = []
    for t in range(n_txns):
        txn = f"t{t}"
        parts = rng.sample(NODES, rng.randint(2, len(NODES)))
        txn_ops = [("vote", p, txn, p) for p in parts]
        if rng.random() < 0.5:
            terminator = rng.choice(parts)
            # The terminator CASes ABORT into EVERY slot (Algorithm 1).
            txn_ops += [("term", p, txn, terminator) for p in parts]
        rng.shuffle(txn_ops)
        ops.append((txn, parts, txn_ops))
    # Interleave txns' ops into one global schedule.
    flat = [op for _, _, txn_ops in ops for op in txn_ops]
    rng.shuffle(flat)
    return ops, flat


def replay_threaded(flat, decisions):
    store = MemoryStore(decisions=decisions)
    for kind, p, txn, writer in flat:
        store.log_once(p, txn, Vote.VOTE_YES if kind == "vote"
                       else Vote.ABORT, writer=writer)
    return store


def replay_sim(flat, decisions):
    sim = Sim()
    store = SimStorage(sim, AZURE_REDIS, seed=0, decisions=decisions)

    # Strictly sequential arrival (each op starts only after the previous
    # completed), so the schedule ORDER — not sim timing — decides races,
    # exactly like the sequential threaded replay.
    def runner():
        for kind, p, txn, writer in flat:
            yield store.log_once(p, txn, Vote.VOTE_YES if kind == "vote"
                                 else Vote.ABORT, writer=writer)

    sim.process(runner())
    sim.run(until=len(flat) * 1000.0 + 10_000.0)
    # SimStorage's ground truth lives in its inner MemoryStore: return that
    # (with the sim service's counters grafted on) so assertions read both
    # backends through one synchronous surface.
    inner = store.store
    inner.sim_decision_cache_hits = store.decision_cache_hits
    inner.sim_singleflight_hits = store.singleflight_hits
    return inner


def outcome_of(store, parts, txn):
    states = {p: store.read_state(p, txn) for p in parts}
    return global_decision(states, parts)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("storm", [False, True])
def test_same_schedule_same_state_and_decisions(seed, storm):
    decisions = ALL_ON if storm else None
    ops, flat = make_schedule(seed)
    threaded = replay_threaded(flat, decisions)
    simmed = replay_sim(flat, decisions)
    for txn, parts, _ in ops:
        for p in parts:
            assert threaded.read_state(p, txn) == simmed.read_state(p, txn)
            assert threaded.writer_of(p, txn) == simmed.writer_of(p, txn)
        assert outcome_of(threaded, parts, txn) == \
            outcome_of(simmed, parts, txn)
    if storm:
        # Same schedule, same control-plane semantics: identical counters.
        assert threaded.decision_cache_hits == simmed.sim_decision_cache_hits
        assert threaded.singleflight_hits == simmed.sim_singleflight_hits


if HAS_HYPOTHESIS:
    @given(seed=st.integers(min_value=0, max_value=10_000))
    @settings(max_examples=25, deadline=None)
    def test_parity_property(seed):
        ops, flat = make_schedule(seed)
        threaded = replay_threaded(flat, ALL_ON)
        simmed = replay_sim(flat, ALL_ON)
        for txn, parts, _ in ops:
            assert outcome_of(threaded, parts, txn) == \
                outcome_of(simmed, parts, txn)
            for p in parts:
                assert threaded.writer_of(p, txn) == simmed.writer_of(p, txn)
        assert threaded.decision_cache_hits == simmed.sim_decision_cache_hits


# ---------------------------------------------------------------------------
# Threaded control plane under racing terminators
# ---------------------------------------------------------------------------
class _GatedStore(MemoryStore):
    """MemoryStore whose CAS parks until released — forces genuine overlap
    so singleflight joins are deterministic, not a race lottery."""

    def __init__(self, decisions=None):
        super().__init__(decisions=decisions)
        self.gate = threading.Event()

    def _log_once_direct(self, partition, txn, state, writer=""):
        self.gate.wait(timeout=5.0)
        return super()._log_once_direct(partition, txn, state, writer)


def test_singleflight_joins_and_cache_hits_deterministic():
    store = _GatedStore(decisions=ALL_ON)
    results = []

    def call():
        results.append(store.log_once("p0", "t0", Vote.ABORT, writer="w"))

    racers = [threading.Thread(target=call) for _ in range(4)]
    for r in racers:
        r.start()
    time.sleep(0.05)                     # all four are in log_once now
    store.gate.set()
    for r in racers:
        r.join()
    # One leader performed, three joined its in-flight round.
    assert store.cas_attempts == 1
    assert store.singleflight_hits == 3
    assert results == [Vote.ABORT] * 4
    # The txn now holds a terminal record: later calls are cache hits, the
    # op itself never runs (cas_attempts unchanged).
    assert store.log_once("p1", "t0", Vote.VOTE_YES, writer="p1") \
        == Vote.ABORT
    assert store.decision_cache_hits == 1
    assert store.cas_attempts == 1


def test_singleflight_joiners_share_leader_exception():
    class _Exploding(_GatedStore):
        def _log_once_direct(self, partition, txn, state, writer=""):
            self.gate.wait(timeout=5.0)
            raise RuntimeError("quorum lost mid-round")

    store = _Exploding(decisions=ALL_ON)
    errors = []

    def call():
        try:
            store.log_once("p0", "t0", Vote.ABORT, writer="w")
        except RuntimeError as e:
            errors.append(str(e))

    racers = [threading.Thread(target=call) for _ in range(3)]
    for r in racers:
        r.start()
    time.sleep(0.05)
    store.gate.set()
    for r in racers:
        r.join()
    # A joiner of a failed round must NOT pretend it succeeded.
    assert errors == ["quorum lost mid-round"] * 3


def race_terminators(seed: int, racers: int = 4, slots: int = 3):
    """Concurrent voter + ABORT racers over one txn's slots; returns the
    store and every caller's observed return value."""
    rng = random.Random(seed)
    store = MemoryStore(decisions=ALL_ON)
    parts = [f"p{i}" for i in range(slots)]
    txn = "t0"
    observed = []
    lock = threading.Lock()

    def voter():
        for p in parts:
            time.sleep(rng.random() * 1e-3)
            got = store.log_once(p, txn, Vote.VOTE_YES, writer=p)
            with lock:
                observed.append((p, Vote.VOTE_YES, got))

    def terminator(tid):
        r = random.Random(seed * 997 + tid)
        for p in sorted(parts, key=lambda _: r.random()):
            time.sleep(r.random() * 1e-3)
            got = store.log_once(p, txn, Vote.ABORT, writer=f"term{tid}")
            with lock:
                observed.append((p, Vote.ABORT, got))

    threads = [threading.Thread(target=voter)] + \
        [threading.Thread(target=terminator, args=(t,))
         for t in range(racers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return store, parts, txn, observed


def check_race_invariants(store, parts, txn, observed, calls):
    finals = {p: store.read_state(p, txn) for p in parts}
    # Terminal txn decision, if any (ABORT is the only decision written).
    terminal = Vote.ABORT if any(v == Vote.ABORT for v in finals.values()) \
        else None
    # One winner per slot: every observed return is the slot's final value
    # or the txn's terminal decision (a cache answer) — never a third value.
    for p, _attempt, got in observed:
        assert got in {finals[p], terminal} - {None}
    # writer_of consistent with the recorded value's writer kind.
    for p in parts:
        w = store.writer_of(p, txn)
        assert (finals[p] == Vote.ABORT) == (w is not None
                                             and w.startswith("term"))
    # Counter conservation: performed + cache-answered + joined == calls.
    assert store.cas_attempts + store.decision_cache_hits + \
        store.singleflight_hits == calls


@pytest.mark.parametrize("seed", range(6))
def test_racing_terminators_invariants(seed):
    racers, slots = 4, 3
    store, parts, txn, observed = race_terminators(seed, racers, slots)
    check_race_invariants(store, parts, txn, observed,
                          calls=slots * (racers + 1))


if HAS_HYPOTHESIS:
    @given(seed=st.integers(min_value=0, max_value=10_000),
           racers=st.integers(min_value=1, max_value=6),
           slots=st.integers(min_value=1, max_value=4))
    @settings(max_examples=20, deadline=None)
    def test_racing_terminators_property(seed, racers, slots):
        store, parts, txn, observed = race_terminators(seed, racers, slots)
        check_race_invariants(store, parts, txn, observed,
                              calls=slots * (racers + 1))
