"""Twin of ``tests/test_batch_properties.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Property-based tests of group-commit invisibility.

Hypothesis drives random cluster sizes, vote assignments, batch windows and
interleavings through the deterministic sim and asserts the batching layer's
contract: batched and unbatched runs produce identical commit/abort outcomes
and identical ``writer_of`` winners per slot (absent failures, where only
timing may differ), and under arbitrary failure schedules batching never
breaks atomic-commit agreement.
"""
from __future__ import annotations

import pytest

from conftest import hypothesis_or_stubs

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

from repro_torch.core import (AZURE_REDIS, BatchConfig, Cluster, Decision,
                              ProtocolConfig, Sim, SimStorage, TxnSpec, Vote)

HORIZON = 100_000.0


def run_cluster(n, votes_yes, seed, window_ms, fails=None, protocol="cornus"):
    sim = Sim()
    batch = BatchConfig(window_ms=window_ms, serial=window_ms > 0)
    storage = SimStorage(sim, AZURE_REDIS, seed=seed, batch=batch)
    nodes = [f"n{i}" for i in range(n)]
    cluster = Cluster(sim, storage, nodes, ProtocolConfig(protocol=protocol))
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes,
                   votes={nd: v for nd, v in zip(nodes, votes_yes)})
    for nd, ft in zip(nodes, fails or [None] * n):
        if ft is not None:
            cluster.fail(nd, ft)
    cluster.run_txn(spec)
    sim.run(until=HORIZON)
    decisions = {node: s["decision"] for (node, t), s in cluster.local.items()
                 if t == "t" and s["decision"] is not None}
    slots = {k: (v, storage.store.writer_of(*k))
             for k, v in storage.store.snapshot().items()}
    return decisions, slots


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 6).flatmap(lambda n: st.tuples(
    st.just(n),
    st.lists(st.booleans(), min_size=n, max_size=n),
    st.integers(0, 10_000),
    st.floats(0.1, 5.0),
)))
def test_batched_equals_unbatched_without_failures(params):
    """No failures + generous timeouts: window=0 and window=w runs reach
    identical per-node decisions AND identical final log state — same
    value and same ``writer_of`` winner in every (partition, txn) slot."""
    n, votes, seed, window = params
    d0, s0 = run_cluster(n, votes, seed, 0.0)
    d1, s1 = run_cluster(n, votes, seed, window)
    assert d0 == d1
    assert s0 == s1


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 6).flatmap(lambda n: st.tuples(
    st.just(n),
    st.lists(st.booleans(), min_size=n, max_size=n),
    st.lists(st.one_of(st.none(), st.floats(0.0, 40.0)),
             min_size=n, max_size=n),
    st.integers(0, 10_000),
    st.floats(0.1, 5.0),
)))
def test_batched_cornus_agreement_under_failures(params):
    """AC1–AC3 survive batching under arbitrary failure schedules: no split
    brain, and never COMMIT without unanimous YES votes."""
    n, votes, fails, seed, window = params
    decisions, _ = run_cluster(n, votes, seed, window, fails=fails)
    assert len(set(decisions.values())) <= 1, f"split brain: {decisions}"
    if not all(votes):
        assert Decision.COMMIT not in decisions.values()


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 4),            # partitions
       st.integers(2, 12),           # racing writers
       st.integers(0, 10_000),
       st.floats(0.0, 5.0))
def test_concurrent_log_once_single_winner_any_window(n_parts, n_writers,
                                                      seed, window):
    """Random interleavings of racing LogOnce calls: for every slot, all
    callers observe ONE value, and it is exactly what the store holds."""
    import random as _random
    rng = _random.Random(seed)
    sim = Sim()
    batch = BatchConfig(window_ms=window, serial=True)
    storage = SimStorage(sim, AZURE_REDIS, seed=seed, batch=batch)
    calls = []   # (key, event, proposed)

    def caller(delay, part, txn, value, writer):
        def gen():
            yield sim.timeout(delay)
            got = yield storage.log_once(part, txn, value, writer=writer)
            return got
        calls.append(((part, txn), sim.process(gen()), value))

    for w in range(n_writers):
        part = f"p{rng.randrange(n_parts)}"
        txn = f"t{rng.randrange(3)}"
        value = Vote.VOTE_YES if rng.random() < 0.5 else Vote.ABORT
        caller(rng.random() * 10.0, part, txn, value, f"w{w}")
    sim.run()

    by_slot = {}
    for key, ev, _ in calls:
        by_slot.setdefault(key, []).append(ev.value)
    for key, observed in by_slot.items():
        assert len(set(observed)) == 1, f"slot {key} split: {observed}"
        assert storage.store.read_state(*key) == observed[0]
    # Accounting: round trips never exceed logical requests.
    assert storage.round_trips <= storage.requests


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
def test_hypothesis_is_exercising_windows():
    """Meta-check: the strategies above include genuinely batched windows
    (guards against the suite silently degenerating to passthrough)."""
    d, s = run_cluster(3, [True, True, True], 0, 2.5)
    assert set(d.values()) == {Decision.COMMIT}
