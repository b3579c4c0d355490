"""Twin of ``tests/test_protocol_properties.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Property-based tests of the paper's correctness claims (§3.5, AC1–AC5).

Hypothesis drives randomized failure schedules, vote assignments, latency
seeds and cluster sizes through the deterministic discrete-event sim, and we
assert the five atomic-commit properties plus Lemma 1 (irreversible global
decision) and the paper's Theorem-4 strengthening of AC5 (bounded-time,
recovery-free termination) for Cornus.
"""
from __future__ import annotations

import pytest

# Without hypothesis (dev-only dependency) the @given tests are skipped but
# the module still collects, so the plain example-based tests keep running.
from conftest import hypothesis_or_stubs

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()

from repro_torch.core import (AZURE_REDIS, Cluster, Decision, ProtocolConfig,
                              Sim, SimStorage, TxnSpec, Vote, global_decision)

HORIZON = 100_000.0


def build(protocol: str, n: int, seed: int, rtt: float = 0.5):
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=seed)
    nodes = [f"n{i}" for i in range(n)]
    cfg = ProtocolConfig(protocol=protocol, rtt_ms=rtt)
    return sim, storage, Cluster(sim, storage, nodes, cfg), nodes


def run_schedule(protocol, n, votes_yes, fail_times, seed,
                 recover_after=2_000.0):
    """Run one txn under a failure schedule; recovered nodes re-resolve."""
    sim, storage, cluster, nodes = build(protocol, n, seed)
    spec = TxnSpec(
        txn_id="t", coordinator=nodes[0], participants=nodes,
        votes={nd: v for nd, v in zip(nodes, votes_yes)})
    for nd, ft in zip(nodes, fail_times):
        if ft is not None:
            cluster.fail(nd, ft, recover_at=recover_after)
    cluster.run_txn(spec)
    sim.run(until=recover_after)
    # Recovery pass (Table 1/2 "During Recovery"): every failed node that
    # recovers resolves the txn from its log / termination protocol.
    for nd, ft in zip(nodes, fail_times):
        if ft is not None:
            cluster.recover_txn(spec, nd)
    sim.run(until=HORIZON)
    return sim, storage, cluster, spec


def decided(cluster, txn="t"):
    out = {}
    for (node, t), st_ in cluster.local.items():
        if t == txn and st_["decision"] is not None:
            out[node] = st_["decision"]
    return out


schedule = st.integers(2, 6).flatmap(lambda n: st.tuples(
    st.just(n),
    st.lists(st.booleans(), min_size=n, max_size=n),
    st.lists(st.one_of(st.none(), st.floats(0.0, 40.0)),
             min_size=n, max_size=n),
    st.integers(0, 10_000),
))


@settings(max_examples=120, deadline=None)
@given(schedule)
def test_cornus_ac1_ac2_agreement(params):
    """AC1: every reached decision equals the global decision; AC2/Lemma 1:
    the storage-level global decision is never contradicted."""
    n, votes, fails, seed = params
    sim, storage, cluster, spec = run_schedule("cornus", n, votes, fails, seed)
    decisions = decided(cluster)
    gd = global_decision(
        {p: storage.store.read_state(p, "t") for p in spec.participants},
        spec.participants)
    assert len(set(decisions.values())) <= 1, f"split brain: {decisions}"
    if decisions:
        d = next(iter(decisions.values()))
        assert gd != Decision.UNDETERMINED
        assert d == gd, f"local {d} != global {gd}"


@settings(max_examples=120, deadline=None)
@given(schedule)
def test_cornus_ac3_no_commit_without_unanimous_yes(params):
    n, votes, fails, seed = params
    _, _, cluster, _ = run_schedule("cornus", n, votes, fails, seed)
    if not all(votes):
        assert Decision.COMMIT not in decided(cluster).values()


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 8), st.integers(0, 10_000))
def test_cornus_ac4_commit_when_no_failures(n, seed):
    """All yes + no failures ⇒ COMMIT at every node."""
    sim, storage, cluster, spec = run_schedule(
        "cornus", n, [True] * n, [None] * n, seed)
    decisions = decided(cluster)
    assert len(decisions) == n
    assert set(decisions.values()) == {Decision.COMMIT}


@settings(max_examples=80, deadline=None)
@given(schedule)
def test_cornus_ac5_bounded_termination_of_survivors(params):
    """Theorem 4: any compute-layer failures — surviving nodes decide without
    waiting for failed nodes to recover (recovery disabled here)."""
    n, votes, fails, seed = params
    sim, storage, cluster, nodes = build("cornus", n, seed)
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes,
                   votes={nd: v for nd, v in zip(nodes, votes)})
    for nd, ft in zip(nodes, fails):
        if ft is not None:
            cluster.fail(nd, ft)  # never recovers
    cluster.run_txn(spec)
    sim.run(until=HORIZON)
    survivors = [nd for nd, ft in zip(nodes, fails) if ft is None]
    decisions = decided(cluster)
    for s in survivors:
        assert s in decisions, f"survivor {s} undecided (blocked!)"
    assert len({decisions[s] for s in survivors}) <= 1


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 6),
       st.lists(st.booleans(), min_size=2, max_size=6),
       st.integers(0, 10_000))
def test_2pc_agreement_no_failures(n, votes, seed):
    """The 2PC baseline is also a correct AC protocol absent failures."""
    votes = (votes + [True] * n)[:n]
    sim, storage, cluster, spec = run_schedule(
        "2pc", n, votes, [None] * n, seed)
    decisions = decided(cluster)
    assert len(decisions) == n
    expect = Decision.COMMIT if all(votes) else Decision.ABORT
    assert set(decisions.values()) == {expect}


def test_2pc_blocks_on_coordinator_failure_cornus_does_not():
    """The paper's headline fault case (Fig 2b vs Fig 4a)."""
    for proto, should_block in (("2pc", True), ("cornus", False)):
        sim, storage, cluster, nodes = build(proto, 4, seed=7)
        spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes)
        # Coordinator dies after collecting votes, before any decision msg.
        cluster.fail(nodes[0], 3.0)
        cluster.run_txn(spec)
        sim.run(until=50_000.0)
        survivors = nodes[1:]
        got = decided(cluster)
        if should_block:
            assert all(s not in got for s in survivors)
            assert any(cluster.blocked.get(("t", s)) for s in survivors)
        else:
            assert all(got.get(s) == Decision.COMMIT for s in survivors)


def test_termination_writes_abort_on_behalf_of_silent_participant():
    """Fig 4b: participant dies before logging its vote → coordinator's
    termination protocol CAS-forces ABORT into its log slot."""
    sim, storage, cluster, nodes = build("cornus", 3, seed=3)
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes)
    cluster.fail("n2", 0.05)  # dies before logging anything
    done = cluster.run_txn(spec)
    sim.run(until=50_000.0)
    assert done.value.decision == Decision.ABORT
    assert storage.store.read_state("n2", "t") == Vote.ABORT
    assert storage.store.writer_of("n2", "t") in ("n0", "n1")


def test_log_once_first_writer_wins():
    from repro_torch.core import MemoryStore
    s = MemoryStore()
    assert s.log_once("p", "t", Vote.VOTE_YES, "p") == Vote.VOTE_YES
    assert s.log_once("p", "t", Vote.ABORT, "peer") == Vote.VOTE_YES
    assert s.read_state("p", "t") == Vote.VOTE_YES
    assert s.cas_losses == 1


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 5), st.integers(0, 1000), st.floats(0.1, 30.0))
def test_cornus_concurrent_termination_race_is_safe(n, seed, fail_t):
    """Coordinator AND participants all racing the termination protocol
    (everyone times out at once) still yields one consistent decision."""
    sim, storage, cluster, nodes = build("cornus", n, seed)
    # Tiny decision timeout forces every participant into termination even
    # though the coordinator is alive — maximal CAS contention.
    cluster.cfg.decision_timeout_ms = 0.5
    cluster.cfg.vote_timeout_ms = 0.5
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes)
    cluster.run_txn(spec)
    sim.run(until=HORIZON)
    decisions = decided(cluster)
    assert len(decisions) == n
    assert len(set(decisions.values())) == 1


def test_readonly_not_known_upfront_subtlety():
    """§3.6 second case: when read-only-ness is discovered only at prepare
    time, a Cornus read-only participant MUST still LogOnce(VOTE-YES) (a
    missing vote reads as abortable by the termination protocol), while 2PC
    may skip its prepare log entirely."""
    for proto, must_log in (("cornus", True), ("2pc", False)):
        sim, storage, cluster, nodes = build(proto, 3, seed=11)
        spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes,
                       read_only=frozenset({"n2"}),
                       read_only_known_upfront=False)
        done = cluster.run_txn(spec)
        sim.run(until=10_000)
        assert done.value.decision == Decision.COMMIT
        logged = storage.store.read_state("n2", "t")
        if must_log:
            assert logged in (Vote.VOTE_YES, Vote.COMMIT), \
                f"cornus read-only participant must log, got {logged}"
        else:
            assert logged is None, \
                f"2pc read-only participant should skip logging, got {logged}"


def test_readonly_unlogged_cornus_participant_is_abortable():
    """The WHY of the rule above: if a Cornus read-only participant crashed
    before logging, peers' termination protocol CAS-forces ABORT into its
    empty slot — absence of VOTE-YES must mean abortable, so live read-only
    participants must write it."""
    sim, storage, cluster, nodes = build("cornus", 3, seed=12)
    spec = TxnSpec(txn_id="t", coordinator=nodes[0], participants=nodes,
                   read_only=frozenset({"n2"}),
                   read_only_known_upfront=False)
    cluster.fail("n2", 0.01)     # dies before its (mandatory) vote log
    done = cluster.run_txn(spec)
    sim.run(until=50_000)
    assert done.value.decision == Decision.ABORT
    assert storage.store.read_state("n2", "t") == Vote.ABORT
