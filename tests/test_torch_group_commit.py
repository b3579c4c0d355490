"""Twin of ``tests/test_group_commit.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions on the
same seeds.

Storage-side group commit: amortization, semantic invisibility, and the
contention win.

The batching layer must be invisible to every registered protocol: with
window=0 (the default) it is an exact passthrough — validated here against
the analytic Table-3 RTT counts for all six rows — and with a window it may
only change *timing*, never outcomes, CAS winners, or liveness.
"""
from __future__ import annotations

import threading

import pytest

from repro_torch.core import (AZURE_REDIS, BatchConfig, BatchingStore, Cluster,
                              Decision, FileStore, LatencyModel, MemoryStore,
                              ProtocolConfig, ReplicatedStore, Sim, SimStorage,
                              SIMULATED_RTT_ROWS, TxnSpec, Vote,
                              measured_caller_latency_ms,
                              predicted_caller_latency_ms)
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench


# ---------------------------------------------------------------------------
# Amortization model (the deduped §5.6 batch-write cost)
# ---------------------------------------------------------------------------
def test_batched_write_ms_shared_amortization():
    m = AZURE_REDIS
    assert m.batched_write_ms(1) == m.plain_write_ms
    assert m.batched_write_ms(4) == pytest.approx(
        m.plain_write_ms * (1.0 + 3 * m.batch_size_factor))
    # Explicit base (a batch led by a conditional write) grows the same way.
    assert m.batched_write_ms(4, m.conditional_write_ms) == pytest.approx(
        m.conditional_write_ms * (1.0 + 3 * m.batch_size_factor))


def test_cl_log_batch_rides_shared_path():
    """The coordinator-log batched record goes through the same flush path
    as ingress group commit: one round trip whatever n_records is."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=0)
    ev = st.log_batch("n0", "t", Vote.COMMIT, n_records=5, writer="n0")
    sim.run()
    assert ev.value == Vote.COMMIT
    assert st.round_trips == 1
    assert st.requests == 1
    assert st.store.read_state("n0", "t") == Vote.COMMIT


# ---------------------------------------------------------------------------
# Window=0 passthrough: all six Table-3 rows stay EXACT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("row", sorted(SIMULATED_RTT_ROWS))
def test_table3_exact_at_window0(row):
    measured = measured_caller_latency_ms(row, 20.0, batch_window_ms=0.0)
    assert measured == predicted_caller_latency_ms(row, 20.0)


@pytest.mark.parametrize("row", sorted(SIMULATED_RTT_ROWS))
def test_table3_rows_commit_when_batched(row):
    """With a window the rows still commit (semantic invisibility under
    replication + vote forwarding); each logged vote waits at most one
    window, so the batched latency is bounded by predicted + 2*window."""
    rtt, window = 20.0, 5.0
    measured = measured_caller_latency_ms(row, rtt, batch_window_ms=window)
    predicted = predicted_caller_latency_ms(row, rtt)
    assert predicted <= measured <= predicted + 2 * window


# ---------------------------------------------------------------------------
# Contention: batching strictly reduces storage round trips
# ---------------------------------------------------------------------------
def _hot_partition_wl(nodes, seed):
    return YCSBWorkload(nodes, accesses_per_txn=4, partition_theta=0.9,
                        keys_per_partition=10_000, seed=seed)


@pytest.mark.parametrize("replication", [1, 3])
def test_batching_reduces_round_trips_hot_partition(replication):
    res = {}
    for mode, kw in (("nobatch", dict(storage_serial=True, batch_max=1)),
                     ("batched", dict(storage_serial=True, batch_max=64))):
        cfg = BenchConfig(protocol="cornus", n_nodes=4, threads_per_node=8,
                          horizon_ms=300.0, replication=replication,
                          seed=3, **kw)
        res[mode] = run_bench(_hot_partition_wl, AZURE_REDIS, cfg)
    # Coalescing pays strictly fewer wire round trips...
    assert (res["batched"].storage_round_trips
            < res["nobatch"].storage_round_trips)
    # ...and converts them into committed-txn throughput (the acceptance
    # bar is 1.5x on the full bench; even this short run clears it).
    assert res["batched"].commits >= 1.5 * max(res["nobatch"].commits, 1)


def test_sim_batched_requests_exceed_round_trips():
    """Direct storage-level check: concurrent same-partition writes
    coalesce, and every caller still gets the true CAS result."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=1,
                    batch=BatchConfig(window_ms=2.0, serial=True))
    evs = [st.log_once("p", f"t{i}", Vote.VOTE_YES, writer=f"w{i}")
           for i in range(10)]
    sim.run()
    assert all(ev.value == Vote.VOTE_YES for ev in evs)
    assert st.requests == 10
    assert st.round_trips == 1          # one flush carried all ten slots
    assert st._ingress.max_batch_seen == 10


def test_sim_batched_cas_race_first_arrival_wins():
    """Two writers racing one slot inside a batch: arrival order decides,
    and BOTH callers observe the winner (log-once semantics)."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=1,
                    batch=BatchConfig(window_ms=2.0, serial=True))
    a = st.log_once("p", "t", Vote.VOTE_YES, writer="participant")
    b = st.log_once("p", "t", Vote.ABORT, writer="terminator")
    sim.run()
    assert a.value == Vote.VOTE_YES and b.value == Vote.VOTE_YES
    assert st.store.writer_of("p", "t") == "participant"


def test_cornus_batched_termination_race_consistent():
    """Everyone racing the termination protocol (tiny timeouts) through a
    batched store still converges on one decision."""
    for window in (0.0, 1.5):
        sim = Sim()
        storage = SimStorage(sim, AZURE_REDIS, seed=9,
                             batch=BatchConfig(window_ms=window,
                                               serial=window > 0))
        nodes = [f"n{i}" for i in range(4)]
        cfg = ProtocolConfig(protocol="cornus", vote_timeout_ms=0.5,
                             decision_timeout_ms=0.5)
        cl = Cluster(sim, storage, nodes, cfg)
        cl.run_txn(TxnSpec(txn_id="t", coordinator="n0", participants=nodes))
        sim.run(until=100_000)
        decisions = {st["decision"] for st in cl.local.values()
                     if st["decision"] is not None}
        assert len(decisions) == 1, f"window={window}: split {decisions}"


def test_batched_silent_participant_still_aborted():
    """Fig 4b through the batching layer: the termination CAS on behalf of
    a dead participant lands exactly as unbatched."""
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=3,
                         batch=BatchConfig(window_ms=2.0, serial=True))
    nodes = ["n0", "n1", "n2"]
    cl = Cluster(sim, storage, nodes, ProtocolConfig(protocol="cornus"))
    cl.fail("n2", 0.05)
    done = cl.run_txn(TxnSpec(txn_id="t", coordinator="n0",
                              participants=nodes))
    sim.run(until=50_000)
    assert done.value.decision == Decision.ABORT
    assert storage.store.read_state("n2", "t") == Vote.ABORT
    assert storage.store.writer_of("n2", "t") in ("n0", "n1")


# ---------------------------------------------------------------------------
# Adaptive ("auto") formation window
# ---------------------------------------------------------------------------
def test_batch_config_auto_validation_and_bounds():
    cfg = BatchConfig(window_ms="auto", serial=True, max_window_ms=3.0)
    assert cfg.auto and cfg.active
    assert cfg.worst_case_window_ms == 3.0
    with pytest.raises(ValueError):
        BatchConfig(window_ms="sometimes")
    fixed = BatchConfig(window_ms=2.0)
    assert not fixed.auto and fixed.worst_case_window_ms == 2.0


def test_auto_window_idle_lane_never_delays():
    """A lone request on an idle lane must flush immediately — the same
    latency as piggyback window=0 (real log daemons only delay under
    concurrency)."""
    lat = {}
    for name, window in (("fixed0", 0.0), ("auto", "auto")):
        sim = Sim()
        st = SimStorage(sim, AZURE_REDIS, seed=2,
                        batch=BatchConfig(window_ms=window, serial=True))
        ev = st.log_once("p", "t", Vote.VOTE_YES, writer="w")
        sim.run()
        assert ev.value == Vote.VOTE_YES
        lat[name] = sim.now
    assert lat["auto"] == lat["fixed0"]


def test_auto_window_straggler_after_burst_not_delayed():
    """A lone request arriving AFTER a burst went idle must not inherit
    the burst's inter-arrival EWMA and wait out a formation window."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=2,
                    batch=BatchConfig(window_ms="auto", serial=True,
                                      max_window_ms=4.0))
    for i in range(20):                      # dense burst, iat ~0.3 ms
        def emit(i=i):
            def gen():
                yield sim.timeout(i * 0.3)
                yield st.log_once("p", f"t{i}", Vote.VOTE_YES,
                                  writer=f"w{i}")
            sim.process(gen())
        emit()
    sim.run()
    t_burst_end = sim.now
    lat = {}

    def straggler():
        yield sim.timeout(50.0)              # long idle gap
        t0 = sim.now
        yield st.log_once("p", "late", Vote.VOTE_YES, writer="w")
        lat["ms"] = sim.now - t0
    sim.process(straggler())
    sim.run()
    assert sim.now > t_burst_end
    # No formation delay: just the single flush's service time (well
    # under the 4 ms clamp + service it would pay with a stale EWMA).
    assert lat["ms"] < 4.0


def test_auto_window_batches_under_load():
    """A busy lane (tight arrivals) coalesces under "auto": strictly fewer
    round trips than requests, and every caller gets the true result."""
    sim = Sim()
    st = SimStorage(sim, AZURE_REDIS, seed=2,
                    batch=BatchConfig(window_ms="auto", serial=True,
                                      max_window_ms=4.0))
    evs = []

    def emit(i):
        def gen():
            yield sim.timeout(i * 0.3)      # inter-arrival << max window
            evs.append((yield st.log_once("p", f"t{i}", Vote.VOTE_YES,
                                          writer=f"w{i}")))
        sim.process(gen())

    for i in range(20):
        emit(i)
    sim.run()
    assert len(evs) == 20 and set(evs) == {Vote.VOTE_YES}
    assert st.round_trips < st.requests
    assert st._ingress.max_batch_seen >= 3


# ---------------------------------------------------------------------------
# Threaded BatchingStore decorator
# ---------------------------------------------------------------------------
def test_batching_store_concurrent_log_once_one_winner():
    inner = MemoryStore()
    st = BatchingStore(inner, window_s=0.01, max_batch=64)
    results = {}
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        results[i] = st.log_once("p", "t", Vote.VOTE_YES if i % 2 == 0
                                 else Vote.ABORT, writer=f"w{i}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # One winner, every caller observed it, and it IS the stored state.
    assert len(set(results.values())) == 1
    winner = results[0]
    assert inner.read_state("p", "t") == winner
    # Coalescing actually happened (8 ops, fewer leader round trips).
    assert st.batched_ops == 8
    assert st.round_trips < 8


def test_batching_store_sequential_matches_inner():
    st = BatchingStore(MemoryStore())
    assert st.log_once("p", "t1", Vote.VOTE_YES, "a") == Vote.VOTE_YES
    assert st.log_once("p", "t1", Vote.ABORT, "b") == Vote.VOTE_YES
    assert st.log("p", "t1", Vote.COMMIT, "a") == Vote.COMMIT
    assert st.log("p", "t1", Vote.VOTE_YES, "a") == Vote.COMMIT  # sticky
    assert st.read_state("p", "t1") == Vote.COMMIT               # delegated
    assert st.writer_of("p", "t1") == "a"


def test_batching_store_wraps_filestore(tmp_path):
    st = BatchingStore(FileStore(str(tmp_path)), window_s=0.005)
    assert st.log_once("p", "t", Vote.VOTE_YES, "w") == Vote.VOTE_YES
    assert st.log_once("p", "t", Vote.ABORT, "x") == Vote.VOTE_YES
    assert st.read_state("p", "t") == Vote.VOTE_YES


def test_batching_store_wraps_replicated_store_and_raises():
    from repro_torch.core import QuorumUnavailable
    inner = ReplicatedStore(n_replicas=3)
    st = BatchingStore(inner, window_s=0.0)
    assert st.log_once("p", "t", Vote.VOTE_YES, "p") == Vote.VOTE_YES
    inner.fail_replica(0)
    inner.fail_replica(1)
    with pytest.raises(QuorumUnavailable):
        st.log_once("p", "t2", Vote.VOTE_YES, "p")  # error surfaces


def test_batching_store_leader_hands_off_under_sustained_load():
    """A batch leader serves ONE round then promotes a follower: no caller
    is trapped draining other threads' ops while arrivals keep pace."""
    inner = MemoryStore()
    st = BatchingStore(inner, window_s=0.002, max_batch=4)
    stop = threading.Event()
    n_done = [0]

    def producer(i):
        k = 0
        while not stop.is_set():
            st.log_once("p", f"t{i}.{k}", Vote.VOTE_YES, writer=f"w{i}")
            n_done[0] += 1
            k += 1

    threads = [threading.Thread(target=producer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    import time as _time
    _time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads), \
        "a caller was captured as perpetual batch leader"
    assert n_done[0] > 6                # everyone made progress
    assert st.round_trips < st.batched_ops or st.batched_ops <= 6


# ---------------------------------------------------------------------------
# Forwarding rows through the replicated batched fast path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", ["cornus-opt1", "paxos-commit"])
def test_forwarding_protocols_commit_under_batched_contention(proto):
    cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=8,
                      horizon_ms=300.0, replication=3, seed=5,
                      storage_serial=True, batch_max=64)
    r = run_bench(_hot_partition_wl, AZURE_REDIS, cfg)
    assert r.commits > 100
    assert r.storage_round_trips < r.storage_requests


def test_batched_leader_forwards_coalesce_into_one_delivery():
    """cornus-opt1 under a batched leader: several concurrent txns' votes
    for ONE partition flush together, and their forwards — all bound for
    the same coordinator — leave as ONE deliver_many message
    (delivery_batches < deliveries)."""
    from repro_torch.core import ReplicatedSimStorage

    sim = Sim()
    storage = ReplicatedSimStorage(
        sim, LatencyModel("null", conditional_write_ms=0.0,
                          plain_write_ms=0.0, read_ms=0.0, jitter=0.0),
        n_replicas=3, batch=BatchConfig(window_ms=5.0, serial=True))
    nodes = ["c", "p0", "p1"]
    cl = Cluster(sim, storage, nodes,
                 ProtocolConfig(protocol="cornus-opt1"))
    n_txns = 5
    dones = [cl.run_txn(TxnSpec(txn_id=f"t{i}", coordinator="c",
                                participants=["p0", "p1"]))
             for i in range(n_txns)]
    sim.run(until=10_000)
    assert all(d.value.decision == Decision.COMMIT for d in dones)
    tr = cl.transport
    assert tr.deliveries == 2 * n_txns  # one forwarded vote per participant
    assert tr.delivery_batches < tr.deliveries, \
        "forwards for one coordinator should coalesce via deliver_many"
    assert storage.forward_batches >= 1
    assert storage._ingress.max_batch_seen >= 2
