"""The port's transactional serving (``repro_torch.serve``: sessions, SLO
reports, publisher, engine) against the JAX package's, on the CPU.

Cross-package parity: one seeded, single-threaded session script (open,
three steps, a step parked before its last vote and terminated, one more
step, close) under every registered protocol on the ``memory`` and
``replicated`` (R = 3) stores must leave equal store contents and equal
``SessionManager`` counters; ``LatencyRecorder.report`` on one fixed list
of samples must give equal ``SloReport`` fields, exactly.  Then the torch
twins of the session, admission and engine tests of tests/test_serve.py
(the stub decode), and one engine run on ``decode="kernel"`` with CPU
tensors, which goes through the plain ``flash_decode``.  ``Vote`` is a
distinct enum in each package, so votes are compared by ``.name``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import pytest

pytest.importorskip("torch")

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.core import MemoryStore, ReplicatedStore, Vote  # noqa: E402
from repro_torch.core.state import Decision  # noqa: E402
from repro_torch.serve import (AdmissionConfig,  # noqa: E402
                               CheckpointPublisher, ContinuousBatcher,
                               EngineConfig, ServeEngine, SessionConfig,
                               SessionManager, StepRequest, StubDecode,
                               build_session_store, run_serve)

PROTOCOLS = ["cornus", "2pc", "cl", "cornus-opt1", "paxos-commit"]


# ---------------------------------------------------------------------------
# Cross-package parity
# ---------------------------------------------------------------------------
def _replica_logs(store):
    return [(r.index, r.epoch_promised,
             {k: (s.promised, s.acc_ballot,
                  None if s.acc_value is None else s.acc_value.name,
                  s.decided, None if s.value is None else s.value.name,
                  s.gen, s.writer)
              for k, s in sorted(r._slots.items())})
            for r in store.replicas]


def _session_script(serve, protocol, backend):
    cfg = serve.SessionConfig(protocol=protocol, backend=backend,
                              replication=3, participants_per_txn=3,
                              kv_partitions=4, seed=5)
    store = serve.build_session_store(cfg)
    mgr = serve.SessionManager(store, cfg)
    s = mgr.open_session("client")
    outs = [mgr.step(s).committed for _ in range(3)]
    txn, parts = s.step_txn(s.steps), list(s.partitions)
    terminated = []

    def park(i, _p):
        if i == len(parts) - 1:          # stall before the LAST vote
            terminated.append(mgr.terminate_step(s.sid, txn, parts))

    outs.append(mgr.step(s, before_vote=park).committed)
    outs.append(mgr.step(s).committed)
    closed = mgr.close_session(s)
    out = {
        "outs": outs, "terminated": terminated, "closed": closed,
        "session": (s.sid, s.partitions, s.kv_len, s.steps, s.open,
                    s.closed),
        "counters": (mgr.opens, mgr.closes, mgr.steps_committed,
                     mgr.steps_aborted, mgr.terminations),
        "snapshot": {k: v.name for k, v in store.snapshot().items()},
        "keeper": None if mgr.keeper is None else (
            mgr.keeper.acquisitions, mgr.keeper.renewals,
            mgr.keeper.failures, mgr.keeper.degradations),
    }
    if backend == "replicated":
        out["logs"] = _replica_logs(store)
        out["store"] = (store.cas_attempts, store.cas_losses,
                        store.fast_path_ops, store.fallback_ops,
                        store.lease_acquisitions)
    else:
        out["writers"] = {k: store.writer_of(*k) for k in store.snapshot()}
    return out


@pytest.mark.parametrize("backend", ["memory", "replicated"])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_session_script_matches(protocol, backend):
    t = _session_script(tserve, protocol, backend)
    j = _session_script(jserve, protocol, backend)
    assert t == j
    assert t["counters"][0] == 1 and t["closed"]
    if protocol != "cl":                 # cl's participants never vote
        assert t["terminated"] and t["outs"] == [True, True, True, False,
                                                  True]
        assert t["counters"][3] == 1 and t["counters"][4] == 1
    if backend == "replicated" and protocol != "2pc":
        assert t["store"][2] > 0         # LogOnce rode the lease fast path


def _recorder_samples(serve):
    rec = serve.LatencyRecorder()
    base = 1000.0
    for i in range(57):
        lat = 2.0 + (i * 37 % 19) * 0.61 + (40.0 if i % 23 == 0 else 0.0)
        rec.record_step(lat, committed=(i % 11 != 5),
                        within_deadline=(i % 7 != 3), t_done=base + 0.01 * i,
                        first=(i % 8 == 0))
    for _ in range(3):
        rec.record_drop()
    rec.record_reject()
    rec.mark_window(base + 0.12, base + 0.31)
    rec.mark_window(base + 0.5, base + 9.0)     # clipped at the run's end
    return rec.report(0.6, base, protocol="cornus", arrival="closed",
                      batch_mode="batched", mean_batch=5.25)


def test_slo_report_matches_exactly():
    t = dataclasses.asdict(_recorder_samples(tserve))
    j = dataclasses.asdict(_recorder_samples(jserve))
    assert t == j
    assert t["publish_disruption"] is not None and t["p99_ms"] > t["p50_ms"]
    assert t["completed"] == 57 and t["dropped"] == 3 and t["rejected"] == 1


@pytest.mark.parametrize("xs,q", [([], 0.5), ([3.0], 0.99),
                                  ([5.0, 1.0, 4.0, 2.0, 3.0], 0.5),
                                  (list(range(100)), 0.99)])
def test_percentile_is_the_nearest_rank_rule(xs, q):
    from repro.txn.executor import percentile as jpercentile
    from repro_torch.serve.slo import percentile
    assert percentile(xs, q) == jpercentile(xs, q)


def test_configs_match_the_reference():
    for cls in ("SessionConfig", "AdmissionConfig"):
        assert (dataclasses.asdict(getattr(tserve, cls)())
                == dataclasses.asdict(getattr(jserve, cls)()))
    t, j = EngineConfig(), jserve.EngineConfig()
    for f in dataclasses.fields(t):
        if f.name not in ("session", "admission"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert ([f.name for f in dataclasses.fields(tserve.SloReport)]
            == [f.name for f in dataclasses.fields(jserve.SloReport)])


def _stall_engine(serve):
    cfg = serve.EngineConfig(
        session=serve.SessionConfig(protocol="cornus", backend="memory",
                                    participants_per_txn=3,
                                    service_delay_ms=0.2),
        admission=serve.AdmissionConfig(max_batch=8, window_ms=0.5),
        clients=4, steps_per_session=6, stall_at=0.5)
    r = serve.run_serve(cfg)
    rep = r.report
    return ((rep.completed, rep.committed, rep.aborted, rep.dropped,
             rep.rejected),
            {k: r.counters[k] for k in ("submitted", "opens", "closes",
                                        "steps_committed", "steps_aborted",
                                        "terminations")},
            sorted(r.counters))


def test_engine_counts_match_the_reference():
    assert _stall_engine(tserve) == _stall_engine(jserve)


# ---------------------------------------------------------------------------
# Twins of tests/test_serve.py: sessions as transactions
# ---------------------------------------------------------------------------
def _manager(protocol: str, **kw) -> SessionManager:
    cfg = SessionConfig(protocol=protocol, backend="memory",
                        participants_per_txn=3, kv_partitions=4, **kw)
    return SessionManager(build_session_store(cfg), cfg)


@pytest.mark.parametrize("protocol", ["cornus", "2pc", "cl"])
def test_session_lifecycle_commits(protocol):
    mgr = _manager(protocol)
    s = mgr.open_session("client")
    assert s.open
    for _ in range(3):
        out = mgr.step(s)
        assert out.committed
    assert mgr.close_session(s)
    assert s.kv_len == 3
    assert (mgr.opens, mgr.steps_committed, mgr.closes) == (1, 3, 1)


def test_cornus_step_leaves_only_votes():
    mgr = _manager("cornus")
    s = mgr.open_session("c")
    mgr.step(s)
    txn = s.step_txn(0)
    for p in s.partitions:
        assert mgr.store.read_state(p, txn) == Vote.VOTE_YES


def test_2pc_step_forces_decision_record():
    mgr = _manager("2pc")
    s = mgr.open_session("c")
    mgr.step(s)
    txn = s.step_txn(0)
    assert mgr.store.read_state(s.coordinator, txn) == Vote.COMMIT
    for p in s.partitions[1:]:
        assert mgr.store.read_state(p, txn) == Vote.VOTE_YES


def test_cl_step_logs_only_coordinator():
    mgr = _manager("cl")
    s = mgr.open_session("c")
    mgr.step(s)
    txn = s.step_txn(0)
    assert mgr.store.read_state(s.coordinator, txn) == Vote.COMMIT
    for p in s.partitions[1:]:
        assert mgr.store.read_state(p, txn) is None


def test_terminate_step_aborts_parked_step():
    mgr = _manager("cornus")
    s = mgr.open_session("c")
    txn = s.step_txn(s.steps)
    parts = list(s.partitions)

    def park(i: int, _p: str) -> None:
        if i == len(parts) - 1:
            t = threading.Thread(target=mgr.terminate_step,
                                 args=(s.sid, txn, parts), daemon=True)
            t.start()
            t.join(timeout=10.0)
            assert not t.is_alive()

    out = mgr.step(s, before_vote=park)
    assert not out.committed
    assert mgr.store.read_state(parts[-1], txn) == Vote.ABORT
    assert mgr.terminations == 1
    assert mgr.steps_aborted == 1
    assert s.kv_len == 0
    assert mgr.step(s).committed


def test_terminate_step_after_full_commit_is_noop():
    mgr = _manager("cornus")
    s = mgr.open_session("c")
    out = mgr.step(s)
    assert out.committed
    landed = mgr.terminate_step(s.sid, s.step_txn(0), s.partitions)
    assert not landed


def test_build_session_store_rejects_sim_backends():
    with pytest.raises(ValueError, match="simulated"):
        build_session_store(SessionConfig(backend="sim"))


def test_session_store_backends():
    assert isinstance(build_session_store(SessionConfig()), MemoryStore)
    store = build_session_store(SessionConfig(backend="replicated",
                                              replication=5))
    assert isinstance(store, ReplicatedStore) and store.n == 5


# ---------------------------------------------------------------------------
# Twins of tests/test_serve.py: admission control
# ---------------------------------------------------------------------------
class _GatedDecode:
    def __init__(self) -> None:
        self.started = threading.Event()
        self.gate = threading.Event()
        self.calls = 0

    def __call__(self, reqs):
        self.calls += 1
        self.started.set()
        assert self.gate.wait(timeout=10.0)
        return [0] * len(reqs)


def test_deadline_expired_request_is_dropped_before_decode():
    b = ContinuousBatcher(StubDecode(base_ms=0.1),
                          AdmissionConfig(max_batch=4, window_ms=0.0)).start()
    try:
        req = StepRequest("s", 0, deadline_at=time.monotonic() - 1.0)
        assert b.submit(req)
        assert req.done.wait(timeout=5.0)
        assert req.dropped and req.result is None
        assert b.dropped == 1 and b.decoded == 0 and b.batches == 0
    finally:
        b.stop()


def test_backpressure_reject_sheds_when_queue_full():
    decode = _GatedDecode()
    b = ContinuousBatcher(decode, AdmissionConfig(
        max_batch=1, window_ms=0.0, queue_depth=1,
        backpressure="reject")).start()
    try:
        r1 = StepRequest("s", 0)
        assert b.submit(r1)
        assert decode.started.wait(timeout=5.0)
        r2 = StepRequest("s", 1)
        assert b.submit(r2)
        r3 = StepRequest("s", 2)
        assert not b.submit(r3)
        assert b.rejected == 1
        decode.gate.set()
        assert r1.done.wait(timeout=5.0)
        assert r2.done.wait(timeout=5.0)
        assert not r1.dropped and not r2.dropped
    finally:
        decode.gate.set()
        b.stop()


def test_backpressure_block_waits_for_capacity():
    decode = _GatedDecode()
    b = ContinuousBatcher(decode, AdmissionConfig(
        max_batch=1, window_ms=0.0, queue_depth=1,
        backpressure="block")).start()
    try:
        assert b.submit(StepRequest("s", 0))
        assert decode.started.wait(timeout=5.0)
        assert b.submit(StepRequest("s", 1))
        r3 = StepRequest("s", 2)
        got = []
        t = threading.Thread(target=lambda: got.append(b.submit(r3)),
                             daemon=True)
        t.start()
        t.join(timeout=0.15)
        assert t.is_alive()
        decode.gate.set()
        t.join(timeout=5.0)
        assert not t.is_alive() and got == [True]
        assert r3.done.wait(timeout=5.0)
        assert b.rejected == 0
    finally:
        decode.gate.set()
        b.stop()


def test_stop_fails_queued_requests_instead_of_hanging():
    decode = _GatedDecode()
    b = ContinuousBatcher(decode, AdmissionConfig(
        max_batch=1, window_ms=0.0, queue_depth=8)).start()
    assert b.submit(StepRequest("s", 0))
    assert decode.started.wait(timeout=5.0)
    queued = StepRequest("s", 1)
    assert b.submit(queued)
    decode.gate.set()
    b.stop()
    assert queued.done.wait(timeout=5.0)


def _decode_all(reqs_spec, max_batch: int, window_ms: float):
    b = ContinuousBatcher(StubDecode(base_ms=0.05, per_item_ms=0.01),
                          AdmissionConfig(max_batch=max_batch,
                                          window_ms=window_ms,
                                          queue_depth=10_000)).start()
    try:
        reqs = [StepRequest(sid, tok) for sid, tok in reqs_spec]
        for r in reqs:
            assert b.submit(r)
        for r in reqs:
            assert r.done.wait(timeout=30.0)
        assert b.dropped == 0 and b.rejected == 0
        return {(r.session, r.token): r.result for r in reqs}
    finally:
        b.stop()


def test_batched_equals_unbatched_results_deterministic():
    spec = [(f"s{i % 5}", i) for i in range(40)]
    batched = _decode_all(spec, max_batch=8, window_ms=2.0)
    unbatched = _decode_all(spec, max_batch=1, window_ms=0.0)
    assert batched == unbatched
    assert all(v is not None for v in batched.values())


# ---------------------------------------------------------------------------
# Twins of tests/test_serve.py: the engine
# ---------------------------------------------------------------------------
def test_engine_closed_loop_serves_through_publish_and_stall():
    cfg = EngineConfig(
        session=SessionConfig(protocol="cornus", backend="memory",
                              participants_per_txn=3,
                              service_delay_ms=0.5),
        admission=AdmissionConfig(max_batch=8, window_ms=0.5),
        clients=4, steps_per_session=10,
        publish_at=0.3, publish_until=0.7, stall_at=0.5)
    r = run_serve(cfg)
    rep = r.report
    total = 4 * 10
    assert rep.completed == total
    assert rep.aborted == 1
    assert rep.committed == total - 1
    assert r.counters["terminations"] == 1
    assert len(r.publishes) >= 1
    assert rep.publish_disruption is not None
    assert rep.p99_ms >= rep.p50_ms > 0
    assert r.counters["closes"] == 4


def test_engine_replicated_survives_replica_kill():
    cfg = EngineConfig(
        session=SessionConfig(protocol="cornus", backend="replicated",
                              replication=3, participants_per_txn=2,
                              service_delay_ms=0.5),
        admission=AdmissionConfig(max_batch=8, window_ms=0.5),
        clients=4, steps_per_session=8,
        publish_at=0.3, publish_until=0.8, kill_replica_at=0.3)
    r = run_serve(cfg)
    rep = r.report
    assert r.counters["replica_killed"] >= 0
    assert rep.committed == 4 * 8
    assert r.counters["fast_path_ops"] > 0
    assert len(r.publishes) >= 1


def test_engine_unbatched_mode_batches_of_one():
    cfg = EngineConfig(
        session=SessionConfig(protocol="cornus", backend="memory",
                              service_delay_ms=0.2),
        clients=3, steps_per_session=4, batch_mode="unbatched")
    r = run_serve(cfg)
    assert r.report.committed == 3 * 4
    assert r.counters["max_batch_seen"] == 1


def test_engine_deadline_drops_count_against_goodput():
    cfg = EngineConfig(
        session=SessionConfig(protocol="cornus", backend="memory",
                              service_delay_ms=0.2),
        admission=AdmissionConfig(max_batch=4, window_ms=5.0,
                                  deadline_ms=1e-4),
        clients=3, steps_per_session=4)
    r = run_serve(cfg)
    rep = r.report
    assert rep.dropped == 3 * 4
    assert rep.committed == 0 and rep.goodput_tps == 0.0


def test_engine_open_loop_sheds_instead_of_stalling():
    cfg = EngineConfig(
        session=SessionConfig(protocol="cornus", backend="memory",
                              service_delay_ms=0.5),
        admission=AdmissionConfig(max_batch=4, window_ms=0.5,
                                  backpressure="reject", queue_depth=8),
        clients=4, arrival="open", rate_rps=300.0, duration_s=0.5,
        max_inflight=16)
    r = run_serve(cfg)
    rep = r.report
    assert rep.committed > 0
    assert rep.committed == r.counters["steps_committed"]
    assert rep.completed + rep.dropped <= r.counters["submitted"]


def test_engine_rejects_unknown_modes():
    with pytest.raises(ValueError, match="batch_mode"):
        ServeEngine(EngineConfig(batch_mode="bursty"))
    with pytest.raises(ValueError, match="unknown decode backend"):
        ServeEngine(EngineConfig(decode="auto"))


# ---------------------------------------------------------------------------
# The publisher and the kernel decode
# ---------------------------------------------------------------------------
def test_publisher_commits_epochs_with_the_default_payload():
    store = ReplicatedStore(n_replicas=3, seed=4)
    pub = CheckpointPublisher(store, ("pub0", "pub1", "pub2"),
                              payload_bytes=256)
    recs = [pub.publish_once() for _ in range(3)]
    assert [r.decision for r in recs] == [Decision.COMMIT] * 3
    assert pub.committed_epochs == [0, 1, 2]
    # Each host's shard of each epoch is readable: the payload the seeded
    # default drew for it.
    first = store.get_data("pub1", f"e{1:012d}")
    assert len(first) == 256 and first == pub.payload_of(1, "pub1")
    assert first != pub.payload_of(1, "pub0")


def _publish_script(pkg, backend):
    """Three epochs from three hosts with an explicit payload (the default
    payload's seed is the one documented difference), on the replicated
    store a fourth with replica 0 down; returns the records, the committed
    epochs, the store's votes by name and every uploaded shard."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    serve = importlib.import_module(f"{pkg}.serve")
    store = (core.MemoryStore() if backend == "memory"
             else core.ReplicatedStore(n_replicas=3, seed=4))
    hosts = ("pub0", "pub1", "pub2")
    pub = serve.CheckpointPublisher(
        store, hosts, payload_of=lambda e, h: f"{e}/{h};".encode() * 40,
        epoch0=2)
    recs = [pub.publish_once() for _ in range(3)]
    if backend == "replicated":
        store.fail_replica(0)
        recs.append(pub.publish_once())
    return {"records": [(r.epoch, r.decision.name, r.forced_aborts)
                        for r in recs],
            "committed": pub.committed_epochs,
            "votes": {k: v.name for k, v in sorted(store.snapshot().items())},
            "shards": {(h, r.epoch): store.get_data(h, f"e{r.epoch:012d}")
                       for h in hosts for r in recs}}


@pytest.mark.parametrize("backend", ["memory", "replicated"])
def test_publisher_matches_the_reference(backend):
    t = _publish_script("repro_torch", backend)
    j = _publish_script("repro", backend)
    assert t == j
    n = 4 if backend == "replicated" else 3
    assert t["committed"] == list(range(2, 2 + n))
    assert len(t["votes"]) == 3 * n


def test_engine_on_the_kernel_decode_with_cpu_tensors(monkeypatch):
    """Every engine batch is one (plain, on the CPU) flash_decode call over
    the sessions' gathered rows, with kv_len the batch's longest cache."""
    from repro_torch.serve import admission
    calls = []
    real = admission.ops.flash_decode

    def spy(q, k, v, kv_len, **kw):
        calls.append((q.shape, k.shape, kv_len))
        return real(q, k, v, kv_len, **kw)

    monkeypatch.setattr(admission.ops, "flash_decode", spy)
    steps = 6
    engine = ServeEngine(EngineConfig(
        session=SessionConfig(protocol="cornus", backend="memory",
                              participants_per_txn=3, service_delay_ms=0.2),
        admission=AdmissionConfig(max_batch=4, window_ms=1.0),
        decode="kernel",
        decode_kwargs=dict(slots=8, q_heads=4, kv_heads=2, head_dim=16,
                           max_len=64, device="cpu"),
        clients=6, steps_per_session=steps, stall_at=0.5))
    r = engine.run()
    assert engine.batcher.last_error is None
    assert r.report.completed == 6 * steps and r.report.dropped == 0
    assert r.report.committed == 6 * steps - 1 and r.report.aborted == 1
    assert len(calls) == engine.batcher.batches == r.counters["batches"]
    assert r.counters["max_batch_seen"] > 1
    for qs, ks, kv_len in calls:
        assert qs[1:] == (4, 1, 16) and ks[1:] == (2, 64, 16)
        assert qs[0] == ks[0] <= 4 and 1 <= kv_len <= steps
