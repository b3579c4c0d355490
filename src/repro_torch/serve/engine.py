"""The serving engine: sessions × admission × commit × publish, one loop.

The port's copy of ``repro/serve/engine.py`` (the standard library only; the
port imports nothing of the JAX package).

``ServeEngine.run()`` drives a full serving experiment:

  clients    – closed-loop (each client streams its session's steps
               back-to-back) or open-loop (Poisson arrivals at ``rate_rps``
               with load shedding) arrival processes.
  admission  – every step goes through the ``ContinuousBatcher``; the
               decode result is only acknowledged after the step's KV-cache
               update COMMITS through the session's protocol.  End-to-end
               step latency = queue + decode + commit.
  publish    – between the ``publish_at`` and ``publish_until`` fractions
               of the run a background ``CheckpointPublisher`` commits
               snapshot epochs through the same store; the recorder marks
               the window so the report can price the disruption.
  failures   – ``kill_replica_at`` fails one replica of a replicated store
               mid-run (quorum survives, serving must too);
               ``revive_replica_at`` brings the killed replica back through
               recovery-driven state transfer (kill-then-rejoin);
               ``scale_at``/``scale_to`` fire a live membership change
               (``set_replication``) — a scale event is a fault-injection
               hook like the others; ``stall_at`` parks one session step
               mid-vote and lets a scavenger CAS-terminate it (the
               non-blocking §3.3 path) — the engine keeps serving through
               all of them.

The engine never stalls on any of these: that is the claim the serve bench
gates (publish-window throughput ≥ 80% of steady state, with a replica
volume dead).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .admission import AdmissionConfig, ContinuousBatcher, StepRequest, \
    make_decode
from .publisher import CheckpointPublisher, PublishRecord
from .session import Session, SessionConfig, SessionManager, \
    build_session_store
from .slo import LatencyRecorder, SloReport

__all__ = ["EngineConfig", "ServeEngine", "ServeResult", "run_serve"]


@dataclass
class EngineConfig:
    session: SessionConfig = field(default_factory=SessionConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    decode: str = "stub"               # "stub" | "kernel"
    decode_kwargs: Dict = field(default_factory=dict)
    clients: int = 8
    steps_per_session: int = 25        # closed loop
    arrival: str = "closed"            # "closed" | "open"
    rate_rps: float = 400.0            # open loop arrival rate
    duration_s: float = 1.5            # open loop run length
    batch_mode: str = "batched"        # "batched" | "unbatched"
    max_inflight: int = 256            # open loop shed bound
    # Background publishing window, as fractions of run progress.
    publish_at: Optional[float] = None
    publish_until: Optional[float] = None     # default publish_at + 0.3
    publish_hosts: int = 2
    publish_payload_bytes: int = 1 << 12
    publish_interval_s: float = 0.02
    # Failure injection.
    kill_replica_at: Optional[float] = None   # replicated backend only
    revive_replica_at: Optional[float] = None  # rejoin the killed replica
    scale_at: Optional[float] = None          # live membership change...
    scale_to: Optional[int] = None            # ...to this replication R
    stall_at: Optional[float] = None          # park a step, scavenge it
    stall_ms: float = 50.0
    seed: int = 0


@dataclass
class ServeResult:
    report: SloReport
    publishes: List[PublishRecord] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)


class ServeEngine:
    def __init__(self, cfg: EngineConfig) -> None:
        self.cfg = cfg
        adm = cfg.admission
        if cfg.batch_mode == "unbatched":
            # Same queue, same deadlines — batches of one.  The sweep's
            # control arm: what continuous batching buys.
            adm = AdmissionConfig(
                max_batch=1, window_ms=0.0, queue_depth=adm.queue_depth,
                backpressure=adm.backpressure, deadline_ms=adm.deadline_ms)
        elif cfg.batch_mode != "batched":
            raise ValueError(f"batch_mode must be 'batched' or "
                             f"'unbatched', got {cfg.batch_mode!r}")
        self.adm = adm
        self.store = build_session_store(cfg.session)
        self.mgr = SessionManager(self.store, cfg.session)
        self.batcher = ContinuousBatcher(
            make_decode(cfg.decode, **cfg.decode_kwargs), adm)
        self.recorder = LatencyRecorder()
        self.publisher: Optional[CheckpointPublisher] = None
        self._pub_started_at: Optional[float] = None
        self._fired = set()
        self._done_steps = 0
        self._lock = threading.Lock()
        self._stall_pending = False
        self.replica_killed: Optional[int] = None
        self.replica_revived: Optional[int] = None
        self._scale_thread: Optional[threading.Thread] = None

    # -- progress-fraction event triggers -----------------------------------
    def _maybe_fire(self, frac: float) -> None:
        cfg = self.cfg
        if (cfg.kill_replica_at is not None and frac >= cfg.kill_replica_at
                and "kill" not in self._fired):
            with self._lock:
                if "kill" in self._fired:
                    return
                self._fired.add("kill")
            if hasattr(self.store, "fail_replica"):
                # Kill the highest MEMBER replica: never index 0, which sim
                # configs treat as the leader-colocated one, and never a
                # retired id (a non-member kill is a no-op after scale-in).
                m = getattr(self.store, "membership", None)
                idx = (max(m.replica_ids) if m is not None
                       else len(self.store.replicas) - 1)
                self.store.fail_replica(idx)
                self.replica_killed = idx
        if (cfg.revive_replica_at is not None
                and frac >= cfg.revive_replica_at
                and "revive" not in self._fired):
            with self._lock:
                if "revive" in self._fired:
                    return
                self._fired.add("revive")
            idx = self.replica_killed
            if idx is not None and hasattr(self.store, "revive_replica"):
                # Rejoin through recovery-driven state transfer, not a bare
                # liveness flip: the volume missed writes while dead.
                self.store.revive_replica(idx)
                self.replica_revived = idx
            elif idx is not None and hasattr(self.store, "recover_replica"):
                self.store.recover_replica(idx)
                self.replica_revived = idx
        if (cfg.scale_at is not None and cfg.scale_to is not None
                and frac >= cfg.scale_at and "scale" not in self._fired):
            with self._lock:
                if "scale" in self._fired:
                    return
                self._fired.add("scale")
            if hasattr(self.store, "set_replication"):
                # Reconfiguration does bulk state transfer + an epoch bump;
                # run it beside the serving loop, not inside a step.
                th = threading.Thread(
                    target=self.store.set_replication,
                    args=(cfg.scale_to,), daemon=True)
                th.start()
                self._scale_thread = th
        if (cfg.publish_at is not None and frac >= cfg.publish_at
                and "pub" not in self._fired):
            with self._lock:
                if "pub" in self._fired:
                    return
                self._fired.add("pub")
            hosts = [f"pub{i}" for i in range(cfg.publish_hosts)]
            self.publisher = CheckpointPublisher(
                self.store, hosts,
                payload_bytes=cfg.publish_payload_bytes,
                interval_s=cfg.publish_interval_s).start()
            self._pub_started_at = time.monotonic()
        until = (cfg.publish_until if cfg.publish_until is not None
                 else (cfg.publish_at + 0.3
                       if cfg.publish_at is not None else None))
        if (until is not None and frac >= until
                and "pub" in self._fired and "pub_stop" not in self._fired):
            with self._lock:
                if "pub_stop" in self._fired:
                    return
                self._fired.add("pub_stop")
            self._stop_publisher()
        if (cfg.stall_at is not None and frac >= cfg.stall_at
                and "stall" not in self._fired):
            with self._lock:
                if "stall" in self._fired:
                    return
                self._fired.add("stall")
                self._stall_pending = True

    def _stop_publisher(self) -> None:
        if self.publisher is not None and self._pub_started_at is not None:
            self.publisher.stop()
            self.recorder.mark_window(self._pub_started_at,
                                      time.monotonic())
            self._pub_started_at = None

    def _take_stall(self, session: Session):
        """Claim the pending coordinator stall: returns a ``before_vote``
        that parks THIS step mid-vote while a scavenger CAS-terminates it
        — the step must come back ABORTED, not hang."""
        with self._lock:
            if not self._stall_pending:
                return None
            self._stall_pending = False
        mgr, cfg = self.mgr, self.cfg
        txn = session.step_txn(session.steps)
        parts = list(session.partitions)

        def park(i: int, _p: str) -> None:
            if i == len(parts) - 1:
                threading.Thread(
                    target=mgr.terminate_step,
                    args=(session.sid, txn, parts), daemon=True).start()
                time.sleep(cfg.stall_ms / 1e3)

        return park

    # -- one step end-to-end -------------------------------------------------
    def _serve_step(self, session: Session, step: int) -> None:
        t0 = time.monotonic()
        req = StepRequest(session.sid, step)
        if not self.batcher.submit(req):
            self.recorder.record_reject()
            return
        req.done.wait(timeout=30.0)
        if req.dropped or req.result is None:
            self.recorder.record_drop()
            return
        out = self.mgr.step(session, before_vote=self._take_stall(session))
        t1 = time.monotonic()
        within = req.deadline_at is None or t1 <= req.deadline_at
        self.recorder.record_step((t1 - t0) * 1e3, out.committed, within,
                                  t1, first=(step == 0))
        with self._lock:
            self._done_steps += 1

    # -- arrival processes ---------------------------------------------------
    def _run_closed(self) -> None:
        cfg = self.cfg
        total = max(1, cfg.clients * cfg.steps_per_session)

        def client_loop(ci: int) -> None:
            session = self.mgr.open_session(f"c{ci}")
            if not session.open:
                return
            for step in range(cfg.steps_per_session):
                self._maybe_fire(self._done_steps / total)
                self._serve_step(session, step)
            self.mgr.close_session(session)

        threads = [threading.Thread(target=client_loop, args=(ci,),
                                    daemon=True)
                   for ci in range(cfg.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _run_open(self) -> None:
        cfg = self.cfg
        rng = random.Random(cfg.seed)
        sessions = [self.mgr.open_session(f"c{ci}")
                    for ci in range(cfg.clients)]
        locks = [threading.Lock() for _ in sessions]
        inflight = threading.Semaphore(cfg.max_inflight)
        workers: List[threading.Thread] = []
        t0 = time.monotonic()
        k = 0
        while True:
            now = time.monotonic()
            frac = (now - t0) / cfg.duration_s
            if frac >= 1.0:
                break
            self._maybe_fire(frac)

            def request(idx: int = k % len(sessions)) -> None:
                try:
                    # Steps of one session serialize (its step counter and
                    # KV length are a single stream); different sessions
                    # ride the batcher concurrently.
                    with locks[idx]:
                        s = sessions[idx]
                        if s.open:
                            self._serve_step(s, s.steps)
                finally:
                    inflight.release()

            if inflight.acquire(blocking=False):
                th = threading.Thread(target=request, daemon=True)
                th.start()
                workers.append(th)
            else:
                self.recorder.record_reject()   # open-loop load shedding
            k += 1
            time.sleep(rng.expovariate(cfg.rate_rps))
        for th in workers:
            th.join(timeout=30.0)
        for s, lk in zip(sessions, locks):
            with lk:
                if s.open:
                    self.mgr.close_session(s)

    # -- entry point ---------------------------------------------------------
    def run(self) -> ServeResult:
        cfg = self.cfg
        self.batcher.start()
        run_start = time.monotonic()
        try:
            if cfg.arrival == "closed":
                self._run_closed()
            elif cfg.arrival == "open":
                self._run_open()
            else:
                raise ValueError(f"arrival must be 'closed' or 'open', "
                                 f"got {cfg.arrival!r}")
        finally:
            elapsed = time.monotonic() - run_start
            self._stop_publisher()
            self.batcher.stop()
            if self._scale_thread is not None:
                self._scale_thread.join(timeout=30.0)
        report = self.recorder.report(
            elapsed, run_start, protocol=cfg.session.protocol,
            arrival=cfg.arrival, batch_mode=cfg.batch_mode,
            mean_batch=self.batcher.mean_batch)
        # Durability lifecycle counters (zero on stores built without a
        # LifecycleConfig — getattr keeps legacy stores working).
        report.scrub_repairs = getattr(self.store, "scrub_repairs", 0)
        report.quarantines = getattr(self.store, "quarantines", 0)
        report.gc_truncations = getattr(self.store, "gc_truncations", 0)
        wl = getattr(self.store, "watermark_lag", None)
        report.watermark_lag = wl() if callable(wl) else 0
        counters = {
            "submitted": self.batcher.submitted,
            "batches": self.batcher.batches,
            "max_batch_seen": self.batcher.max_batch_seen,
            "opens": self.mgr.opens,
            "closes": self.mgr.closes,
            "steps_committed": self.mgr.steps_committed,
            "steps_aborted": self.mgr.steps_aborted,
            "terminations": self.mgr.terminations,
            "decision_cache_hits": getattr(self.store,
                                           "decision_cache_hits", 0),
            "singleflight_hits": getattr(self.store,
                                         "singleflight_hits", 0),
            "fast_path_ops": getattr(self.store, "fast_path_ops", 0),
            "fallback_ops": getattr(self.store, "fallback_ops", 0),
            "replica_killed": (-1 if self.replica_killed is None
                               else self.replica_killed),
            "replica_revived": (-1 if self.replica_revived is None
                                else self.replica_revived),
            "reconfigurations": getattr(self.store, "reconfigurations", 0),
            "state_transfers": getattr(self.store, "state_transfers", 0),
            "replication": getattr(self.store, "n", 0),
            "lease_degradations": (self.mgr.keeper.degradations
                                   if self.mgr.keeper is not None else 0),
            "lease_reengagements": (self.mgr.keeper.reengagements
                                    if self.mgr.keeper is not None else 0),
        }
        pubs = list(self.publisher.records) if self.publisher else []
        return ServeResult(report=report, publishes=pubs,
                           counters=counters)


def run_serve(cfg: EngineConfig) -> ServeResult:
    """One-shot convenience: build an engine, run it, return the result."""
    return ServeEngine(cfg).run()
