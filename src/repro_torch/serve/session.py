"""Inference sessions as distributed transactions.

The port's copy of ``repro/serve/session.py`` (the standard library only;
the port imports nothing of the JAX package).

Every externally visible state change of an inference session — create,
per-token KV-cache/session-state update, close — is an atomic commit across
the storage partitions holding that session's KV-cache shards.  The commit
runs whatever registered ``CommitProtocol`` the config names, replaying the
Table-3 storage choreography (``txn.threaded.commit_txn``) against a
threaded store built through the unified ``build_store`` factory:

  cornus family – one LogOnce(VOTE-YES) per shard partition, nothing else
                  on the critical path (commit == the collective vote).
  2pc           – one forced vote log per shard partition PLUS an eager
                  forced commit record before the step is acknowledged —
                  the extra write Cornus removes from every session step.
  cl            – a single coordinator decision record.

Writer identity rides on a ``LeaseKeeper`` when the store supports leases
(the replicated quorum store): steady-state session traffic then commits
through the phase-1-free owner-ballot fast path, and quorum loss degrades
to the full-prepare slow path instead of erroring.

Sessions are NOT blocked by a stalled peer: a session step parked mid-vote
(its serving thread died, GCed, or preempted) can be terminated by anyone
via ``terminate_step`` — LogOnce first-writer-wins makes the race safe, and
the parked step observes the terminal record instead of committing (the
paper's non-blocking property, §3.3).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..core.control import LeaseKeeper, STORM_CONTROL, DecisionCacheConfig
from ..core.protocols import get_protocol
from ..core.state import Vote
from ..core.stores import StoreConfig, build_store, is_simulated
from ..txn.threaded import commit_txn

__all__ = ["Session", "SessionConfig", "SessionManager", "StepOutcome",
           "build_session_store"]


@dataclass
class SessionConfig:
    """How sessions map onto transactions and storage."""

    protocol: str = "cornus"           # any registered protocol name
    backend: str = "memory"            # threaded store registry name
    replication: int = 3               # replicated backend only
    kv_partitions: int = 8             # storage partitions holding KV shards
    participants_per_txn: int = 2      # shard partitions per session
    decisions: DecisionCacheConfig = field(default=STORM_CONTROL)
    lease: bool = True                 # LeaseKeeper writer identity
    service_delay_ms: float = 0.0      # injected per forced store op
    seed: int = 0


def build_session_store(cfg: SessionConfig):
    """Construct the session store through the unified factory.

    Simulated backends are rejected up front: session commits block the
    calling serving thread, while sim backends return Events that only a
    ``Sim`` loop can drive."""
    if is_simulated(cfg.backend):
        raise ValueError(
            f"SessionConfig.backend {cfg.backend!r} is a simulated store; "
            f"sessions commit from real serving threads — use a threaded "
            f"backend (memory / replicated / file)")
    return build_store(StoreConfig(
        backend=cfg.backend, seed=cfg.seed, decisions=cfg.decisions,
        replication=cfg.replication,
        service_delay_ms=cfg.service_delay_ms))


@dataclass
class Session:
    """One inference session: id, its KV-shard partitions, and a step
    cursor.  The partition list is stable for the session's lifetime —
    every step transaction commits across the same participant set."""

    sid: str
    client: str
    partitions: List[str]
    kv_len: int = 0                    # tokens appended so far
    steps: int = 0                     # step txns issued (committed or not)
    open: bool = False
    closed: bool = False

    @property
    def coordinator(self) -> str:
        return self.partitions[0]

    def step_txn(self, step: int) -> str:
        return f"{self.sid}/t{step}"


@dataclass
class StepOutcome:
    session: str
    step: int
    committed: bool
    commit_ms: float = 0.0


class SessionManager:
    """Opens, steps, closes, and terminates sessions over one store.

    Thread-safe: many serving threads drive their own sessions through a
    shared manager (the store and the lease keeper are the shared state).
    """

    def __init__(self, store, cfg: SessionConfig,
                 holder: str = "serve-leader") -> None:
        self.store = store
        self.cfg = cfg
        self.proto = get_protocol(cfg.protocol)
        self.keeper = (LeaseKeeper(store, holder=holder)
                       if cfg.lease and hasattr(store, "acquire_lease")
                       else None)
        self._lock = threading.Lock()
        self._next_sid = 0
        self.opens = 0
        self.closes = 0
        self.steps_committed = 0
        self.steps_aborted = 0
        self.terminations = 0

    # -- writer identity ----------------------------------------------------
    def writer_for(self, p: str) -> str:
        """Lease holder's identity when we hold a live lease (replicated
        fast path), else the partition itself (slow path / plain store)."""
        if self.keeper is not None:
            lease = self.keeper.ensure()
            if lease is not None:
                return lease.holder
        return p

    # -- placement ----------------------------------------------------------
    def _partitions_for(self, n: int) -> List[str]:
        """Deterministic shard placement: ``participants_per_txn``
        consecutive KV partitions starting at a session-derived offset, so
        load spreads while a session's participant set stays fixed."""
        k = max(1, min(self.cfg.participants_per_txn,
                       self.cfg.kv_partitions))
        base = (n * 2654435761 + self.cfg.seed) % self.cfg.kv_partitions
        return [f"kv{(base + i) % self.cfg.kv_partitions}"
                for i in range(k)]

    # -- lifecycle ----------------------------------------------------------
    def open_session(self, client: str) -> Session:
        with self._lock:
            n = self._next_sid
            self._next_sid += 1
        s = Session(sid=f"{client}-s{n}", client=client,
                    partitions=self._partitions_for(n))
        ok, _ms = self._commit(f"{s.sid}/open", s)
        s.open = ok
        if ok:
            with self._lock:
                self.opens += 1
        return s

    def step(self, session: Session,
             before_vote: Optional[Callable[[int, str], None]] = None
             ) -> StepOutcome:
        """Commit one KV-cache update transactionally across the session's
        shard partitions.  ``before_vote`` is the straggler-injection hook
        (the engine parks here to prove non-blocking termination)."""
        step = session.steps
        session.steps += 1
        ok, ms = self._commit(session.step_txn(step), session,
                              before_vote=before_vote)
        if ok:
            session.kv_len += 1
            with self._lock:
                self.steps_committed += 1
        else:
            with self._lock:
                self.steps_aborted += 1
        return StepOutcome(session.sid, step, ok, commit_ms=ms)

    def close_session(self, session: Session) -> bool:
        ok, _ms = self._commit(f"{session.sid}/close", session)
        session.closed = ok
        if ok:
            with self._lock:
                self.closes += 1
        return ok

    # -- termination (non-blocking resolution of a parked step) -------------
    def terminate_step(self, session_id: str, step_txn: str,
                       partitions: Sequence[str],
                       writer: str = "scavenger") -> bool:
        """CAS ABORT into every slot of a parked step transaction.

        Anyone may run this against a step whose serving thread stalled;
        first-writer-wins makes concurrent terminators and the (still
        parked) original committer converge on one outcome.  Returns True
        when the step ends ABORTED, False when its votes had already all
        landed (the step commits under the stalled thread's feet)."""
        results = []
        for p in partitions:
            try:
                results.append(self.store.log_once(p, step_txn, Vote.ABORT,
                                                   writer=writer))
            except Exception:
                return False           # quorum loss: leave it unresolved
        with self._lock:
            self.terminations += 1
        return any(r == Vote.ABORT for r in results)

    # -- the commit choreography -------------------------------------------
    def _commit(self, txn: str, session: Session,
                before_vote: Optional[Callable[[int, str], None]] = None
                ) -> tuple:
        t0 = time.monotonic()
        ok = commit_txn(self.store, self.proto, txn, session.coordinator,
                        session.partitions, writer_for=self.writer_for,
                        before_vote=before_vote)
        return ok, (time.monotonic() - t0) * 1e3
