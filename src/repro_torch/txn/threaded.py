"""Wall-clock commit bench: real threads against the threaded stores.

The simulated benches prove the protocol *logic*; this harness proves the
unified control plane (``core.control``) on the stores a real deployment
would use — ``MemoryStore`` / ``ReplicatedStore`` under genuinely
concurrent closed-loop workers measured with the wall clock.

Each worker thread commits transactions back-to-back by replaying the
protocol's storage choreography, derived from the SAME strategy-class
flags the sim uses (``participant_logs`` / ``vote_via_log_once`` /
``eager_decision_record``), so write counts per row match Table 3:

  cornus family – LogOnce(VOTE-YES) per participant; no decision record
                  on the critical path.
  2pc           – plain forced prepare log per participant PLUS an eager
                  forced commit record before replying (the latency cost
                  Cornus removes).
  cl            – participants don't log; one coordinator decision record.

Every forced write pays a fixed per-op service delay injected INSIDE the
store op (``perform()``), so throughput is dominated by how many forced
writes each protocol puts on the critical path — machine-independent up
to noise — and a control-plane cache hit, which answers without running
the op, really is cheaper than a CAS round.

A straggler storm exercises the storm controls end-to-end: every
``straggler_every``-th transaction parks before one vote write while
``terminators`` racer threads CAS ABORT into its slots through the same
barrier — producing real decision-cache hits, singleflight joins, and
watcher pushes on the threaded control plane.  On the replicated backend
a ``LeaseKeeper`` holds the store's leadership lease and workers write
under its identity, so commits ride the phase-1-free fast path
(``fast_path_ops``) exactly like the sim results claim.

The port's copy of ``repro/txn/threaded.py`` (the standard library only;
the port imports nothing of the JAX package).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.control import (DecisionCacheConfig, LeaseKeeper, STORM_CONTROL)
from ..core.protocols import get_protocol
from ..core.state import Vote
from ..core.storage import DelayedMemoryStore, DelayedReplicatedStore
from ..core.variants import SIMULATED_RTT_ROWS

__all__ = ["WallclockConfig", "WallclockResult", "commit_txn",
           "run_wallclock", "wallclock_rows", "WALLCLOCK_BACKENDS"]

# Table-3 deployment → threaded backend: the "leader" rows run against the
# single shared store, the "coloc" rows against the quorum-replicated one.
WALLCLOCK_BACKENDS = {"leader": "memory", "coloc": "replicated"}


@dataclass
class WallclockConfig:
    protocol: str = "cornus"          # any registered protocol name
    backend: str = "memory"           # "memory" | "replicated"
    n_nodes: int = 4
    workers: int = 4                  # closed-loop worker threads
    txns_per_worker: int = 40
    participants_per_txn: int = 3
    service_delay_ms: float = 0.4     # per forced store op, inside perform()
    # Straggler storm: every k-th txn parks before one vote write while
    # terminator threads race ABORT into its slots.  0 disables.
    straggler_every: int = 8
    straggler_delay_ms: float = 4.0
    terminators: int = 2
    seed: int = 0
    decisions: DecisionCacheConfig = field(default=STORM_CONTROL)
    replication: int = 3              # replicated backend only
    lease: bool = True                # replicated: run a LeaseKeeper


@dataclass
class WallclockResult:
    protocol: str
    backend: str
    commits: int = 0
    terminated: int = 0               # txns aborted by the storm
    elapsed_s: float = 0.0
    # Control-plane counters (same names as the sim results).
    decision_cache_hits: int = 0
    singleflight_hits: int = 0
    decisions_pushed: int = 0
    fast_path_ops: int = 0
    fallback_ops: int = 0
    lease_acquisitions: int = 0
    lease_degradations: int = 0       # keeper slow-path answers (surfaced)

    @property
    def throughput_tps(self) -> float:
        return self.commits / self.elapsed_s if self.elapsed_s > 0 else 0.0


def commit_txn(store, proto, txn: str, coordinator: str,
               participants: Sequence[str],
               writer_for: Callable[[str], str] = lambda p: p,
               before_vote: Optional[Callable[[int, str], None]] = None
               ) -> bool:
    """Replay one Table-3 commit choreography against a threaded store.

    The storage write sequence is derived from the protocol strategy's
    capability flags (the same flags the sim uses), so forced-write counts
    per row match Table 3 — see the module docstring.  ``writer_for``
    supplies the identity stamped on each write (a lease holder's for the
    replicated fast path); ``before_vote(i, participant)`` runs before the
    i-th vote write, which is where the wall-clock bench parks stragglers.
    Returns True on COMMIT, False when a terminal record beat a vote.
    """
    if not proto.participant_logs:
        # cl: one coordinator decision record, participants log nothing.
        got = store.log_once(coordinator, txn, Vote.COMMIT,
                             writer=writer_for(coordinator))
        return got == Vote.COMMIT
    outcome = None
    for i, p in enumerate(participants):
        if before_vote is not None:
            before_vote(i, p)
        if proto.vote_via_log_once:
            got = store.log_once(p, txn, Vote.VOTE_YES,
                                 writer=writer_for(p))
        else:
            got = store.log(p, txn, Vote.VOTE_YES, writer=writer_for(p))
        if got != Vote.VOTE_YES:
            outcome = got              # a terminal record beat the vote
            break
    if outcome is None:
        if proto.eager_decision_record:
            # 2PC: the commit record is the ground truth — forced before
            # the caller hears COMMIT.
            store.log(coordinator, txn, Vote.COMMIT,
                      writer=writer_for(coordinator))
        return True
    return outcome == Vote.COMMIT


class _StallBoard:
    """Rendezvous between stalled workers and terminator racers.

    A worker parks a txn (its slots) here before sleeping out its
    straggler delay.  The board is append-only and every terminator reads
    it through its OWN cursor, so ALL racers process the SAME txns in the
    same order — their ``log_once`` calls for one slot (aligned by a
    barrier) really are concurrent: one leads, the rest singleflight-join,
    and later slots of an already-terminated txn hit the decision cache."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: List[Tuple[str, List[str]]] = []
        self.closed = False

    def park(self, txn: str, slots: List[str]) -> None:
        with self._lock:
            self._items.append((txn, list(slots)))

    def close(self) -> None:
        self.closed = True

    def items_from(self, cursor: int) -> List[Tuple[str, List[str]]]:
        with self._lock:
            return self._items[cursor:]


def _build_store(cfg: WallclockConfig):
    delay_s = cfg.service_delay_ms / 1e3
    if cfg.backend == "replicated":
        return DelayedReplicatedStore(delay_s, n_replicas=cfg.replication,
                                      seed=cfg.seed,
                                      decisions=cfg.decisions)
    if cfg.backend == "memory":
        return DelayedMemoryStore(delay_s, decisions=cfg.decisions)
    raise ValueError(f"unknown wallclock backend {cfg.backend!r}")


def run_wallclock(cfg: WallclockConfig) -> WallclockResult:
    """Run one protocol row against one threaded backend, wall-clock timed."""
    proto = get_protocol(cfg.protocol)
    store = _build_store(cfg)
    nodes = [f"n{i}" for i in range(cfg.n_nodes)]
    npart = max(1, min(cfg.participants_per_txn, cfg.n_nodes))
    res = WallclockResult(cfg.protocol, cfg.backend)
    res_lock = threading.Lock()

    keeper = None
    if cfg.backend == "replicated" and cfg.lease:
        keeper = LeaseKeeper(store, holder="wallclock-leader")

    def writer_for(p: str) -> str:
        # Replicated deployments write under the lease holder's identity
        # (one committer process holds the epoch): phase-1-free accepts.
        if keeper is not None:
            lease = keeper.ensure()
            if lease is not None:
                return lease.holder
        return p

    board = _StallBoard() if cfg.straggler_every else None
    storm = cfg.straggler_every and cfg.terminators > 0
    barrier = threading.Barrier(cfg.terminators) if storm else None

    def commit_one(worker: int, seq: int) -> None:
        txn = f"w{worker}t{seq}"
        coord = nodes[(worker + seq) % cfg.n_nodes]
        parts = [nodes[(worker + seq + i) % cfg.n_nodes]
                 for i in range(npart)]
        straggle = bool(storm and seq % cfg.straggler_every ==
                        cfg.straggler_every - 1)

        def park(i: int, _p: str, txn=txn, parts=parts, straggle=straggle):
            if straggle and i == len(parts) - 1:
                # Park before the last vote: terminators race ABORT into
                # this txn's slots while we sleep — and a watcher sees the
                # pushed decision (no polling).
                pushed: List[Vote] = []
                store.watch_decision(txn, pushed.append)
                board.park(txn, parts)
                time.sleep(cfg.straggler_delay_ms / 1e3)

        committed = commit_txn(store, proto, txn, coord, parts,
                               writer_for=writer_for, before_vote=park)
        with res_lock:
            if committed:
                res.commits += 1
            else:
                res.terminated += 1

    def worker_loop(worker: int) -> None:
        for seq in range(cfg.txns_per_worker):
            commit_one(worker, seq)

    def terminator_loop(tid: int) -> None:
        cursor = 0
        while not board.closed:
            fresh = board.items_from(cursor)
            if not fresh:
                time.sleep(5e-4)           # poll well inside the stall window
                continue
            cursor += len(fresh)
            for txn, slots in fresh:
                for p in slots:
                    try:
                        barrier.wait(timeout=1.0)
                    except threading.BrokenBarrierError:
                        pass
                    try:
                        store.log_once(p, txn, Vote.ABORT,
                                       writer=f"term{tid}")
                    except Exception:
                        pass               # storm racers never fail the run

    workers = [threading.Thread(target=worker_loop, args=(w,), daemon=True)
               for w in range(cfg.workers)]
    terms = ([threading.Thread(target=terminator_loop, args=(t,),
                               daemon=True)
              for t in range(cfg.terminators)] if storm else [])
    t0 = time.monotonic()
    for t in workers + terms:
        t.start()
    for t in workers:
        t.join()
    res.elapsed_s = time.monotonic() - t0
    if board is not None:
        board.close()
    if barrier is not None:
        barrier.abort()
    for t in terms:
        t.join(timeout=2.0)

    res.decision_cache_hits = store.decision_cache_hits
    res.singleflight_hits = store.singleflight_hits
    res.decisions_pushed = store.decisions_pushed
    res.fast_path_ops = getattr(store, "fast_path_ops", 0)
    res.fallback_ops = getattr(store, "fallback_ops", 0)
    res.lease_acquisitions = (keeper.acquisitions if keeper is not None
                              else getattr(store, "lease_acquisitions", 0))
    res.lease_degradations = (keeper.degradations if keeper is not None
                              else getattr(store, "lease_degradations", 0))
    return res


def wallclock_rows() -> Dict[str, Tuple[str, str]]:
    """Table-3 row → (protocol, threaded backend) for the wall-clock bench."""
    return {row: (protocol, WALLCLOCK_BACKENDS[mode])
            for row, (protocol, mode) in SIMULATED_RTT_ROWS.items()}
