"""Cornus atomic commit for checkpoint epochs (live deployment of §3.3).

The port's copy of ``repro/ckpt/commit.py``, over the port's ``core``
stores and ``ckpt.shards``.

This is the *deployed* protocol — the same Algorithm-1 semantics the sim in
``repro.core.protocol`` models, but running over real threads and a real
CAS store (``FileStore``: O_EXCL create-if-absent, or ``MemoryStore`` in
tests).  Partition names are host ids; the transaction id is the epoch.

Walkthrough of one epoch on host h (Algorithm 1, participant side):
  1. upload shard payload            → store.put_data(h, "e<N>", bytes)
  2. resp = LogOnce(h, "e<N>", VOTE_YES)
     · resp == ABORT: a peer's termination protocol already gave up on us
       (we were a straggler) — drop the epoch, keep training.
  3. anyone — the coordinator-role host, a peer, or a restarting job —
     resolves the epoch by reading/forcing the collective votes:
       all VOTE_YES/COMMIT → COMMIT;  any ABORT → ABORT;
       missing vote → LogOnce(p, e, ABORT)  [CAS race is safe by log-once]

There is NO commit record for the epoch as a whole: commit == the collective
vote state, exactly the paper's latency optimization — save() returns as
soon as this host's vote is durable + the collective state is resolved, with
no extra decision write on the critical path.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..core.control import LeaseKeeper, QuorumUnavailable
from ..core.state import Decision, Vote
from ..core.storage import FileStore, MemoryStore
from .shards import ec_encode


@dataclass
class CheckpointOutcome:
    epoch: int
    decision: Decision
    vote_ms: float = 0.0          # upload + LogOnce (this host's prepare)
    resolve_ms: float = 0.0       # collective-state resolution
    forced_aborts: int = 0        # stragglers we CAS-aborted


def _txn(epoch: int) -> str:
    return f"e{epoch:012d}"


def _ec_name(epoch: int) -> str:
    # Distinct from the plain payload path: a store can hold both (e.g. a
    # migration rewrites old epochs), and a restore tries plain first.
    return f"{_txn(epoch)}.ec"


class CornusCheckpointer:
    """One per host.  ``hosts`` lists every participant host id."""

    def __init__(self, store, host: str, hosts: Sequence[str],
                 straggler_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.02,
                 lease_duration_s: float = 5.0,
                 ec_k: Optional[int] = None):
        self.store = store
        self.host = host
        self.hosts = list(hosts)
        self.timeout = straggler_timeout_s
        self.poll = poll_interval_s
        # k-of-n erasure coding of shard payloads: fragment i lands on
        # replica volume i, so a committed epoch survives n-k lost volumes
        # at n/k× storage instead of full replication's n×.  Needs a store
        # with addressable replica volumes (the quorum-replicated store).
        if ec_k is not None and not hasattr(store, "replicas"):
            raise ValueError(
                "ec_k needs a replicated store: fragments are placed one "
                "per replica volume")
        self.ec_k = ec_k
        # Leadership-lease upkeep: against a lease-capable store (the
        # replicated quorum store) the long-lived committer holds the epoch
        # ballot, so its LogOnce writes ride the phase-1-free fast path.
        # On a store with no lease API — or when renewal can't reach a
        # quorum, or a live peer holds the lease — ``ensure()`` returns
        # None and every write takes the full-prepare slow path: strictly
        # a performance knob, never a correctness gate.
        self.lease = LeaseKeeper(store, holder=host,
                                 duration_s=lease_duration_s)

    def _writer(self) -> str:
        """Identity to stamp on storage writes: the lease holder when we
        hold a live lease (fast-path accepts), else this host (slow path)."""
        lease = self.lease.ensure()
        return lease.holder if lease is not None else self.host

    # -- participant side ---------------------------------------------------
    def _put_payload(self, epoch: int, payload: bytes) -> None:
        if self.ec_k is None:
            self.store.put_data(self.host, _txn(epoch), payload)
            return
        replicas = self.store.replicas
        alive = self.store.alive_replicas()
        if len(alive) < self.ec_k:
            raise QuorumUnavailable(
                f"{len(alive)}/{len(replicas)} volumes alive, erasure "
                f"coding needs >= k={self.ec_k} fragments placed")
        frags = ec_encode(payload, self.ec_k, len(replicas))
        for r in alive:
            r.put_data(self.host, _ec_name(epoch), frags[r.index])

    def vote(self, epoch: int, payload: bytes) -> Vote:
        """Upload this host's shards, then CAS the VOTE-YES."""
        self._put_payload(epoch, payload)
        return self.store.log_once(self.host, _txn(epoch), Vote.VOTE_YES,
                                   writer=self._writer())

    # -- collective resolution (termination protocol §3.3) -------------------
    def read_states(self, epoch: int) -> Dict[str, Optional[Vote]]:
        return {h: self.store.read_state(h, _txn(epoch)) for h in self.hosts}

    def global_decision(self, epoch: int) -> Decision:
        states = self.read_states(epoch)
        votes = list(states.values())
        if any(v == Vote.ABORT for v in votes):
            return Decision.ABORT
        if all(v in (Vote.VOTE_YES, Vote.COMMIT) for v in votes):
            return Decision.COMMIT
        return Decision.UNDETERMINED

    def terminate(self, epoch: int) -> (Decision, int):
        """Force a decision NOW: CAS ABORT into every missing vote slot.

        Safe under arbitrary concurrency — log-once means the first writer
        wins and everyone converges on the same collective state (Lemma 1).
        """
        forced = 0
        results: List[Vote] = []
        writer = self._writer()
        for h in self.hosts:
            r = self.store.log_once(h, _txn(epoch), Vote.ABORT,
                                    writer=writer)
            if r == Vote.ABORT and \
                    self.store.read_state(h, _txn(epoch)) == Vote.ABORT:
                forced += 1
            results.append(r)
        if any(r == Vote.ABORT for r in results):
            return Decision.ABORT, forced
        return Decision.COMMIT, forced

    def resolve(self, epoch: int, deadline_s: Optional[float] = None
                ) -> (Decision, int):
        """Wait for the collective vote; past the straggler deadline, run the
        termination protocol instead of blocking (paper Theorem 4)."""
        deadline = time.monotonic() + (deadline_s if deadline_s is not None
                                       else self.timeout)
        while True:
            d = self.global_decision(epoch)
            if d != Decision.UNDETERMINED:
                return d, 0
            if time.monotonic() >= deadline:
                return self.terminate(epoch)
            time.sleep(self.poll)

    # -- the full per-host save path -----------------------------------------
    def save(self, epoch: int, payload: bytes,
             straggler_timeout_s: Optional[float] = None
             ) -> CheckpointOutcome:
        t0 = time.monotonic()
        my_vote = self.vote(epoch, payload)
        t1 = time.monotonic()
        if my_vote == Vote.ABORT:
            # A peer already aborted this epoch on our behalf — we were the
            # straggler. Training continues; the epoch is simply not durable.
            return CheckpointOutcome(epoch, Decision.ABORT,
                                     vote_ms=(t1 - t0) * 1e3)
        decision, forced = self.resolve(epoch, straggler_timeout_s)
        t2 = time.monotonic()
        return CheckpointOutcome(epoch, decision,
                                 vote_ms=(t1 - t0) * 1e3,
                                 resolve_ms=(t2 - t1) * 1e3,
                                 forced_aborts=forced)


class AsyncCheckpointer:
    """Overlap checkpoint commits with training: save() returns immediately,
    outcomes are collected on join() or the next save."""

    def __init__(self, inner: CornusCheckpointer):
        self.inner = inner
        self._thread: Optional[threading.Thread] = None
        self.outcomes: List[CheckpointOutcome] = []
        self._lock = threading.Lock()

    def save(self, epoch: int, payload: bytes) -> None:
        self.join()

        def run():
            out = self.inner.save(epoch, payload)
            with self._lock:
                self.outcomes.append(out)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> List[CheckpointOutcome]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            return list(self.outcomes)
