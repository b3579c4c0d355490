"""Cornus (paper Algorithm 1): LogOnce votes, no decision log, storage-based
non-blocking termination.

The port's copy of ``repro/core/protocols/cornus.py`` (the standard library
only; the port imports nothing of the JAX package).

Key behavioural points (vs 2PC):
  * The coordinator never logs a decision; it replies to the caller the
    moment the collective vote is known           (latency win, Fig 5–7).
  * Timeout paths go to the storage-based termination protocol that
    CAS-forces ABORT into unresponsive participants' logs (non-blocking,
    Fig 8).
  * Presumed abort: ABORT logging is async and off the critical path.
"""
from __future__ import annotations

from typing import List

from ..state import Decision, TxnOutcome, TxnSpec, Vote
from .base import CommitProtocol
from .registry import register


@register("cornus")
class CornusProtocol(CommitProtocol):

    def log_vote(self, spec: TxnSpec, me: str):
        # LogOnce(VOTE-YES); forwarding subclasses (cornus-opt1 /
        # paxos-commit) have the storage push the decided value straight to
        # the coordinator.                                 [Alg1 L15]
        fwd = self._vote_forward(spec, me) if self.forwards_votes else {}
        resp = yield self.storage.log_once(me, spec.txn_id, Vote.VOTE_YES,
                                           writer=me, **fwd)
        return "ABORT" if resp == Vote.ABORT else "VOTE-YES"

    def on_vote_timeout(self, spec: TxnSpec, me: str, out: TxnOutcome):
        return (yield from self.run_termination(spec, me, out))

    def after_decision(self, spec: TxnSpec, me: str,
                       decision: Decision) -> None:
        if me in spec.participants:
            # Coordinator-as-participant logs the decision asynchronously.
            self.storage.log(me, spec.txn_id,
                             Vote.COMMIT if decision == Decision.COMMIT
                             else Vote.ABORT, writer=me)

    # ========================================================================
    # Cornus termination protocol                          [Alg1 L26-34]
    # ========================================================================
    def terminate(self, spec: TxnSpec, me: str, out: TxnOutcome):
        cfg = self.cfg
        txn = spec.txn_id
        out.ran_termination = True
        # §3.6: known-upfront read-only participants never log a vote, so
        # their empty slots carry NO information about the transaction —
        # CAS-forcing ABORT into one can "win" a slot whose owner already
        # replied VOTE-YES by message, aborting a transaction the
        # coordinator has committed.  They are excluded from termination
        # exactly as the paper excludes them from the decision phase.
        live = [p for p in spec.participants
                if not (p in spec.read_only and spec.read_only_known_upfront)]
        ep = self.epoch(me)
        while True:
            if not self.live(me, ep):
                return None
            targets = [p for p in live if p != me]
            # CAS ABORT into every other participant's log. [Alg1 L27-28]
            reqs = [self.storage.log_once(p, txn, Vote.ABORT, writer=me)
                    for p in targets]
            # Include own log state (me may have VOTE-YES there, or — if me
            # is a non-participant coordinator — nothing).
            if me in live:
                reqs.append(self.storage.log_once(me, txn, Vote.ABORT,
                                                  writer=me))
            if not reqs:
                # Every voting participant is read-only: nothing was ever
                # at stake and the global decision is trivially COMMIT.
                return Decision.COMMIT
            # No single lane gates this retry (the CAS fan-out spans every
            # participant's partition), so it reads the service-global EWMA.
            to = self.sim.timeout(cfg.timeout("termination_retry"))
            got = yield self.sim.any_of([self.sim.all_of(reqs), to])
            idx, val = got
            if idx == 1:
                continue                                   # [Alg1 L33] retry
            states: List[Vote] = val
            if any(s == Vote.ABORT for s in states):       # [Alg1 L30]
                return Decision.ABORT
            if any(s == Vote.COMMIT for s in states):      # [Alg1 L31]
                return Decision.COMMIT
            # All responses are VOTE-YES.                  [Alg1 L32]
            return Decision.COMMIT
