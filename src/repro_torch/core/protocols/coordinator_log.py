"""Coordinator-log (CL) optimization [Stamos & Cristian], §5.6.

The port's copy of ``repro/core/protocols/coordinator_log.py`` (the standard
library only; the port imports nothing of the JAX package).

Participants reply votes WITHOUT logging; the coordinator batches all
participants' redo logs + its decision into ONE storage write, then replies
to the caller.  Faster than 2PC (one batched write vs sequential
prepare-then-decision), slower than Cornus (the caller still waits for a
storage write), and it violates site autonomy (§5.6) — which is why
participants here never touch storage and must consult the *coordinator's*
log during recovery.
"""
from __future__ import annotations

from ..state import Decision, TxnOutcome, TxnSpec, Vote
from .registry import register
from .twopc import TwoPCProtocol


@register("cl")
class CoordinatorLogProtocol(TwoPCProtocol):

    participant_logs = False            # votes ride in the ack message

    def log_vote(self, spec: TxnSpec, me: str):
        # CL: reply the vote immediately — NO local logging.  The vote reply
        # carries this participant's redo records (bigger ack message, §5.6).
        yield from ()
        return "VOTE-YES"

    def log_decision(self, spec: TxnSpec, me: str, decision: Decision):
        # ONE batched write: every participant's redo log + the decision.
        yield self.storage.log_batch(
            me, spec.txn_id,
            Vote.COMMIT if decision == Decision.COMMIT else Vote.ABORT,
            n_records=len(spec.participants) + 1, writer=me)

    # -- recovery -----------------------------------------------------------
    def recovery_read_partition(self, spec: TxnSpec, me: str) -> str:
        # All durable state lives in the coordinator's batched record.
        return spec.coordinator

    def recovery_resolve(self, spec: TxnSpec, me: str, out: TxnOutcome,
                         state):
        if me == spec.coordinator:
            # The only logger never wrote its batch: presumed abort.
            yield self.storage.log(me, spec.txn_id, Vote.ABORT, writer=me)
            return Decision.ABORT
        # Participant: its own log is empty by design — ask peers
        # (cooperative termination against the coordinator's memory/log).
        return (yield from self.run_termination(spec, me, out))
