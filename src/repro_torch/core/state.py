"""Transaction-state vocabulary for Cornus / 2PC (paper §3.2, §3.5).

The port's copy of ``repro/core/state.py`` (the standard library
and numpy only; the port imports nothing of the JAX package).

A transaction's *state record* in a participant's log is one of
VOTE_YES / COMMIT / ABORT.  ``LogOnce`` semantics: the first write of a
transaction's state wins; later writes return the existing state.

The *global decision* (paper Definition 1):
  COMMIT  iff every participant's log holds VOTE_YES (or COMMIT),
  ABORT   iff any participant's log holds ABORT,
  UNDETERMINED otherwise.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence


class Vote(enum.Enum):
    """State record types that may appear in a transaction log."""

    VOTE_YES = "VOTE-YES"
    COMMIT = "COMMIT"
    ABORT = "ABORT"

    def is_decision(self) -> bool:
        return self in (Vote.COMMIT, Vote.ABORT)


class Decision(enum.Enum):
    COMMIT = "COMMIT"
    ABORT = "ABORT"
    UNDETERMINED = "UNDETERMINED"


def global_decision(states: Dict[str, Optional[Vote]],
                    participants: Sequence[str]) -> Decision:
    """Paper Definition 1, evaluated over a snapshot of all logs."""
    votes = [states.get(p) for p in participants]
    if any(v == Vote.ABORT for v in votes):
        return Decision.ABORT
    if all(v in (Vote.VOTE_YES, Vote.COMMIT) for v in votes):
        return Decision.COMMIT
    return Decision.UNDETERMINED


@dataclass
class LogRecord:
    """One record in a per-partition transaction-state log."""

    txn_id: str
    state: Vote
    # Who wrote the record: the owning participant, or a peer running the
    # termination protocol on its behalf (paper Alg. 1 line 28).
    writer: str = ""
    # Event-time of the write (simulated ms, or wall-clock in live mode).
    at: float = 0.0


@dataclass
class TxnOutcome:
    """What a single node concluded about a transaction, and when."""

    txn_id: str
    node: str
    decision: Decision
    # Caller-observed latency (coordinator only): from protocol start to the
    # moment the decision could be returned to the txn caller.
    caller_latency_ms: Optional[float] = None
    # Full completion time of this node's local protocol.
    done_at_ms: float = 0.0
    # Phase breakdown for Fig. 6(b,d)-style plots.
    prepare_ms: float = 0.0
    commit_ms: float = 0.0
    ran_termination: bool = False
    termination_ms: float = 0.0


@dataclass
class TxnSpec:
    """Static description of one distributed transaction's commit run."""

    txn_id: str
    coordinator: str
    participants: Sequence[str]  # includes coordinator iff it owns a partition
    # Per-participant vote it *would* cast (True = yes). Abort votes model
    # local conflicts (e.g. NO-WAIT lock failures during execution).
    votes: Dict[str, bool] = field(default_factory=dict)
    # Participants that only read (paper §3.6).
    read_only: frozenset = frozenset()
    # Whether read-only-ness is known to the coordinator before 2PC starts.
    read_only_known_upfront: bool = True

    def vote_of(self, p: str) -> bool:
        return self.votes.get(p, True)

    @property
    def all_read_only(self) -> bool:
        return set(self.participants) <= set(self.read_only)
