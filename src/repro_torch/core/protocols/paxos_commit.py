"""paxos-commit (Table 3 row 6, 1.5 RTT): Gray & Lamport's Paxos Commit.

The port's copy of ``repro/core/protocols/paxos_commit.py`` (the standard
library only; the port imports nothing of the JAX package).

Each participant runs one Paxos instance for its vote with itself as the
proposer ("participant coordinates replication", coloc storage mode) and
the *acceptors* send their accept-acks straight to the transaction
coordinator, which learns each instance's outcome the moment a majority of
acks has reached it — vote-req (0.5) + accept (0.5) + forwarded acks (0.5)
= 1.5 RTT to the global decision.  Like Cornus, no decision record is on
the critical path, and the same storage-CAS termination protocol keeps the
protocol non-blocking.
"""
from __future__ import annotations

from .cornus import CornusProtocol
from .registry import register


@register("paxos-commit")
class PaxosCommitProtocol(CornusProtocol):

    forwards_votes = True
    preferred_storage_mode = "coloc"    # acceptors forward to the coordinator
