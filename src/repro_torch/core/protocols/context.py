"""Per-transaction bookkeeping shared across protocol roles.

The port's copy of ``repro/core/protocols/context.py`` (the standard library
only; the port imports nothing of the JAX package).

One ``TxnContext`` per cluster: every node's local view of every transaction
(status / decision), recorded ``TxnOutcome``s, the blocked-marker map used by
2PC's cooperative termination, and the executor hooks (lock release on
finish, ELR on precommit).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..sim import Sim
from ..state import Decision, TxnOutcome


class TxnContext:
    def __init__(self, sim: Sim):
        self.sim = sim
        # (node, txn) -> {"status": none|voted|decided, "decision": Decision}
        self.local: Dict[Tuple[str, str], Dict] = {}
        self.outcomes: Dict[Tuple[str, str], TxnOutcome] = {}
        self.blocked: Dict[Tuple[str, str], bool] = {}
        # Termination accounting: runs started, runs absorbed by the
        # per-(node, txn) singleflight, and the in-flight table itself.
        self.terminations = 0
        self.dedup_hits = 0
        self.term_inflight: Dict[Tuple[str, str], object] = {}
        # Every spec the cluster ever ran, by txn id — what a restarting
        # node scans to find its in-doubt transactions (Table 1/2 recovery
        # needs the participant list, which in a real system would be read
        # from the coordinator's durable log).
        self.specs: Dict[str, "object"] = {}
        # Hooks for the transaction executor (lock release timing, ELR).
        self.on_precommit: Optional[Callable[[str, str, float], None]] = None
        self.on_finish: Optional[
            Callable[[str, str, Decision, float], None]] = None

    def local_state(self, node: str, txn: str) -> Dict:
        return self.local.setdefault((node, txn), {"status": "none",
                                                   "decision": None})

    def decide(self, node: str, txn: str, decision: Decision) -> None:
        """First decision wins (Lemma 1: decisions are irreversible)."""
        st = self.local_state(node, txn)
        if st["decision"] is None:
            st["status"], st["decision"] = "decided", decision
            if self.on_finish:
                self.on_finish(node, txn, decision, self.sim.now)

    def record(self, out: TxnOutcome) -> None:
        self.outcomes[(out.txn_id, out.node)] = out

    def precommit(self, node: str, txn: str) -> None:
        if self.on_precommit:
            self.on_precommit(node, txn, self.sim.now)
