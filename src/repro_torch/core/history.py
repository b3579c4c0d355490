"""Operation histories + the atomic-commit checker (machine-verified AC1–3).

The port's copy of ``repro/core/history.py`` (the standard library only; the
port imports nothing of the JAX package).

A Jepsen-style verifier for the commit layer: every storage operation the
protocols issue (``log_once`` / ``log`` / ``log_batch`` / ``read_state``)
is recorded into an append-only :class:`HistoryRecorder` — call time,
return time, and the value the storage answered — and every per-node
conclusion lands in the shared ``TxnContext``.  After a run (chaotic or
not), :func:`check_run` validates the paper's correctness obligations over
that evidence instead of trusting the protocols' own bookkeeping:

  AC1  no two nodes decide differently (no mixed COMMIT/ABORT per txn) —
       Lemma 1's agreement clause, across live decisions AND post-crash
       ``recover()`` conclusions.
  AC2  COMMIT only if every participant voted yes (checked against the
       ``TxnSpec``'s intended votes).
  AC3  a decision, once made, never changes: each node's recovery
       conclusion matches its live one, and no log slot is ever observed
       holding both terminal values.
  W    writer-of consistency: a participant's VOTE-YES is only ever
       written by the participant itself (Alg. 1 — peers may CAS ABORT
       into a slot, never a yes-vote on another's behalf).
  R    recoverability: a committed txn's participants all have a durable
       VOTE-YES/COMMIT record in the final storage snapshot, so any
       future ``recover()`` re-derives COMMIT (Definition 1).  The abort
       direction is deliberately unchecked — presumed abort legally
       leaves all-yes logs behind for aborted coordinators.
  AC-GC truncation preserves recoverability: every slot the GC watermark
       removed was settled (its txn's terminal decision durable) when it
       was removed, the journaled decision matches what the nodes
       actually decided, and a committed txn's missing snapshot slot is
       only forgiven when the truncation journal holds its COMMIT.

Recording is observation-only (list appends + event subscriptions): with
``history is None`` — the default — every run is bit-identical to one
built without this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .state import Decision, TxnSpec, Vote

__all__ = ["HistoryOp", "HistoryRecorder", "Violation", "check_history",
           "check_run", "collect_decisions"]


@dataclass
class HistoryOp:
    """One storage operation as the caller saw it."""

    kind: str                       # log_once | log | log_batch | read
    partition: str
    txn: str
    state: Optional[Vote]           # argument (None for reads)
    writer: str
    t_call: float
    t_ret: Optional[float] = None   # None = never completed (chaos ate it)
    result: Optional[Vote] = None   # what storage answered


class HistoryRecorder:
    """Append-only log of storage ops; attached via ``storage.history``."""

    def __init__(self, sim):
        self.sim = sim
        self.ops: List[HistoryOp] = []

    def record(self, ev, kind: str, partition: str, txn: str,
               state: Optional[Vote] = None, writer: str = ""):
        """Record the call now and its completion when ``ev`` triggers;
        returns ``ev`` unchanged so call sites stay expressions."""
        op = HistoryOp(kind, partition, txn, state, writer, self.sim.now)
        self.ops.append(op)

        def done(e):
            op.t_ret = self.sim.now
            op.result = e.value

        ev.subscribe(done)
        return ev

    # -- derived views ------------------------------------------------------
    def slot_observations(self) -> Dict[Tuple[str, str], Set[Vote]]:
        """Terminal values ever observed (as op results) per log slot."""
        obs: Dict[Tuple[str, str], Set[Vote]] = {}
        for op in self.ops:
            if isinstance(op.result, Vote) and op.result.is_decision():
                obs.setdefault((op.partition, op.txn), set()).add(op.result)
        return obs


@dataclass
class Violation:
    rule: str          # AC1 | AC2 | AC3 | writer-of | recoverability
    txn: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] txn={self.txn}: {self.detail}"


def _base_node(node: str) -> str:
    return node[:-len(":recovery")] if node.endswith(":recovery") else node


def collect_decisions(ctx) -> Dict[str, Dict[str, Decision]]:
    """txn -> {node -> terminal Decision}, merging live per-node decisions
    (``ctx.local``) with recorded outcomes — including the ``:recovery``
    conclusions a crash–restart produced.  UNDETERMINED (gave up /
    blocked) is not a decision and is excluded."""
    out: Dict[str, Dict[str, Decision]] = {}
    for (node, txn), st in ctx.local.items():
        d = st.get("decision")
        if d in (Decision.COMMIT, Decision.ABORT):
            out.setdefault(txn, {})[node] = d
    for (txn, node), outcome in ctx.outcomes.items():
        if outcome.decision in (Decision.COMMIT, Decision.ABORT):
            out.setdefault(txn, {}).setdefault(node, outcome.decision)
    return out


def check_history(history: Optional[HistoryRecorder], ctx,
                  specs: Optional[Dict[str, TxnSpec]] = None,
                  snapshot: Optional[Dict[Tuple[str, str], Vote]] = None,
                  participant_logs: bool = True,
                  gc_log: Optional[Sequence] = None,
                  ) -> List[Violation]:
    """Validate AC1–AC3 + writer-of + recoverability (+ AC-GC when a
    truncation journal is supplied); returns violations (empty = the run
    is certified).

    Every rule is deliberately one-sided so chaos cannot manufacture false
    positives: stale reads are legal (only *conflicting terminal* slot
    values violate AC3), presumed abort is legal (recoverability only
    constrains COMMIT), and txns with no registered spec (e.g. the
    single-partition fast path) are skipped where the spec is needed.
    """
    specs = specs if specs is not None else getattr(ctx, "specs", {})
    violations: List[Violation] = []
    decisions = collect_decisions(ctx)
    gc_index: Dict[Tuple[str, str], object] = {}
    if gc_log:
        for e in gc_log:
            gc_index[(e.partition, e.txn)] = e
        # AC-GC — every truncation was justified and journaled truthfully.
        for e in gc_log:
            if not e.settled or e.decision is None:
                violations.append(Violation(
                    "AC-GC", e.txn,
                    f"slot {e.partition} truncated while unsettled "
                    f"(journal decision={e.decision})"))
                continue
            by_node = decisions.get(e.txn)
            if by_node:
                reached = {d.value for d in by_node.values()}
                if e.decision not in reached:
                    violations.append(Violation(
                        "AC-GC", e.txn,
                        f"journal says {e.decision} but nodes decided "
                        f"{sorted(reached)}"))

    for txn, by_node in sorted(decisions.items()):
        spec = specs.get(txn)
        if spec is not None:
            # A read-only participant's conclusion is trivially COMMIT the
            # moment its reads finish (§3.6 — it has nothing at stake and
            # never votes), so it carries no information about the global
            # decision; only the coordinator's and the writers' count.
            by_node = {n: d for n, d in by_node.items()
                       if _base_node(n) == spec.coordinator
                       or _base_node(n) not in spec.read_only}
        kinds = set(by_node.values())
        # AC1 — agreement across every node's conclusion.
        if len(kinds) > 1:
            violations.append(Violation(
                "AC1", txn,
                f"mixed decisions {sorted((n, d.value) for n, d in by_node.items())}"))
        # AC3 — each node's recovery conclusion matches its live one.
        per_base: Dict[str, Set[Decision]] = {}
        for node, d in by_node.items():
            per_base.setdefault(_base_node(node), set()).add(d)
        for base, ds in sorted(per_base.items()):
            if len(ds) > 1:
                violations.append(Violation(
                    "AC3", txn,
                    f"node {base} changed its decision: {sorted(d.value for d in ds)}"))
        if spec is None:
            continue
        if Decision.COMMIT in kinds:
            # AC2 — commit requires unanimous yes-votes.
            naysayers = [p for p in spec.participants
                         if not spec.vote_of(p)]
            if naysayers:
                violations.append(Violation(
                    "AC2", txn, f"committed over no-votes from {naysayers}"))
            # R — committed txns are durably recoverable.  With
            # ``participant_logs=False`` (CL) the participants' slots are
            # empty BY DESIGN; all durable state is the coordinator's
            # batched record, which recovery consults instead.
            if snapshot is not None and participant_logs:
                for p in spec.participants:
                    if p in spec.read_only:
                        continue
                    v = snapshot.get((p, txn))
                    if v in (Vote.VOTE_YES, Vote.COMMIT):
                        continue
                    # A truncated slot is recoverable through the GC
                    # journal's tombstone — but ONLY if it holds COMMIT.
                    e = gc_index.get((p, txn))
                    if v is None and e is not None \
                            and e.decision == Vote.COMMIT.value:
                        continue
                    violations.append(Violation(
                        "recoverability", txn,
                        f"committed but {p}'s durable slot is {v}"))
            elif snapshot is not None:
                v = snapshot.get((spec.coordinator, txn))
                if v != Vote.COMMIT:
                    e = gc_index.get((spec.coordinator, txn))
                    if not (v is None and e is not None
                            and e.decision == Vote.COMMIT.value):
                        violations.append(Violation(
                            "recoverability", txn,
                            f"committed but coordinator {spec.coordinator}'s "
                            f"durable record is {v}"))

    if history is not None:
        # AC3 — no slot ever serves both terminal values.
        for (partition, txn), obs in sorted(
                history.slot_observations().items()):
            if Vote.COMMIT in obs and Vote.ABORT in obs:
                violations.append(Violation(
                    "AC3", txn,
                    f"slot {partition} observed both COMMIT and ABORT"))
        # W — yes-votes are only ever self-written.
        for op in history.ops:
            if (op.kind == "log_once" and op.state == Vote.VOTE_YES
                    and op.writer and op.writer != op.partition):
                violations.append(Violation(
                    "writer-of", op.txn,
                    f"{op.writer} wrote VOTE-YES into {op.partition}'s slot"))
    return violations


def check_run(ctx, storage=None,
              history: Optional[HistoryRecorder] = None,
              participant_logs: bool = True) -> List[Violation]:
    """Post-run convenience: pull the history off the storage, take its
    final durable snapshot (ground truth), and check everything."""
    if history is None and storage is not None:
        history = getattr(storage, "history", None)
    snapshot = None
    if storage is not None and hasattr(storage, "snapshot"):
        snapshot = storage.snapshot()
    return check_history(history, ctx, snapshot=snapshot,
                         participant_logs=participant_logs,
                         gc_log=getattr(storage, "gc_log", None))
