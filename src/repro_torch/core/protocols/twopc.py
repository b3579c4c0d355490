"""Conventional 2PC: forced prepare + decision logs, cooperative termination
that *blocks* when the coordinator is down and no peer knows the decision
(§2.1 — the failure mode Cornus exists to remove).

The port's copy of ``repro/core/protocols/twopc.py`` (the standard library
only; the port imports nothing of the JAX package), with the rules by which
it never decides both ways where the reference does (under the chaos mixes
of ``core.chaos``):

  * a node forcing its commit record (``committing``) or its YES vote
    (``voting``) answers a peer's decision request "unknown" instead of
    presuming abort: its outcome is bound, only not yet durable;
  * a node that presumed abort for an attempt (``presumed``, keyed by the
    attempt's ``TxnSpec`` and the incarnation, never by the txn id alone:
    a retry may keep its id) votes ABORT in that attempt, or, as its
    coordinator, decides ABORT;
  * a restarted coordinator whose dead incarnation was forcing its commit
    record presumes abort through its own slot: the decision is what the
    slot answers (the store keeps a slot's first decision), given only
    after the write returns; ``recover`` likewise decides what its
    decision write answers (``decision_from_log``).

Every other path is the reference's, and CL (``coordinator_log``), which
inherits this class, keeps the reference's behaviour.
"""
from __future__ import annotations

from typing import Optional

from ..state import Decision, TxnOutcome, TxnSpec, Vote
from .base import CommitProtocol
from .registry import register


@register("2pc")
class TwoPCProtocol(CommitProtocol):

    readonly_prepare_skip = True
    vote_via_log_once = False         # prepare is a plain forced log
    eager_decision_record = True      # commit record forced before reply
    decision_from_log = True          # presumed abort takes the slot's answer

    def _presumed_abort(self, spec: TxnSpec, me: str) -> bool:
        """Did ``me``, in this incarnation, already presume abort for this
        attempt (``spec``) on a peer's decision request?  Scoped to the
        attempt: a retry that keeps its txn id is a new ``TxnSpec``."""
        mark = self.ctx.local_state(me, spec.txn_id).get("presumed")
        return (mark is not None and mark[0] is spec
                and mark[1] == self.epoch(me))

    def log_vote(self, spec: TxnSpec, me: str):
        if self._presumed_abort(spec, me):
            # This node already answered a peer ABORT for this attempt:
            # a YES now would let the coordinator commit over it.
            yield from ()
            return "ABORT"
        # 2PC prepare: plain forced log write.  While it is in flight this
        # incarnation is not a node that never voted: a peer's decision
        # request must not presume abort on its behalf.
        self.ctx.local_state(me, spec.txn_id)["voting"] = self.epoch(me)
        yield self.storage.log(me, spec.txn_id, Vote.VOTE_YES, writer=me)
        return "VOTE-YES"

    def on_vote_timeout(self, spec: TxnSpec, me: str, out: TxnOutcome):
        # Conventional 2PC: unilateral abort on vote timeout.
        yield from ()
        return Decision.ABORT

    def log_decision(self, spec: TxnSpec, me: str, decision: Decision):
        txn = spec.txn_id
        if decision == Decision.COMMIT and self._presumed_abort(spec, me):
            # The coordinator's node answered a peer ABORT while the votes
            # came in: that answer binds it.
            decision = Decision.ABORT
        if decision == Decision.COMMIT:
            # 2PC: the commit record IS the ground truth — it must be
            # durable before replying to the caller (eager decision log).
            # From here on this incarnation of the coordinator is bound to
            # COMMIT, so a peer's decision request must not presume abort
            # on its behalf while the write is in flight (see
            # ``_serve_decision_request``).
            self.ctx.local_state(me, txn)["committing"] = self.epoch(me)
            yield self.storage.log(me, txn, Vote.COMMIT, writer=me)
        else:
            # Presumed abort: the abort record need not be forced.
            self.storage.log(me, txn, Vote.ABORT, writer=me)
        return decision

    # ========================================================================
    # 2PC cooperative termination (§2.1) — may block
    # ========================================================================
    def terminate(self, spec: TxnSpec, me: str, out: TxnOutcome):
        cfg, sim = self.cfg, self.sim
        txn = spec.txn_id
        attempt = 0
        ep = self.epoch(me)
        while True:
            if not self.live(me, ep):
                return None
            attempt += 1
            # §3.6: a known-upfront read-only participant concludes COMMIT
            # trivially the moment its reads finish — WITHOUT having seen
            # the decision — so its answer is no evidence of the global
            # outcome and must not be consulted.  (The coordinator's own
            # answer is always authoritative, read-only or not.)
            peers = [p for p in list(spec.participants) + [spec.coordinator]
                     if p != me
                     and not (p != spec.coordinator
                              and p in spec.read_only
                              and spec.read_only_known_upfront)]
            for p in peers:
                self.send(me, p, txn, f"dec-req:{me}:{attempt}", me)
                self._serve_decision_request(p, txn, me, attempt, spec)
            waits = [self.wait(me, txn, f"dec-resp:{p}:{attempt}",
                               cfg.timeout_ref("coop_retry", lane=p))
                     for p in peers]
            results = yield self.sim.all_of(waits)
            for tag, val in results:
                if tag == "msg" and val in (Decision.COMMIT, Decision.ABORT):
                    return val
            # Nobody knows: blocked. Retry (models waiting for coordinator
            # recovery); give up only when the sim horizon ends us.
            self.ctx.blocked[(txn, me)] = True
            yield self.sim.timeout(cfg.timeout("coop_retry"))
            if sim.now > 1e7:
                return None

    def _serve_decision_request(self, server: str, txn: str, asker: str,
                                attempt: int, spec: TxnSpec):
        """Peer-side handler for cooperative termination (runs as a server
        thread, so it is modelled at delivery time rather than inside the
        peer's protocol process)."""
        delay = self.cfg.link_rtt_ms(asker, server) / 2.0

        def reply(resp):
            self.send(server, asker, txn, f"dec-resp:{server}:{attempt}", resp)

        def handle():
            if not self.alive(server):
                return
            st = self.ctx.local_state(server, txn)
            ep = self.epoch(server)
            if st["decision"] is not None:
                resp = st["decision"]
            elif st["status"] == "none":
                if self._forcing(st, ep):
                    # Presuming abort here would decide both ways, so the
                    # asker keeps waiting.
                    reply("UNKNOWN")
                    return
                if st.get("committing", ep) != ep:
                    # A dead incarnation of this coordinator was forcing
                    # its commit record, which may have landed: the
                    # decision is what the slot answers, and the answer
                    # waits for the write.
                    self.sim.process(self._presume_from_log(
                        server, spec, ep, reply))
                    return
                # Never voted: unilaterally abort and answer ABORT.
                st["presumed"] = (spec, ep)
                if self.participant_logs:
                    self.storage.log(server, txn, Vote.ABORT, writer=server)
                self.ctx.decide(server, txn, Decision.ABORT)
                resp = Decision.ABORT
            else:
                resp = "UNKNOWN"  # voted yes, uncertain — cannot help
            reply(resp)

        self.sim._schedule(self.sim.now + delay, handle)

    @staticmethod
    def _forcing(st: dict, ep: int) -> Optional[str]:
        """The record incarnation ``ep`` of a node whose local state is
        ``st`` is forcing, if any: "committing" (its commit record) or
        "voting" (its YES vote).  Its outcome is then bound, only not yet
        durable."""
        for mark in ("committing", "voting"):
            if st.get(mark) == ep:
                return mark
        return None

    def _presume_from_log(self, server: str, spec: TxnSpec, ep: int, reply):
        """Presumed abort on ``server``'s own slot, deciding what the slot
        answers (its first decision wins), and replying only after the
        write returns."""
        txn = spec.txn_id
        got = yield self.storage.log(server, txn, Vote.ABORT, writer=server)
        if not self.live(server, ep):
            return
        if got == Vote.COMMIT:
            self.ctx.decide(server, txn, Decision.COMMIT)
        else:
            self.ctx.local_state(server, txn)["presumed"] = (spec, ep)
            self.ctx.decide(server, txn, Decision.ABORT)
        reply(self.ctx.local_state(server, txn)["decision"])

    # -- recovery -----------------------------------------------------------
    def recovery_resolve(self, spec: TxnSpec, me: str, out: TxnOutcome,
                         state):
        if state is None or me == spec.coordinator:
            # No vote logged: presumed abort.  A recovering COORDINATOR with
            # no decision record also aborts — its commit record is the
            # ground truth and it was never written, so nobody committed.
            yield from ()
            return Decision.ABORT
        # Participant that voted yes: uncertain — cooperative termination
        # (blocks while the coordinator stays down, §2.1).
        return (yield from self.run_termination(spec, me, out))
