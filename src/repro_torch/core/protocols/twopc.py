"""Conventional 2PC: forced prepare + decision logs, cooperative termination
that *blocks* when the coordinator is down and no peer knows the decision
(§2.1 — the failure mode Cornus exists to remove).

The port's copy of ``repro/core/protocols/twopc.py`` (the standard library
only; the port imports nothing of the JAX package), with one repair: a
coordinator that is forcing its commit record answers a peer's decision
request with "unknown" instead of presuming abort on its own behalf.  The
reference's coordinator then decides ABORT for the peers and still reports
COMMIT to its client (under the "rot" fault mix of ``core.chaos``, at
R = 1, seeds 4352, 61 and 129, its history checker sees it).
"""
from __future__ import annotations

from ..state import Decision, TxnOutcome, TxnSpec, Vote
from .base import CommitProtocol
from .registry import register


@register("2pc")
class TwoPCProtocol(CommitProtocol):

    readonly_prepare_skip = True
    vote_via_log_once = False         # prepare is a plain forced log
    eager_decision_record = True      # commit record forced before reply

    def log_vote(self, spec: TxnSpec, me: str):
        # 2PC prepare: plain forced log write.
        yield self.storage.log(me, spec.txn_id, Vote.VOTE_YES, writer=me)
        return "VOTE-YES"

    def on_vote_timeout(self, spec: TxnSpec, me: str, out: TxnOutcome):
        # Conventional 2PC: unilateral abort on vote timeout.
        yield from ()
        return Decision.ABORT

    def log_decision(self, spec: TxnSpec, me: str, decision: Decision):
        txn = spec.txn_id
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
                self._serve_decision_request(p, txn, me, attempt)
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
                                attempt: int):
        """Peer-side handler for cooperative termination (runs as a server
        thread, so it is modelled at delivery time rather than inside the
        peer's protocol process)."""
        delay = self.cfg.link_rtt_ms(asker, server) / 2.0

        def handle():
            if not self.alive(server):
                return
            st = self.ctx.local_state(server, txn)
            if st["decision"] is not None:
                resp = st["decision"]
            elif st.get("committing") == self.epoch(server):
                # The coordinator is forcing its commit record: COMMIT is
                # already chosen, only not yet durable.  Presuming abort
                # here would decide both ways, so the asker keeps waiting.
                resp = "UNKNOWN"
            elif st["status"] == "none":
                # Never voted: unilaterally abort and answer ABORT.
                if self.participant_logs:
                    self.storage.log(server, txn, Vote.ABORT, writer=server)
                self.ctx.decide(server, txn, Decision.ABORT)
                resp = Decision.ABORT
            else:
                resp = "UNKNOWN"  # voted yes, uncertain — cannot help
            self.send(server, asker, txn, f"dec-resp:{server}:{attempt}", resp)

        self.sim._schedule(self.sim.now + delay, handle)

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
