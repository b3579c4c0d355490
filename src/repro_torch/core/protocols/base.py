"""CommitProtocol: the strategy interface every Table-3 row implements.

The port's copy of ``repro/core/protocols/base.py`` (the standard library
only; the port imports nothing of the JAX package).

The base class owns the Algorithm-1 *skeleton* — the message choreography
that is identical across 2PC, Cornus, CL, cornus-opt1 and paxos-commit —
and exposes the seams where the variants actually differ (Table 3: who logs
what, and who forwards votes):

  roles (spawned as sim processes by the Cluster facade):
    coordinator_round(spec)      – drive one commit as the coordinator
    participant_round(spec, me)  – one participant's side
    terminate(spec, me, out)     – timeout/termination path    [Alg1 L26-34]
    recover(spec, me)            – post-crash resolution (Table 1/2)

  strategy hooks (what subclasses override):
    log_vote(spec, me)           – persist a YES vote ("VOTE-YES"/"ABORT")
    on_vote_timeout(spec, me, out) – coordinator's vote-collection timeout
    log_decision(spec, me, d)    – coordinator's decision point
    after_decision(spec, me, d)  – post-reply logging (off critical path)
    recovery_resolve(...)        – how an in-doubt log state resolves

  capability flags:
    forwards_votes       – storage forwards votes to the coordinator, so
                           participants skip the explicit vote message
    participant_logs     – False for CL: participants never touch storage
    readonly_prepare_skip – §3.6 second case: may a read-only participant
                           discovered at prepare time skip logging?

Grey-highlighted lines of Algorithm 1 are marked ``# [Alg1 L<n>]`` so the
implementation can be audited against the paper.
"""
from __future__ import annotations

from typing import Optional

from ..state import Decision, TxnOutcome, TxnSpec, Vote
from .context import TxnContext
from .transport import ProtocolConfig, Transport


class VoteForward:
    """The ``on_forward`` callback handed to ``log_once``: delivers a slot's
    decided value into the coordinator's vote slot.  Besides being callable
    (one delivery = one message), it exposes the transport payload so a
    batched storage flush can coalesce several slots' forwards bound for
    the same coordinator into ONE ``Transport.deliver_many`` push."""

    __slots__ = ("transport", "dst", "txn", "kind")

    def __init__(self, transport: Transport, dst: str, txn: str, kind: str):
        self.transport = transport
        self.dst = dst
        self.txn = txn
        self.kind = kind

    def payload(self, v: Vote):
        return (self.txn, self.kind,
                "ABORT" if v == Vote.ABORT else "VOTE-YES")

    def __call__(self, v: Vote) -> None:
        self.transport.deliver(self.dst, *self.payload(v))


class CommitProtocol:
    """Shared commit choreography; subclasses fill in the logging strategy."""

    name: str = ""                      # set by @register
    forwards_votes: bool = False
    participant_logs: bool = True
    readonly_prepare_skip: bool = False
    # Storage deployment this protocol's Table-3 row assumes; the executor
    # uses it as the default ``storage_mode`` for replicated deployments.
    preferred_storage_mode: Optional[str] = None
    # Storage-write choreography descriptors (Table 3's "who logs what"),
    # consumed by backend-agnostic drivers — the threaded wall-clock
    # harness replays each row's forced writes against a real store from
    # these instead of re-implementing the sim strategies:
    #   vote_via_log_once     – participants persist votes with LogOnce
    #                           (Cornus family CAS) vs a plain forced log
    #   eager_decision_record – the coordinator forces a decision record
    #                           before replying (2PC's latency cost)
    vote_via_log_once: bool = True
    eager_decision_record: bool = False

    def __init__(self, transport: Transport, storage, ctx: TxnContext,
                 cfg: ProtocolConfig):
        self.transport = transport
        self.storage = storage
        self.ctx = ctx
        self.cfg = cfg

    # -- convenience --------------------------------------------------------
    @property
    def sim(self):
        return self.transport.sim

    def alive(self, node: str) -> bool:
        return self.transport.alive(node)

    def epoch(self, node: str) -> int:
        """Current crash–restart incarnation of ``node``."""
        return self.transport.incarnation(node)

    def live(self, node: str, epoch: int) -> bool:
        """Alive AND still the same incarnation.  A round that started
        before a crash must not keep acting after the node restarts: the
        real process (and its volatile state) died with the crash, and only
        ``recover()`` speaks for the restarted one.  Rounds capture their
        epoch at entry and guard resumption points with this instead of
        plain ``alive``."""
        return (self.transport.alive(node)
                and self.transport.incarnation(node) == epoch)

    def send(self, src, dst, txn, kind, value=None):
        self.transport.send(src, dst, txn, kind, value)

    def wait(self, dst, txn, kind, timeout_ms):
        return self.transport.wait(dst, txn, kind, timeout_ms)

    # ========================================================================
    # Coordinator role
    # ========================================================================
    def coordinator_round(self, spec: TxnSpec):
        cfg, sim, me = self.cfg, self.sim, spec.coordinator
        txn = spec.txn_id
        t0 = sim.now
        out = TxnOutcome(txn_id=txn, node=me, decision=Decision.UNDETERMINED)

        # §3.6 / §5.1.4: fully read-only txn known upfront — skip both phases
        # in EVERY protocol (locks released immediately by executor hook).
        if spec.all_read_only and spec.read_only_known_upfront:
            out.decision = Decision.COMMIT
            out.caller_latency_ms = sim.now - t0
            out.done_at_ms = sim.now
            self.ctx.decide(me, txn, Decision.COMMIT)
            for p in spec.participants:
                if p != me:
                    self.send(me, p, txn, "decision", Decision.COMMIT)
            self.ctx.record(out)
            return out

        # ---- phase 1: vote requests ---------------------------------------
        ep = self.epoch(me)
        if not self.alive(me):
            return out
        for p in spec.participants:                      # [Alg1 L2-3]
            if p != me:
                self.send(me, p, txn, "vote-req",
                          {"participants": list(spec.participants)})
        # The coordinator's own partition (if participating) votes locally;
        # the result lands in its own vote slot like any remote vote.
        if me in spec.participants:
            self.sim.process(self._local_vote(spec))

        # Collect votes.  Each wait names the storage lane (participant
        # partition) whose vote write gates it, so a per-lane adaptive
        # policy stretches ONLY the deadline of a congested partition.
        waits = [self.wait(me, txn, f"vote:{p}",          # [Alg1 L4-7]
                           cfg.timeout_ref("vote", lane=p))
                 for p in spec.participants]
        results = yield self.sim.all_of(waits)
        if not self.live(me, ep):
            return out
        prepare_done = sim.now
        out.prepare_ms = prepare_done - t0

        timed_out = any(tag == "timeout" for tag, _ in results)
        any_abort = any(tag == "msg" and val == "ABORT" for tag, val in results)

        if any_abort:                                     # [Alg1 L5]
            decision = Decision.ABORT
        elif not timed_out:                               # [Alg1 L6]
            decision = Decision.COMMIT
        else:                                             # [Alg1 L7]
            decision = yield from self.on_vote_timeout(spec, me, out)
        if decision is None or not self.live(me, ep):
            return out

        # ---- decision point (strategy: who logs it, and when) -------------
        yield from self.log_decision(spec, me, decision)
        if not self.live(me, ep):
            return out

        out.decision = decision                           # [Alg1 L8]
        out.caller_latency_ms = sim.now - t0
        out.commit_ms = sim.now - prepare_done
        self.ctx.decide(me, txn, decision)

        for p in spec.participants:                       # [Alg1 L9-10]
            if p != me:
                self.send(me, p, txn, "decision", decision)
        self.after_decision(spec, me, decision)
        out.done_at_ms = sim.now
        self.ctx.record(out)
        return out

    def _local_vote(self, spec: TxnSpec):
        """Coordinator's own partition voting (no network hop); the result
        is sent to the coordinator's vote slot with zero delay so the
        collection loop treats local and remote votes uniformly."""
        me, txn = spec.coordinator, spec.txn_id
        ep = self.epoch(me)
        st = self.ctx.local_state(me, txn)
        if me in spec.read_only and spec.read_only_known_upfront:
            st["status"] = "voted"
            self.send(me, me, txn, f"vote:{me}", "VOTE-YES")
            return
        if not spec.vote_of(me):
            if self.participant_logs:
                self.storage.log(me, txn, Vote.ABORT, writer=me)  # async
            self.ctx.decide(me, txn, Decision.ABORT)
            self.send(me, me, txn, f"vote:{me}", "ABORT")
            return
        vote = yield from self.log_vote(spec, me)
        if not self.live(me, ep):
            return
        if vote == "ABORT":
            # A peer already aborted on our behalf via termination.
            self.ctx.decide(me, txn, Decision.ABORT)
            self.send(me, me, txn, f"vote:{me}", "ABORT")
            return
        st["status"] = "voted"
        if self.cfg.elr:
            self.ctx.precommit(me, txn)
        if not self.forwards_votes:
            self.send(me, me, txn, f"vote:{me}", "VOTE-YES")

    # ========================================================================
    # Participant role                                     [Alg1 L11-25]
    # ========================================================================
    def participant_round(self, spec: TxnSpec, me: str):
        cfg, sim = self.cfg, self.sim
        txn = spec.txn_id
        if me == spec.coordinator:
            return  # voted via _local_vote
        t0 = sim.now
        ep = self.epoch(me)
        out = TxnOutcome(txn_id=txn, node=me, decision=Decision.UNDETERMINED)
        st = self.ctx.local_state(me, txn)

        if spec.all_read_only and spec.read_only_known_upfront:
            tag, val = yield self.wait(
                me, txn, "decision",
                cfg.timeout_ref("votereq", lane=spec.coordinator))
            self.ctx.decide(me, txn, Decision.COMMIT)
            out.decision = Decision.COMMIT
            out.done_at_ms = sim.now
            self.ctx.record(out)
            return out

        tag, msg = yield self.wait(                        # [Alg1 L12]
            me, txn, "vote-req",
            cfg.timeout_ref("votereq", lane=spec.coordinator))
        if not self.live(me, ep):
            return out
        if tag == "timeout":                               # [Alg1 L13]
            if self.participant_logs:
                yield self.storage.log(me, txn, Vote.ABORT, writer=me)
            return self._finish(spec, me, out, Decision.ABORT)

        votes_yes = spec.vote_of(me)
        read_only = me in spec.read_only

        if not votes_yes:
            # VOTE-NO: presumed abort — async log, reply.  [Alg1 L23-25]
            if self.participant_logs:
                self.storage.log(me, txn, Vote.ABORT, writer=me)
            self.send(me, spec.coordinator, txn, f"vote:{me}", "ABORT")
            return self._finish(spec, me, out, Decision.ABORT)

        if read_only and spec.read_only_known_upfront:     # [Alg1 L14]
            # Known-upfront read-only participant: skip prepare logging,
            # release locks, reply YES (§3.6 simple case, all protocols).
            st["status"] = "voted"
            self.send(me, spec.coordinator, txn, f"vote:{me}", "VOTE-YES")
            return self._finish(spec, me, out, Decision.COMMIT)

        if read_only and self.readonly_prepare_skip:
            # §3.6 second case, 2PC side: a read-only participant discovered
            # at prepare time skips logging entirely and can release locks
            # after replying.  (Cornus must NOT take this path: a missing
            # VOTE-YES in its log reads as abortable by the termination
            # protocol — it falls through to log_vote below.)
            st["status"] = "voted"
            self.send(me, spec.coordinator, txn, f"vote:{me}", "VOTE-YES")
            self._watch_decision(spec, me)
            tag, decision = yield self.wait(
                me, txn, "decision",
                cfg.timeout_ref("decision", lane=spec.coordinator))
            if not self.live(me, ep):
                return out
            d = decision if tag == "msg" else Decision.ABORT
            return self._finish(spec, me, out, d)

        # Persist the YES vote (strategy seam: LogOnce for the Cornus
        # family — possibly with storage-side forwarding — plain forced
        # log for 2PC, nothing for CL).                    [Alg1 L15]
        vote = yield from self.log_vote(spec, me)
        if not self.live(me, ep):
            return out
        if vote == "ABORT":                                # [Alg1 L16-17]
            # A peer already aborted on our behalf via termination.
            self.send(me, spec.coordinator, txn, f"vote:{me}", "ABORT")
            return self._finish(spec, me, out, Decision.ABORT)

        st["status"] = "voted"
        out.prepare_ms = sim.now - t0
        if self.cfg.elr:
            self.ctx.precommit(me, txn)
        if not self.forwards_votes:                        # [Alg1 L18-19]
            self.send(me, spec.coordinator, txn, f"vote:{me}", "VOTE-YES")

        # Wait for the decision.  The decision's gating write (2PC's
        # eager commit record) lands on the coordinator's partition, so
        # that is the lane whose congestion should stretch this wait.
        self._watch_decision(spec, me)                     # [Alg1 L20-21]
        tag, decision = yield self.wait(
            me, txn, "decision",
            cfg.timeout_ref("decision", lane=spec.coordinator))
        if not self.live(me, ep):
            return out
        if tag == "timeout":
            out.ran_termination = True
            tstart = sim.now
            decision = yield from self.run_termination(spec, me, out)
            out.termination_ms = sim.now - tstart
            if not self.live(me, ep):
                return out
        if decision is None:
            # Blocked until the sim horizon (2PC family), or died.
            out.decision = Decision.UNDETERMINED
            self.ctx.record(out)
            return out
        # Log the decision locally.                        [Alg1 L22]
        if self.participant_logs:
            yield self.storage.log(me, txn,
                                   Vote.COMMIT if decision == Decision.COMMIT
                                   else Vote.ABORT, writer=me)
        return self._finish(spec, me, out, decision)

    def _finish(self, spec: TxnSpec, me: str, out: TxnOutcome,
                decision: Decision) -> TxnOutcome:
        self.ctx.decide(me, spec.txn_id, decision)
        out.decision = decision
        out.done_at_ms = self.sim.now
        self.ctx.record(out)
        return out

    # ========================================================================
    # Strategy hooks
    # ========================================================================
    def log_vote(self, spec: TxnSpec, me: str):
        """Persist ``me``'s YES vote; return "VOTE-YES" or "ABORT" (the
        latter when a termination peer won the race for the log slot)."""
        raise NotImplementedError
        yield  # generator protocol

    def on_vote_timeout(self, spec: TxnSpec, me: str, out: TxnOutcome):
        """Coordinator timed out collecting votes; return the decision
        (None = blocked/dead)."""
        raise NotImplementedError
        yield

    def log_decision(self, spec: TxnSpec, me: str, decision: Decision):
        """Coordinator's decision point, BEFORE replying to the caller.
        Cornus-family: nothing (the latency win)."""
        yield from ()

    def after_decision(self, spec: TxnSpec, me: str,
                       decision: Decision) -> None:
        """Off-critical-path logging after the caller got its reply."""

    def terminate(self, spec: TxnSpec, me: str, out: TxnOutcome):
        """Resolve an in-doubt transaction after a timeout; return the
        decision or None (blocked/dead)."""
        raise NotImplementedError
        yield

    def run_termination(self, spec: TxnSpec, me: str, out: TxnOutcome):
        """``terminate`` behind a per-(node, txn) singleflight.

        With ``cfg.termination_dedup`` a node's concurrent termination
        entries (decision-timeout participant, vote-timeout coordinator,
        recovery) join the run already in flight and share its decision
        instead of racing redundant CAS rounds.  A joiner that receives
        None (the runner died mid-termination) retries as the leader —
        dedup never turns a live node's bounded termination into a
        blocked one.  Always the entry point; ``terminate`` stays the
        per-protocol mechanism."""
        key = (me, spec.txn_id)
        joined = False
        while self.cfg.termination_dedup:
            inflight = self.ctx.term_inflight.get(key)
            if inflight is None:
                break
            if not joined:
                # One logical join per caller, however many dead runners
                # it outlives — keeps dedup_hits an honest effectiveness
                # counter.
                joined = True
                self.ctx.dedup_hits += 1
            out.ran_termination = True
            decision = yield inflight
            if decision is not None or not self.alive(me):
                return decision
        self.ctx.terminations += 1
        if not self.cfg.termination_dedup:
            return (yield from self.terminate(spec, me, out))
        ev = self.ctx.term_inflight[key] = self.sim.event()
        decision = None
        try:
            decision = yield from self.terminate(spec, me, out)
        finally:
            if self.ctx.term_inflight.get(key) is ev:
                del self.ctx.term_inflight[key]
            ev.trigger(decision)
        return decision

    def _watch_decision(self, spec: TxnSpec, me: str) -> None:
        """Register a storage decision watcher feeding ``me``'s decision
        slot (``cfg.push_decisions``): the service pushes the txn's first
        terminal record the moment it lands, so a participant whose
        coordinator is slow or dead learns the decision without timing out
        into the termination protocol."""
        if not self.cfg.push_decisions:
            return
        watch = getattr(self.storage, "watch_decision", None)
        if watch is None:
            return
        txn = spec.txn_id

        def push(value: Vote) -> None:
            # The storage already charged its front-end→me push leg.
            d = (Decision.ABORT if value == Vote.ABORT else Decision.COMMIT)
            self.transport.deliver(me, txn, "decision", d)

        watch(txn, push, node=me)

    # -- vote forwarding (cornus-opt1 / paxos-commit) -----------------------
    def _vote_forward(self, spec: TxnSpec, me: str) -> dict:
        """log_once kwargs that make the storage service forward the slot's
        decided value straight to the coordinator's vote slot (Table 3:
        'Paxos leader forwards vote' / 'acceptors forward to coordinator')."""
        return dict(forward_to=spec.coordinator,
                    on_forward=VoteForward(self.transport, spec.coordinator,
                                           spec.txn_id, f"vote:{me}"))

    # ========================================================================
    # Recovery (Table 1 / Table 2 "During Recovery" column)
    # ========================================================================
    def recovery_read_partition(self, spec: TxnSpec, me: str) -> str:
        """Which partition's log a recovering node consults (CL: the
        coordinator's — participants have no log of their own)."""
        return me

    def recover(self, spec: TxnSpec, me: str):
        """Recovered node resolving one in-flight transaction."""
        txn = spec.txn_id
        out = TxnOutcome(txn_id=txn, node=me, decision=Decision.UNDETERMINED)
        part = self.recovery_read_partition(spec, me)
        state = yield self.storage.read_state(part, txn, writer=me)
        if state in (Vote.COMMIT, Vote.ABORT):
            out.decision = Decision(state.value)
        else:
            d = yield from self.recovery_resolve(spec, me, out, state)
            out.decision = d if d else Decision.UNDETERMINED
            if d and self.participant_logs:
                yield self.storage.log(
                    me, txn, Vote.COMMIT if d == Decision.COMMIT
                    else Vote.ABORT, writer=me)
        if out.decision != Decision.UNDETERMINED:
            self.ctx.decide(me, txn, out.decision)
        out.done_at_ms = self.sim.now
        self.ctx.outcomes[(txn, me + ":recovery")] = out
        return out

    def recovery_resolve(self, spec: TxnSpec, me: str, out: TxnOutcome,
                         state: Optional[Vote]):
        """In-doubt log state (None or VOTE-YES) after a crash.  Default
        (Cornus family): the storage-based termination protocol resolves in
        bounded time whether or not anyone else is alive."""
        return (yield from self.run_termination(spec, me, out))
