"""Compute-layer transport: messaging, liveness, and per-txn message slots.

The port's copy of ``repro/core/protocols/transport.py`` (the standard
library only; the port imports nothing of the JAX package).

Extracted from the old ``Cluster`` god-class so protocol strategies share one
substrate: asynchronous one-way messages with geo-aware delays, per-node
fail/recover schedules, and (dst, txn, kind)-keyed rendezvous slots that a
storage service can also deliver into directly (vote forwarding, Table 3's
``cornus-opt1`` / ``paxos-commit`` rows).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..sim import Event, Sim
from ..storage import COMPUTE_RTT_MS, RegionTopology


@dataclass
class ProtocolConfig:
    protocol: str = "cornus"            # any name in protocols.registry
    rtt_ms: float = COMPUTE_RTT_MS      # compute <-> compute round trip
    vote_timeout_ms: float = 25.0       # coordinator waiting for votes
    decision_timeout_ms: float = 25.0   # participant waiting for decision
    votereq_timeout_ms: float = 25.0    # participant waiting for VOTE-REQ
    termination_retry_ms: float = 25.0  # retry period for termination protocol
    # 2PC cooperative termination polls peers with this period while blocked.
    coop_retry_ms: float = 25.0
    # Early Lock Release / speculative precommit (§5.6): locks drop at
    # precommit instead of at decision. Consumed by the txn executor via the
    # on_precommit hook.
    elr: bool = False
    # Geo-distributed deployments (extended §6): per-link RTTs come from a
    # RegionTopology + node→region placement instead of the scalar rtt_ms.
    topology: Optional[RegionTopology] = None
    placement: Dict[str, str] = field(default_factory=dict)
    # --- termination-storm controls (compute side) -------------------------
    # Participants register storage decision watchers before their decision
    # wait, so a decided txn reaches them without waiting out a timeout.
    push_decisions: bool = False
    # Per-(node, txn) singleflight on the termination protocol: concurrent
    # entries (participant timeout + recovery + coordinator vote-timeout)
    # share ONE run's decision instead of racing redundant CAS rounds.
    termination_dedup: bool = False
    # Adaptive timeout policy (duck-typed: ``timeout_ms(kind, base) ->
    # float``).  None keeps the static per-kind fields above EXACTLY; a
    # policy may only observe (it must not consume shared rng or schedule
    # events), so runs whose static timeouts never fire are unchanged.
    timeout_policy: Optional[object] = None

    _TIMEOUT_FIELDS = {
        "vote": "vote_timeout_ms",
        "decision": "decision_timeout_ms",
        "votereq": "votereq_timeout_ms",
        "termination_retry": "termination_retry_ms",
        "coop_retry": "coop_retry_ms",
    }

    def timeout(self, kind: str, lane: Optional[str] = None) -> float:
        """Effective timeout for ``kind`` — the static field, or the
        attached policy's (EWMA-raised, jittered) value, evaluated NOW.
        Use for sleep-like delays (retry periods).

        ``lane`` names the storage lane (partition) whose write the caller
        is waiting on; a per-lane policy reads that lane's EWMA instead of
        the service-global one.  Passed as a third positional only when
        set, so 2-arg duck-typed policies keep working unchanged."""
        base = getattr(self, self._TIMEOUT_FIELDS[kind])
        if self.timeout_policy is None:
            return base
        if lane is None:
            return self.timeout_policy.timeout_ms(kind, base)
        return self.timeout_policy.timeout_ms(kind, base, lane)

    def timeout_ref(self, kind: str, lane: Optional[str] = None):
        """Timeout argument for ``Transport.wait``: the static float, or —
        with a policy attached — a zero-arg provider the wait re-evaluates
        at every deadline expiry.  A wait armed while the latency EWMA was
        still cold then *stretches* with the congestion the policy has
        since observed, instead of firing a spurious first-wave storm."""
        base = getattr(self, self._TIMEOUT_FIELDS[kind])
        if self.timeout_policy is None:
            return base
        if lane is None:
            return lambda: self.timeout_policy.timeout_ms(kind, base)
        return lambda: self.timeout_policy.timeout_ms(kind, base, lane)

    def link_rtt_ms(self, src: str, dst: str) -> float:
        """Round trip between two compute nodes under the active model."""
        if self.topology is None:
            return self.rtt_ms
        default = self.topology.regions[0]
        return self.topology.rtt_ms(self.placement.get(src, default),
                                    self.placement.get(dst, default))


class Transport:
    """N compute nodes inside one Sim: liveness schedules + messaging."""

    def __init__(self, sim: Sim, nodes: List[str], cfg: ProtocolConfig):
        self.sim = sim
        self.nodes = list(nodes)
        self.cfg = cfg
        self.fail_at: Dict[str, float] = {n: float("inf") for n in nodes}
        self.recover_at: Dict[str, float] = {n: float("inf") for n in nodes}
        self._slots: Dict[Tuple[str, str, str], Event] = {}
        self.deliveries = 0        # storage→compute slot deliveries (payloads)
        self.delivery_batches = 0  # message events carrying them
        # Chaos plane (core/chaos.Nemesis); None = no injection, and every
        # hook below is behind that check, so unattached runs are
        # bit-identical. ``duplicate_deliveries`` counts storage→compute
        # payloads suppressed by the idempotent delivery guard.
        self.chaos = None
        self.duplicate_deliveries = 0
        # Crash–restart incarnations: bumped by the cluster when a node
        # comes back from a crash.  A protocol round started under an older
        # incarnation is a ZOMBIE — its volatile state died with the crash
        # and only ``recover()`` speaks for the new process.
        self.incarnations: Dict[str, int] = {}

    # -- liveness -----------------------------------------------------------
    def alive(self, node: str) -> bool:
        t = self.sim.now
        return t < self.fail_at[node] or t >= self.recover_at[node]

    def incarnation(self, node: str) -> int:
        return self.incarnations.get(node, 0)

    def fail(self, node: str, at: float, recover_at: float = float("inf")):
        self.fail_at[node] = at
        self.recover_at[node] = recover_at

    # -- messaging ----------------------------------------------------------
    def slot(self, dst: str, txn: str, kind: str) -> Event:
        key = (dst, txn, kind)
        ev = self._slots.get(key)
        if ev is None:
            ev = self.sim.event()
            self._slots[key] = ev
        return ev

    def send(self, src: str, dst: str, txn: str, kind: str, value=None):
        """One-way message; delivered after rtt/2 if both ends are alive."""
        if not self.alive(src):
            return
        delay = 0.0 if src == dst else self.cfg.link_rtt_ms(src, dst) / 2.0
        slot = self.slot(dst, txn, kind)
        copies = [0.0]
        if self.chaos is not None and src != dst:
            # Self-messages never traverse a link; everything else can be
            # dropped / delayed / duplicated / reordered.  One deliver per
            # surviving copy — a duplicate hitting an already-triggered slot
            # is a no-op (Event.trigger is idempotent).
            copies = self.chaos.message_plan(src, dst)
            if copies is None:
                return

        def deliver():
            if not self.alive(dst):
                return
            if slot.triggered:
                # Idempotent: a chaos-duplicated copy of an already-landed
                # message is suppressed (and counted).  Trigger was always
                # idempotent; the counter makes the guard observable.
                if self.chaos is not None:
                    self.duplicate_deliveries += 1
                return
            slot.trigger(value)

        for extra in copies:
            self.sim._schedule(self.sim.now + delay + extra, deliver)

    def deliver(self, dst: str, txn: str, kind: str, value=None):
        """Immediate delivery into a slot (no extra network delay).

        Used by storage services that forward votes: the service already
        modelled the acceptor/leader → ``dst`` network leg, so the message
        lands NOW — unless ``dst`` is down, in which case it is dropped like
        any other message to a dead node.
        """
        if not self.alive(dst):
            return
        if self.chaos is not None:
            copies = self.chaos.message_plan("storage", dst)
            if copies is None:
                return
            if copies != [0.0]:
                for extra in copies:
                    self.sim._schedule(
                        self.sim.now + extra,
                        lambda: self._deliver_guarded(dst, txn, kind, value,
                                                      batch=True))
                return
        self._deliver_guarded(dst, txn, kind, value, batch=True)

    def deliver_many(self, dst: str,
                     items: List[Tuple[str, str, object]]) -> None:
        """Coalesced storage→coordinator delivery: one message event carrying
        many ``(txn, kind, value)`` payloads — what a storage-side group
        commit flush produces when several slots in one batch forward their
        votes to the same compute node.  Counts as ONE delivery batch."""
        if not items or not self.alive(dst):
            return
        if self.chaos is not None:
            copies = self.chaos.message_plan("storage", dst)
            if copies is None:
                return
            if copies != [0.0]:
                for extra in copies:
                    self.sim._schedule(
                        self.sim.now + extra,
                        lambda: self._deliver_batch(dst, list(items)))
                return
        self._deliver_batch(dst, items)

    def _deliver_guarded(self, dst: str, txn: str, kind: str, value,
                         batch: bool) -> bool:
        """Idempotent delivery guard: a duplicated storage→compute payload
        for an already-triggered ``(dst, txn, kind)`` slot is suppressed —
        counted, never re-fired — so chaos-duplicated forwards cannot
        corrupt waiter state or inflate the delivery counters."""
        if not self.alive(dst):
            return False
        slot = self.slot(dst, txn, kind)
        if slot.triggered:
            self.duplicate_deliveries += 1
            return False
        self.deliveries += 1
        if batch:
            self.delivery_batches += 1
        slot.trigger(value)
        return True

    def _deliver_batch(self, dst: str,
                       items: List[Tuple[str, str, object]]) -> None:
        fresh = 0
        for txn, kind, value in items:
            if self._deliver_guarded(dst, txn, kind, value, batch=False):
                fresh += 1
        if fresh:
            self.delivery_batches += 1

    def wait(self, dst: str, txn: str, kind: str, timeout_ms) -> Event:
        """Event yielding ('msg', value) or ('timeout', None).

        ``timeout_ms`` is a float, or a zero-arg callable (an adaptive
        timeout policy) that is re-evaluated whenever the current deadline
        expires: if the policy has since raised the timeout — e.g. its
        storage-latency EWMA warmed up under congestion — the wait re-arms
        for the difference instead of reporting a timeout.  A float
        behaves exactly as before (single deadline)."""
        slot = self.slot(dst, txn, kind)
        done = self.sim.event()
        fixed = not callable(timeout_ms)
        provider = (lambda: timeout_ms) if fixed else timeout_ms
        t0 = self.sim.now

        def arm(budget_ms: float) -> None:
            any_ev = self.sim.any_of([slot, self.sim.timeout(budget_ms)])

            def on(ev):
                if done.triggered:
                    return
                idx, val = ev.value
                if idx == 0:
                    done.trigger(("msg", val))
                    return
                remaining = (0.0 if fixed
                             else t0 + provider() - self.sim.now)
                if remaining > 1e-9:
                    arm(remaining)
                else:
                    done.trigger(("timeout", None))

            any_ev.subscribe(on)

        arm(provider())
        return done
