"""Cluster: thin facade over the pluggable commit-protocol API.

The port's copy of ``repro/core/protocol.py`` (the standard library only;
the port imports nothing of the JAX package).

Historically this module WAS the protocol implementation — a 525-line class
fusing messaging, liveness, timeouts and the Cornus/2PC logic.  That now
lives in ``protocols`` as three separable pieces:

  * ``Transport``      – send/wait/liveness/slots between compute nodes
  * ``TxnContext``     – per-txn bookkeeping, outcomes, executor hooks
  * ``CommitProtocol`` – the strategy interface (coordinator_round /
    participant_round / terminate / recover), selected by name from the
    protocol registry (``register`` / ``get_protocol``)

``Cluster`` wires the three together and keeps the original surface, so
existing call sites — tests, benchmarks, examples — work unchanged:

    cluster = Cluster(sim, storage, nodes, ProtocolConfig(protocol="cornus"))
    done = cluster.run_txn(spec)        # ... cluster.outcomes, .local, ...

New variants plug in without touching this file; see
``repro/core/protocols/cornus_opt1.py`` for a complete ~25-line example.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .sim import Sim
from .state import Decision, TxnSpec
from .protocols import (CommitProtocol, ProtocolConfig, Transport, TxnContext,
                        get_protocol)

__all__ = ["Cluster", "ProtocolConfig"]


class Cluster:
    """N compute nodes + one disaggregated storage service, inside one Sim.

    Each node owns one data partition named after itself (paper §5.1.1:
    "each compute node runs a resource manager and has exclusive access to
    one partition").  The commit protocol is resolved from the registry by
    ``cfg.protocol`` (or the explicit ``protocol=`` override).
    """

    def __init__(self, sim: Sim, storage, nodes: List[str],
                 cfg: ProtocolConfig, protocol: Optional[str] = None):
        self.sim = sim
        self.storage = storage
        self.nodes = list(nodes)
        self.cfg = cfg
        self.transport = Transport(sim, self.nodes, cfg)
        self.ctx = TxnContext(sim)
        cls = get_protocol(protocol or cfg.protocol)
        self.protocol: CommitProtocol = cls(self.transport, storage,
                                            self.ctx, cfg)
        # Crash–restart accounting (chaos plane): restarts performed, and
        # recover() runs the restarts triggered for in-doubt txns.
        self.crash_restarts = 0
        self.recoveries_run = 0
        # (node, t_crash_restart, t_done, slots_scanned) per durable
        # restart scan — the recovery-time bound the GC bench gates.
        self.recovery_spans: List[Tuple[str, float, float, int]] = []

    # -- liveness (delegated to the transport) ------------------------------
    @property
    def fail_at(self) -> Dict[str, float]:
        return self.transport.fail_at

    @property
    def recover_at(self) -> Dict[str, float]:
        return self.transport.recover_at

    def alive(self, node: str) -> bool:
        return self.transport.alive(node)

    def fail(self, node: str, at: float, recover_at: float = float("inf")):
        self.transport.fail(node, at, recover_at)

    # -- messaging ----------------------------------------------------------
    def send(self, src: str, dst: str, txn: str, kind: str, value=None):
        self.transport.send(src, dst, txn, kind, value)

    def wait(self, dst: str, txn: str, kind: str, timeout_ms: float):
        return self.transport.wait(dst, txn, kind, timeout_ms)

    # -- per-txn bookkeeping (delegated to the context) ---------------------
    @property
    def local(self) -> Dict[Tuple[str, str], Dict]:
        return self.ctx.local

    @property
    def outcomes(self) -> Dict[Tuple[str, str], "object"]:
        return self.ctx.outcomes

    @property
    def blocked(self) -> Dict[Tuple[str, str], bool]:
        return self.ctx.blocked

    @property
    def on_precommit(self):
        return self.ctx.on_precommit

    @on_precommit.setter
    def on_precommit(self, fn) -> None:
        self.ctx.on_precommit = fn

    @property
    def on_finish(self):
        return self.ctx.on_finish

    @on_finish.setter
    def on_finish(self, fn) -> None:
        self.ctx.on_finish = fn

    # -- protocol entry points ----------------------------------------------
    def run_txn(self, spec: TxnSpec):
        """Spawn coordinator + participant processes for one transaction.

        Returns the coordinator's done-Event (value: TxnOutcome).
        """
        self.ctx.specs[spec.txn_id] = spec
        for p in spec.participants:
            if p != spec.coordinator:
                self.sim.process(self.protocol.participant_round(spec, p))
        return self.sim.process(self.protocol.coordinator_round(spec))

    def recover_txn(self, spec: TxnSpec, me: str):
        """Recovered node resolving one in-flight transaction (Table 1/2
        "During Recovery"); outcome recorded under (txn, me + ":recovery")."""
        return self.sim.process(self.protocol.recover(spec, me))

    # -- crash–restart (chaos plane) ----------------------------------------
    def schedule_crash_restart(self, node: str, at: float,
                               restart_at: float) -> None:
        """Crash ``node`` at ``at`` and bring it BACK at ``restart_at`` with
        its durable log intact: in-flight protocol rounds die via the
        existing ``alive()`` checks, and on restart the node scans every
        txn it participated in and runs the registered protocol's
        ``recover()`` (Table 1/2 in-doubt resolution) for each one still
        unresolved — against whatever live traffic is running."""
        self.fail(node, at, restart_at)
        self.sim._schedule(restart_at, lambda: self._restart(node))

    def _restart(self, node: str) -> None:
        self.crash_restarts += 1
        # New incarnation: protocol rounds started before the crash detect
        # the bump (CommitProtocol.live) and stop acting — the real process
        # they modelled died with the crash.
        tr = self.transport
        tr.incarnations[node] = tr.incarnation(node) + 1
        if getattr(self.storage, "lifecycle", None) is not None:
            # Lifecycle armed: recovery is bounded by the durable log, not
            # the full in-memory spec table — scan only the node's retained
            # (post-watermark) slots.  This is what makes recovery time
            # flat in history length once GC runs.
            self.sim.process(self._durable_restart(node))
            return
        for txn_id, spec in list(self.ctx.specs.items()):
            if node not in spec.participants and node != spec.coordinator:
                continue
            st = self.ctx.local.get((node, txn_id))
            if st is not None and st.get("decision") is not None:
                continue                       # decided before the crash
            prev = self.ctx.outcomes.get((txn_id, node + ":recovery"))
            if prev is not None and prev.decision != Decision.UNDETERMINED:
                continue                       # already resolved by recovery
            self.recoveries_run += 1
            self.sim.process(self.protocol.recover(spec, node))

    def _durable_restart(self, node: str):
        """Generator process: probe the node's retained durable slots (its
        own partition's post-watermark suffix), then run ``recover()`` for
        the ones still unresolved.  Probe reads go out in parallel batches
        so the scan's wall time reflects storage round trips, not
        serialized latency; truncated slots never appear (the watermark
        already settled them), which is the entire recovery bound.

        A node with no durable record of a txn (e.g. a CL participant —
        ``participant_logs=False``) has nothing in doubt: presumed abort
        covers it exactly as a real restart from an empty log would.
        """
        t0 = self.sim.now
        keys = list(self.storage.partition_log(node))
        scanned = 0
        in_doubt: List[str] = []
        B = 32
        for lo in range(0, len(keys), B):
            chunk = keys[lo:lo + B]
            evs = [self.storage.read_state(p, t, writer=node)
                   for (p, t) in chunk]
            for (p, txn_id), ev in zip(chunk, evs):
                st = yield ev
                scanned += 1
                if st is not None and getattr(st, "is_decision",
                                              lambda: False)():
                    continue                   # settled on disk
                in_doubt.append(txn_id)
        for txn_id in in_doubt:
            spec = self.ctx.specs.get(txn_id)
            if spec is None:
                continue
            st = self.ctx.local.get((node, txn_id))
            if st is not None and st.get("decision") is not None:
                continue                       # decided before the crash
            prev = self.ctx.outcomes.get((txn_id, node + ":recovery"))
            if prev is not None and prev.decision != Decision.UNDETERMINED:
                continue                       # already resolved by recovery
            self.recoveries_run += 1
            yield self.sim.process(self.protocol.recover(spec, node))
        self.recovery_spans.append((node, t0, self.sim.now, scanned))
