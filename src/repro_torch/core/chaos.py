"""Chaos plane: seeded fault schedules, the Nemesis that injects them, and
compute-side graceful degradation (retry policy + per-partition breaker).

The port's copy of ``repro/core/chaos.py`` (the standard library only; the
port imports nothing of the JAX package).

Gray & Lamport's adversary for atomic commit is not "a node stops being
called": it loses, duplicates, delays and reorders messages, partitions the
network (symmetrically or one-way), skews clocks, tears replicated writes,
and crash-restarts processes that then recover from their durable log.  This
module makes that adversary a first-class, *reproducible* object:

  * ``FaultSchedule`` — a declarative, JSON-round-trippable description of
    every fault to inject (link chaos, partitions with timed heals, clock
    skew on lease deadlines, torn partial-scatter writes, crash–restarts),
    plus ``FaultSchedule.generate`` for seeded random schedules.
  * ``Nemesis`` — the runtime: attached to a ``Transport`` and a simulated
    storage service it answers their chaos hooks from a DEDICATED rng, so a
    detached nemesis (the default ``chaos is None`` everywhere) leaves every
    existing run bit-identical.
  * ``GuardedStorage`` — compute-side degradation wrapping storage ops: a
    per-attempt deadline with idempotent re-issue (LogOnce retries are safe
    by construction) under a jittered-exponential ``RetryPolicy``, and a
    per-partition ``CircuitBreaker`` that stops hammering an unreachable
    partition (trips / half-open probes surfaced as counters).
  * ``ChaosStore`` — the threaded-store decorator: per-op delay and
    drop→retry against real stores (``MemoryStore`` etc.), same taxonomy.
  * ``write_repro_bundle`` / ``load_repro_bundle`` — serialize the exact
    schedule + run config of a failing chaos run so
    ``python -m benchmarks.chaos --replay <file>`` reproduces it.

Endpoint naming: compute nodes use their transport names (``n0``...), the
storage front end is ``"storage"``, replica endpoints are ``"r0"``...
``"*"`` matches anything.  Partition sides are explicit endpoint lists.
"""
from __future__ import annotations

import json
import os
import random
import time
import threading
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["LinkChaos", "NetPartition", "ClockSkew", "TornWrite",
           "CrashRestart", "BitFlip", "TornTail", "Truncation",
           "FaultSchedule", "Nemesis", "RetryPolicy",
           "CircuitBreaker", "GuardedStorage", "ChaosStore",
           "write_repro_bundle", "load_repro_bundle", "STORAGE", "replica"]

STORAGE = "storage"            # the storage front end's endpoint name


def replica(i: int) -> str:
    """Endpoint name of replica ``i`` (for link faults / partitions)."""
    return f"r{i}"


def _match(pattern: str, name: str) -> bool:
    return pattern == "*" or name == "*" or pattern == name


# ---------------------------------------------------------------------------
# Fault vocabulary (all JSON-serializable dataclasses)
# ---------------------------------------------------------------------------
@dataclass
class LinkChaos:
    """Per-link message chaos active on [at, until)."""

    src: str = "*"
    dst: str = "*"
    at: float = 0.0
    until: float = float("inf")
    drop_p: float = 0.0            # message silently lost
    dup_p: float = 0.0             # message delivered twice
    delay_ms: float = 0.0          # fixed extra delay
    jitter_ms: float = 0.0         # + uniform extra delay
    reorder_p: float = 0.0         # extra reorder jitter on this message
    reorder_ms: float = 3.0        # magnitude of the reorder jitter

    def active(self, t: float) -> bool:
        return self.at <= t < self.until

    def matches(self, src: str, dst: str) -> bool:
        return _match(self.src, src) and _match(self.dst, dst)


@dataclass
class NetPartition:
    """Cut every link between ``side_a`` and ``side_b`` on [at, heal_at);
    ``symmetric=False`` cuts only the a→b direction (asymmetric partition,
    the classic one-way-visibility failure)."""

    at: float
    heal_at: float
    side_a: Tuple[str, ...]
    side_b: Tuple[str, ...]
    symmetric: bool = True

    def active(self, t: float) -> bool:
        return self.at <= t < self.heal_at

    def cuts(self, src: str, dst: str) -> bool:
        a, b = self.side_a, self.side_b
        if src in a and dst in b:
            return True
        return self.symmetric and src in b and dst in a


@dataclass
class ClockSkew:
    """The storage service's clock reads ``skew_ms`` ahead of sim time on
    [at, until) — applied to lease-deadline validity, so positive skew
    expires leases early (spurious acquisitions) and negative skew makes a
    holder trust a lease longer than it should (ballots must still keep it
    safe)."""

    at: float
    until: float
    skew_ms: float

    def active(self, t: float) -> bool:
        return self.at <= t < self.until


@dataclass
class TornWrite:
    """With probability ``p``, a replica scatter on [at, until) reaches only
    the first ``keep`` of its targets — a torn (partial) replicated write,
    the under-replication the quorum/ballot machinery must absorb."""

    at: float
    until: float
    p: float
    keep: int = 1

    def active(self, t: float) -> bool:
        return self.at <= t < self.until


@dataclass
class CrashRestart:
    """Compute node ``node`` crashes at ``at`` and restarts at
    ``restart_at`` with its durable log intact; on restart it runs the
    registered protocol's ``recover()`` for every in-doubt transaction."""

    node: str
    at: float
    restart_at: float


@dataclass
class BitFlip:
    """Durable-state bit-rot: at ``at``, flip ``count`` bytes in the bodies
    of randomly chosen *repairable* records (slots whose txn has another
    intact terminal copy — on a sibling slot, or on another replica at
    R>1).  The checksummed record format must detect the rot, surface a
    typed ``CorruptRecord``, and repair it; without checksums this fault
    would silently serve garbage."""

    at: float
    count: int = 1


@dataclass
class TornTail:
    """With probability ``p``, a non-decision single-store write on
    [at, until) both loses its response AND leaves a torn (truncated)
    durable frame — the classic crash-mid-write.  Safe for the reader to
    treat as absent precisely because the response was lost: the record
    was never acknowledged."""

    at: float
    until: float
    p: float

    def active(self, t: float) -> bool:
        return self.at <= t < self.until


@dataclass
class Truncation:
    """GC pulse train: run the store's watermark truncation pass at ``at``
    and then every ``every_ms`` until ``until`` (one-shot if
    ``every_ms == 0``).  Lets schedules interleave truncation with crashes
    and partitions, which is exactly what AC-GC certifies."""

    at: float
    every_ms: float = 0.0
    until: float = 0.0


_FAULT_KINDS = {"links": LinkChaos, "partitions": NetPartition,
                "skews": ClockSkew, "torn": TornWrite,
                "crashes": CrashRestart, "bitflips": BitFlip,
                "torn_tails": TornTail, "truncations": Truncation}


@dataclass
class FaultSchedule:
    """Everything a chaos run injects, keyed by one seed — the unit of
    reproducibility: (schedule, bench config) fully determines the run."""

    seed: int = 0
    links: List[LinkChaos] = field(default_factory=list)
    partitions: List[NetPartition] = field(default_factory=list)
    skews: List[ClockSkew] = field(default_factory=list)
    torn: List[TornWrite] = field(default_factory=list)
    crashes: List[CrashRestart] = field(default_factory=list)
    # Durable-state faults (default-empty keeps old bundles loading).
    bitflips: List[BitFlip] = field(default_factory=list)
    torn_tails: List[TornTail] = field(default_factory=list)
    truncations: List[Truncation] = field(default_factory=list)

    # -- serialization (the failure-repro bundle rides on this) ------------
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        kw = {"seed": d.get("seed", 0)}
        for key, typ in _FAULT_KINDS.items():
            items = []
            for entry in d.get(key, []):
                if key == "partitions":
                    entry = dict(entry, side_a=tuple(entry["side_a"]),
                                 side_b=tuple(entry["side_b"]))
                items.append(typ(**entry))
            kw[key] = items
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultSchedule":
        return cls.from_dict(json.loads(s))

    # -- seeded random schedules (the chaos sweep's generator) -------------
    @classmethod
    def generate(cls, seed: int, nodes: Sequence[str], horizon_ms: float,
                 n_replicas: int = 0, mix: str = "full") -> "FaultSchedule":
        """Deterministic schedule for ``seed``: same inputs, same faults.

        ``mix`` picks the fault families: ``messages`` (drop/dup/delay/
        reorder), ``partition`` (timed symmetric+asymmetric cuts),
        ``crash`` (coordinator/participant crash–restarts), ``torn``
        (partial scatters + replica-link chaos), ``skew`` (lease clock
        skew), ``rot`` (durable-state decay: bit-flips, torn write tails,
        GC truncation pulses, plus one crash–restart so recovery replays
        the decayed log), or ``full`` (all of the classic families,
        lighter individual rates — ``rot`` stays opt-in so pre-lifecycle
        schedules keep their exact rng draw sequences)."""
        known = ("messages", "partition", "crash", "torn", "skew", "full",
                 "rot")
        if mix not in known:
            raise ValueError(f"unknown fault mix {mix!r} "
                             f"(one of: {', '.join(known)})")
        rng = random.Random(seed ^ 0xC4A05)
        sched = cls(seed=seed)
        nodes = list(nodes)
        full = mix == "full"
        scale = 0.5 if full else 1.0

        def window(frac_lo=0.05, frac_hi=0.6):
            start = rng.uniform(0.0, horizon_ms * frac_hi)
            length = rng.uniform(frac_lo, frac_hi) * horizon_ms
            return start, min(start + length, horizon_ms)

        if mix in ("messages", "full"):
            for _ in range(rng.randint(1, 3)):
                at, until = window()
                sched.links.append(LinkChaos(
                    src=rng.choice(nodes + ["*"]), dst="*",
                    at=at, until=until,
                    drop_p=rng.uniform(0.0, 0.25) * scale,
                    dup_p=rng.uniform(0.0, 0.3) * scale,
                    delay_ms=rng.uniform(0.0, 3.0),
                    jitter_ms=rng.uniform(0.0, 4.0),
                    reorder_p=rng.uniform(0.0, 0.4),
                    reorder_ms=rng.uniform(1.0, 6.0)))
            # Storage-facing chaos: lost requests/acks on the op path.
            at, until = window()
            sched.links.append(LinkChaos(
                src="*", dst=STORAGE, at=at, until=until,
                drop_p=rng.uniform(0.0, 0.15) * scale,
                delay_ms=rng.uniform(0.0, 2.0)))
        if mix in ("partition", "full"):
            for _ in range(rng.randint(1, 2)):
                at, until = window(0.05, 0.35)
                k = rng.randint(1, max(1, len(nodes) // 2))
                side = tuple(rng.sample(nodes, k))
                rest = tuple(n for n in nodes if n not in side)
                sched.partitions.append(NetPartition(
                    at=at, heal_at=until, side_a=side, side_b=rest,
                    symmetric=rng.random() < 0.6))
        if mix in ("crash", "full"):
            for _ in range(rng.randint(1, 2)):
                at = rng.uniform(0.05, 0.7) * horizon_ms
                down = rng.uniform(0.05, 0.25) * horizon_ms
                sched.crashes.append(CrashRestart(
                    node=rng.choice(nodes), at=at,
                    restart_at=min(at + down, horizon_ms * 0.95)))
        if n_replicas > 1 and mix in ("torn", "full"):
            at, until = window()
            sched.torn.append(TornWrite(
                at=at, until=until, p=rng.uniform(0.05, 0.3) * scale,
                keep=rng.randint(1, max(1, n_replicas - 1))))
            at, until = window()
            sched.links.append(LinkChaos(
                src=STORAGE, dst=replica(rng.randrange(n_replicas)),
                at=at, until=until,
                drop_p=rng.uniform(0.0, 0.3) * scale,
                delay_ms=rng.uniform(0.0, 2.0)))
        if n_replicas > 1 and mix in ("skew", "full"):
            at, until = window()
            sched.skews.append(ClockSkew(
                at=at, until=until,
                skew_ms=rng.choice([-1.0, 1.0]) * rng.uniform(50.0, 400.0)))
        if mix == "rot":
            # Durable-state decay.  ALL rng draws for this family happen
            # only inside this branch: pre-existing mixes' schedules stay
            # bit-identical.
            for _ in range(rng.randint(1, 3)):
                sched.bitflips.append(BitFlip(
                    at=rng.uniform(0.1, 0.8) * horizon_ms,
                    count=rng.randint(1, 2)))
            at, until = window(0.1, 0.5)
            sched.torn_tails.append(TornTail(
                at=at, until=until, p=rng.uniform(0.1, 0.35)))
            # Torn tails ride the lose-response path: arm a storage-link
            # loss window overlapping the torn window so responses are
            # actually lost there.
            sched.links.append(LinkChaos(
                src="*", dst=STORAGE, at=at, until=until,
                drop_p=rng.uniform(0.05, 0.2),
                delay_ms=rng.uniform(0.0, 1.0)))
            sched.truncations.append(Truncation(
                at=rng.uniform(0.05, 0.2) * horizon_ms,
                every_ms=rng.uniform(20.0, 45.0),
                until=horizon_ms))
            at = rng.uniform(0.2, 0.7) * horizon_ms
            down = rng.uniform(0.05, 0.2) * horizon_ms
            sched.crashes.append(CrashRestart(
                node=rng.choice(nodes), at=at,
                restart_at=min(at + down, horizon_ms * 0.95)))
        return sched


# ---------------------------------------------------------------------------
# Nemesis: the runtime that answers the chaos hooks
# ---------------------------------------------------------------------------
class Nemesis:
    """Injects one ``FaultSchedule`` into a live sim.

    All randomness comes from a dedicated rng derived from the schedule
    seed, never from the transport's or storage's shared streams; every
    hook is behind a ``chaos is None`` check at the call site, so an
    unattached run schedules no events and consumes no rng — bit-identical
    to a build without this module.
    """

    def __init__(self, schedule: FaultSchedule, sim, seed: Optional[int] = None):
        self.schedule = schedule
        self.sim = sim
        self.rng = random.Random((schedule.seed if seed is None else seed)
                                 ^ 0x2EBE15)
        # Fault-attribution counters (harvested into BenchResult).
        self.msgs_dropped = 0
        self.msgs_duplicated = 0
        self.msgs_delayed = 0
        self.msgs_reordered = 0
        self.partitions_healed = 0
        self.torn_writes = 0
        self.bit_flips = 0
        self.torn_tails = 0
        self.gc_pulses = 0

    # -- wiring -------------------------------------------------------------
    def attach(self, transport=None, storage=None, cluster=None) -> "Nemesis":
        """Point the chaos hooks of a transport / simulated storage at this
        nemesis, schedule partition-heal accounting, and arm the schedule's
        crash–restarts on the cluster."""
        if transport is not None:
            transport.chaos = self
        if storage is not None:
            inner = getattr(storage, "inner", storage)
            inner.chaos = self
        for p in self.schedule.partitions:
            self.sim._schedule(p.heal_at, self._healed)
        if cluster is not None:
            for c in self.schedule.crashes:
                cluster.schedule_crash_restart(c.node, c.at, c.restart_at)
        if storage is not None:
            inner = getattr(storage, "inner", storage)
            # Durable-state faults target the lifecycle hooks; a store
            # without them (lifecycle off / threaded) simply ignores them.
            if self.schedule.bitflips and hasattr(inner, "bitflip"):
                for bf in self.schedule.bitflips:
                    self.sim._schedule(
                        bf.at, lambda bf=bf: self._flip(inner, bf.count))
            if self.schedule.truncations and hasattr(inner, "gc_pass"):
                for tr in self.schedule.truncations:
                    self.sim._schedule(
                        tr.at, lambda tr=tr: self._gc_pulse(inner, tr))
        return self

    def _flip(self, storage, count: int) -> None:
        for _ in range(count):
            if storage.bitflip(self.rng):
                self.bit_flips += 1

    def _gc_pulse(self, storage, tr: Truncation) -> None:
        self.gc_pulses += 1
        storage.gc_pass(self.sim.now)
        nxt = self.sim.now + tr.every_ms
        if tr.every_ms > 0.0 and nxt < tr.until:
            self.sim._schedule(nxt, lambda: self._gc_pulse(storage, tr))

    def _healed(self) -> None:
        self.partitions_healed += 1

    # -- link chaos (Transport.send / deliver / deliver_many) ---------------
    def _cut(self, src: str, dst: str, t: float) -> bool:
        return any(p.active(t) and p.cuts(src, dst)
                   for p in self.schedule.partitions)

    def message_plan(self, src: str, dst: str) -> Optional[List[float]]:
        """Fate of one src→dst message NOW: ``None`` = dropped, else the
        list of extra-delay offsets to deliver copies at (``[0.0]`` is an
        undisturbed message; two entries = a duplicate)."""
        t = self.sim.now
        if self._cut(src, dst, t):
            self.msgs_dropped += 1
            return None
        delays = [0.0]
        for lc in self.schedule.links:
            if not (lc.active(t) and lc.matches(src, dst)):
                continue
            if lc.drop_p and self.rng.random() < lc.drop_p:
                self.msgs_dropped += 1
                return None
            extra = lc.delay_ms
            if lc.jitter_ms:
                extra += self.rng.random() * lc.jitter_ms
            if lc.reorder_p and self.rng.random() < lc.reorder_p:
                extra += self.rng.random() * lc.reorder_ms
                self.msgs_reordered += 1
            if extra > 0.0:
                self.msgs_delayed += 1
                delays = [d + extra for d in delays]
            if lc.dup_p and self.rng.random() < lc.dup_p:
                self.msgs_duplicated += 1
                delays.append(delays[0]
                              + self.rng.random() * max(lc.jitter_ms, 1.0))
        return delays

    # -- storage chaos (SimStorage._op / ReplicatedSimStorage._scatter) -----
    def storage_op_fate(self, lane: Optional[str]) -> Tuple[str, float]:
        """("ok"|"lose-request"|"lose-response", extra_delay_ms) for one
        single-store op on ``lane``'s compute↔storage link.  A lost request
        never applies; a lost response applies but never answers — the case
        only idempotent retry (LogOnce) recovers from."""
        plan = self.message_plan(lane or "*", STORAGE)
        if plan is None:
            return (("lose-request" if self.rng.random() < 0.5
                     else "lose-response"), 0.0)
        return ("ok", plan[0])

    def replica_leg(self, i: int) -> Optional[float]:
        """Fate of one front-end↔replica-``i`` leg: ``None`` = lost, else
        extra delay in ms."""
        plan = self.message_plan(STORAGE, replica(i))
        return None if plan is None else plan[0]

    def torn_targets(self, targets: List[int]) -> List[int]:
        """Maybe tear one scatter: only a prefix of the replica targets
        receives the write (the proposer believes it reached everyone)."""
        t = self.sim.now
        for tw in self.schedule.torn:
            if tw.active(t) and self.rng.random() < tw.p:
                self.torn_writes += 1
                return targets[:max(1, min(tw.keep, len(targets)))]
        return targets

    def torn_tail(self) -> bool:
        """Should the current lost-response single-store write ALSO leave a
        torn durable frame?  Consulted by ``SimStorage._op`` only on the
        lose-response path of a non-decision write, so the torn record was
        by construction never acknowledged."""
        t = self.sim.now
        for tt in self.schedule.torn_tails:
            if tt.active(t) and self.rng.random() < tt.p:
                self.torn_tails += 1
                return True
        return False

    def skew_ms(self) -> float:
        """Clock skew the storage service applies to lease deadlines NOW."""
        t = self.sim.now
        return sum(s.skew_ms for s in self.schedule.skews if s.active(t))


# ---------------------------------------------------------------------------
# Compute-side graceful degradation: retry policy + circuit breaker
# ---------------------------------------------------------------------------
@dataclass
class RetryPolicy:
    """Jittered exponential backoff between storage-op re-issues."""

    base_ms: float = 4.0
    factor: float = 2.0
    max_ms: float = 64.0

    def backoff_ms(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.base_ms * (self.factor ** max(0, attempt - 1)),
                  self.max_ms)
        return raw * (0.5 + rng.random())


class CircuitBreaker:
    """Per-partition three-state breaker over storage-op outcomes.

    CLOSED: ops flow.  ``threshold`` consecutive failures trip it OPEN for
    ``cooldown_ms`` (admission waits instead of hammering the partition).
    After the cooldown it HALF-OPENs: one probe op is admitted; success
    closes the breaker, failure re-trips it.  Counters (``trips``,
    ``half_opens``) surface the degradation.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold: int = 3, cooldown_ms: float = 40.0):
        self.threshold = threshold
        self.cooldown_ms = cooldown_ms
        self._state: Dict[str, str] = {}
        self._fails: Dict[str, int] = {}
        self._opened_at: Dict[str, float] = {}
        self.trips = 0
        self.half_opens = 0

    def state(self, p: str) -> str:
        return self._state.get(p, self.CLOSED)

    def admission_delay_ms(self, p: str, now: float) -> float:
        """0 = admit now (CLOSED, or HALF-OPEN probe slot); >0 = wait this
        long before asking again (breaker OPEN)."""
        st = self.state(p)
        if st == self.OPEN:
            remaining = self._opened_at[p] + self.cooldown_ms - now
            if remaining > 1e-9:
                return remaining
            self._state[p] = self.HALF_OPEN
            self.half_opens += 1
        return 0.0

    def note_success(self, p: str) -> None:
        self._fails[p] = 0
        self._state[p] = self.CLOSED

    def note_failure(self, p: str, now: float) -> None:
        if self.state(p) == self.HALF_OPEN:      # failed probe: re-trip
            self._trip(p, now)
            return
        self._fails[p] = self._fails.get(p, 0) + 1
        if self._fails[p] >= self.threshold and self.state(p) == self.CLOSED:
            self._trip(p, now)

    def _trip(self, p: str, now: float) -> None:
        self._state[p] = self.OPEN
        self._opened_at[p] = now
        self._fails[p] = 0
        self.trips += 1


class GuardedStorage:
    """Sim-storage decorator: per-attempt deadlines, idempotent re-issue
    under ``RetryPolicy``, per-partition ``CircuitBreaker`` admission.

    A chaos-dropped storage request (or dropped response) leaves the op's
    Event forever untriggered; the guard re-issues after the deadline —
    safe because LogOnce is idempotent by definition (first write wins,
    re-issues read the winner), ``log`` re-writes the same record, and
    reads are pure.  The breaker turns a persistently unreachable
    partition into bounded, jittered waiting instead of a retry storm.
    Everything delegates, so the guard is a drop-in for any sim store.
    """

    def __init__(self, inner, sim, seed: int = 0,
                 deadline_ms: float = 50.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.inner = inner
        self.sim = sim
        self.rng = random.Random(seed ^ 0x6A4D)
        self.deadline_ms = deadline_ms
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.retries = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- wrapped ops --------------------------------------------------------
    def log_once(self, partition, txn, state, writer="", **kw):
        return self._guard(partition, lambda: self.inner.log_once(
            partition, txn, state, writer, **kw))

    def log(self, partition, txn, state, writer=""):
        return self._guard(partition, lambda: self.inner.log(
            partition, txn, state, writer))

    def read_state(self, partition, txn, writer=""):
        return self._guard(partition, lambda: self.inner.read_state(
            partition, txn, writer))

    def log_batch(self, partition, txn, state, n_records, writer=""):
        return self._guard(partition, lambda: self.inner.log_batch(
            partition, txn, state, n_records, writer))

    def _guard(self, partition: str, issue):
        done = self.sim.event()
        attempt = {"n": 0}

        def admit():
            if done.triggered:
                return
            wait = self.breaker.admission_delay_ms(partition, self.sim.now)
            if wait > 0.0:
                self.sim._schedule(
                    self.sim.now + wait * (1.0 + 0.25 * self.rng.random()),
                    admit)
                return
            fire()

        def fire():
            attempt["n"] += 1
            ev = issue()
            race = self.sim.any_of([ev, self.sim.timeout(self.deadline_ms)])

            def on(e):
                if done.triggered:
                    return
                idx, val = e.value
                if idx == 0:
                    self.breaker.note_success(partition)
                    done.trigger(val)
                    return
                self.breaker.note_failure(partition, self.sim.now)
                self.retries += 1
                backoff = self.retry.backoff_ms(attempt["n"], self.rng)
                self.sim._schedule(self.sim.now + backoff, admit)

            race.subscribe(on)

        admit()
        return done


# ---------------------------------------------------------------------------
# Threaded-store chaos decorator (delay/drop against real stores)
# ---------------------------------------------------------------------------
class ChaosStore:
    """Wraps a threaded store (``MemoryStore`` / ``FileStore`` /
    ``ReplicatedStore``): each op pays an injected delay and, with
    ``drop_p``, a lost-request that the built-in retry re-issues after a
    jittered exponential backoff (idempotent, like the sim guard).  The
    wall-clock analogue of the Nemesis message plan."""

    def __init__(self, inner, seed: int = 0, drop_p: float = 0.0,
                 delay_ms: float = 0.0, jitter_ms: float = 0.0,
                 max_retries: int = 8,
                 retry: Optional[RetryPolicy] = None):
        self.inner = inner
        self.drop_p = drop_p
        self.delay_ms = delay_ms
        self.jitter_ms = jitter_ms
        self.max_retries = max_retries
        self.retry = retry or RetryPolicy(base_ms=1.0, max_ms=16.0)
        self._rng = random.Random(seed ^ 0x7D20)
        self._lock = threading.Lock()
        self.ops_delayed = 0
        self.ops_dropped = 0
        self.retries = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _draw(self) -> Tuple[float, float, float]:
        with self._lock:
            return (self._rng.random(), self._rng.random(),
                    self._rng.random())

    def _chaos_call(self, fn):
        attempt = 0
        while True:
            r_drop, r_jit, r_back = self._draw()
            delay = self.delay_ms + r_jit * self.jitter_ms
            if delay > 0.0:
                with self._lock:
                    self.ops_delayed += 1
                time.sleep(delay / 1e3)
            if r_drop < self.drop_p and attempt < self.max_retries:
                attempt += 1
                with self._lock:
                    self.ops_dropped += 1
                    self.retries += 1
                raw = min(self.retry.base_ms
                          * (self.retry.factor ** (attempt - 1)),
                          self.retry.max_ms)
                time.sleep(raw * (0.5 + r_back) / 1e3)
                continue
            return fn()

    def log_once(self, partition, txn, state, writer="", **kw):
        return self._chaos_call(lambda: self.inner.log_once(
            partition, txn, state, writer, **kw))

    def log(self, partition, txn, state, writer=""):
        return self._chaos_call(lambda: self.inner.log(
            partition, txn, state, writer))

    def read_state(self, partition, txn):
        return self._chaos_call(lambda: self.inner.read_state(partition, txn))


# ---------------------------------------------------------------------------
# Failure-repro bundles
# ---------------------------------------------------------------------------
def write_repro_bundle(schedule: FaultSchedule, run_config: dict,
                       violations: Sequence[str], out_dir: Optional[str] = None,
                       name: Optional[str] = None) -> str:
    """Serialize a failing chaos run (exact schedule + bench knobs +
    checker output) to JSON; returns the path.  ``benchmarks.chaos
    --replay <path>`` re-runs it bit-for-bit.  Directory from ``out_dir``,
    the ``CHAOS_REPRO_DIR`` env var, or ``./chaos-failures``."""
    out_dir = out_dir or os.environ.get("CHAOS_REPRO_DIR", "chaos-failures")
    os.makedirs(out_dir, exist_ok=True)
    name = name or f"chaos-seed{schedule.seed}-" \
                   f"{run_config.get('protocol', 'unknown')}.json"
    path = os.path.join(out_dir, name)
    payload = {"schema": 1,
               "schedule": schedule.to_dict(),
               "config": dict(run_config),
               "violations": list(violations)}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_repro_bundle(path: str) -> Tuple[FaultSchedule, dict]:
    with open(path) as f:
        payload = json.load(f)
    return (FaultSchedule.from_dict(payload["schedule"]),
            dict(payload["config"]))
