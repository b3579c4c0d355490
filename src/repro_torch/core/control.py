"""Backend-agnostic storage control plane.

The port's copy of ``repro/core/control.py`` (the standard library
and numpy only; the port imports nothing of the JAX package).

The termination-storm controls (decision cache, singleflight,
decision push), the adaptive timeout policy, and leadership-lease upkeep
used to live as parallel copies: one eager implementation inside the
simulated services (``SimStorage`` / ``ReplicatedSimStorage``), a missing
one in the threaded stores real deployments would use.  This module is the
single control-plane core BOTH backends consume:

  * ``DecisionCacheConfig`` / ``DecisionIndex`` — per-service index of
    terminal txn records, singleflight table, and decision watchers.  The
    sim services drive it with sim Events; ``ThreadControlPlane`` drives
    the same index with real threads.
  * ``EwmaStat`` / ``AdaptiveTimeouts`` — write-latency EWMA+dev tracking
    (now per *lane*, i.e. per partition, so a single hot partition's
    queueing signal is not diluted by idle ones) and the raise-only
    timeout policy that reads it.
  * ``ThreadControlPlane`` — the blocking-store twin of the sim's
    ``_DecisionCacheMixin``: wraps a store's ``log_once`` with cache
    lookup + singleflight + watcher push, and observes per-lane write
    latency for the adaptive policy.
  * ``LeaseKeeper`` — automatic acquisition/renewal of a store leadership
    lease for long-lived committers (the checkpoint loop); renewal failure
    degrades to the full-prepare slow path instead of erroring.

Nothing here schedules sim events or consumes a shared rng: attaching any
of these to a run in which they never fire cannot perturb it.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .state import Vote

log = logging.getLogger(__name__)


class QuorumUnavailable(RuntimeError):
    """Fewer than a majority of replicas reachable (or proposer starved)."""


# --------------------------------------------------------------------------
# Decision cache / singleflight / push (termination-storm controls)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DecisionCacheConfig:
    """Knobs for the storage-side decision cache (termination storms).

    The paper's LogOnce semantics — "returns the existing value" — mean
    that once a transaction's log set holds a terminal record, every later
    LogOnce arrival should *read* the decision, not re-run agreement
    (Gray & Lamport frame the same point for Paxos Commit).  Under a
    saturated serial log lane, timed-out participants racing full
    termination rounds against the queue is exactly the storm that
    inverts the cornus-vs-2PC ordering; these knobs kill it at the
    storage service:

      cache        – once ANY slot of a txn holds a terminal record
                     (COMMIT/ABORT), answer later ``log_once`` calls for
                     that txn from the index: ONE cheap read, no CAS / no
                     Paxos round, no serial-lane occupancy.
      singleflight – concurrent in-flight ``log_once`` rounds for one
                     identical (partition, txn, state) coalesce into ONE
                     round whose result every caller shares (a joiner's
                     CAS could never have mutated the slot anyway).
      push         – proactively deliver a txn's first terminal value to
                     registered watchers (still-waiting participants), so
                     most of them never time out at all.

    The DEFAULT config is inactive: behaviour (and the rng stream) is
    bit-identical to the pre-cache service.  With knobs on, per-node
    decisions keep AC1–AC3 — only round trips disappear.
    """

    cache: bool = False
    singleflight: bool = False
    push: bool = False

    @property
    def active(self) -> bool:
        return self.cache or self.singleflight or self.push


STORM_CONTROL = DecisionCacheConfig(cache=True, singleflight=True, push=True)


class DecisionIndex:
    """Per-service index of terminal txn records + singleflight table +
    decision watchers.  Owned by ``SimStorage`` / ``ReplicatedSimStorage``
    (driven with sim Events) and by ``ThreadControlPlane`` (driven with
    real threads, under its lock)."""

    def __init__(self, cfg: DecisionCacheConfig) -> None:
        self.cfg = cfg
        self.txn_decision: Dict[str, Vote] = {}
        self._watchers: Dict[str, List[Callable[[Vote], None]]] = {}
        self.inflight: Dict[Tuple[str, str, str], object] = {}
        self.hits = 0                  # log_once answered from the index
        self.singleflight_hits = 0     # log_once joined an in-flight round
        self.pushes = 0                # watcher deliveries

    def note(self, partition: str, txn: str,
             value: Optional[Vote]) -> None:
        """Record a terminal value applied/observed for ``txn``; the FIRST
        terminal record fires any registered watchers."""
        if value is None or not value.is_decision():
            return
        if txn in self.txn_decision:
            return
        self.txn_decision[txn] = value
        for cb in self._watchers.pop(txn, ()):
            self.pushes += 1
            cb(value)

    def lookup(self, txn: str) -> Optional[Vote]:
        if not self.cfg.cache:
            return None
        return self.txn_decision.get(txn)

    def watch(self, txn: str, cb: Callable[[Vote], None]) -> None:
        if not self.cfg.push:
            return
        v = self.txn_decision.get(txn)
        if v is not None:
            self.pushes += 1
            cb(v)
        else:
            self._watchers.setdefault(txn, []).append(cb)

    def join(self, key: Tuple[str, str, str]):
        """The in-flight identical round's completion event, if any."""
        if not self.cfg.singleflight:
            return None
        return self.inflight.get(key)

    def lead(self, key: Tuple[str, str, str], ev) -> None:
        if not self.cfg.singleflight:
            return
        self.inflight[key] = ev
        ev.subscribe(lambda _e, key=key: self.inflight.pop(key, None))


# --------------------------------------------------------------------------
# Write-latency observation (per-lane EWMAs) + adaptive timeouts
# --------------------------------------------------------------------------
class EwmaStat:
    """One EWMA + mean-absolute-deviation tracker (the update law the
    global ``write_lat_ewma``/``write_lat_dev`` fields have always used:
    dev updates against the PRE-update mean, alpha 0.25)."""

    __slots__ = ("ewma", "dev")

    def __init__(self) -> None:
        self.ewma: Optional[float] = None
        self.dev = 0.0

    def note(self, ms: float) -> None:
        if self.ewma is None:
            self.ewma = ms
            self.dev = ms / 4.0
        else:
            self.dev = 0.75 * self.dev + 0.25 * abs(ms - self.ewma)
            self.ewma = 0.75 * self.ewma + 0.25 * ms


class AdaptiveTimeouts:
    """EWMA-driven protocol timeouts with desynchronizing jitter.

    The static timeout formula in ``run_bench`` is tuned to the no-load
    service tail; behind a saturated serial log lane the *observed* write
    latency (queueing included) exceeds it by orders of magnitude, and a
    timeout below the real tail self-amplifies: every spuriously timed-out
    participant races a termination round against the same queue — the
    storm that inverts the cornus-vs-2PC ordering.  The policy

      * floors every timeout at the static base, so a run whose static
        timeouts never fire behaves identically (raise-only);
      * raises it to ``k_mean·EWMA + k_dev·dev`` of the storage service's
        observed write latency, clamped to ``cap_factor``× the base;
      * multiplies by a deterministic raise-only jitter from its OWN rng,
        so closed-loop workers that do time out don't re-fire in lockstep.

    With ``per_lane=True`` a call that names a lane (the partition whose
    write the caller is waiting on) reads that LANE's EWMA+dev instead of
    the service-global one: one hot partition's queueing signal raises its
    own deadlines undiluted, while cold lanes keep the static floor.  The
    default (``per_lane=False``) ignores the lane argument entirely, so
    existing runs are bit-identical.

    The policy only reads storage counters — it consumes no shared rng and
    schedules no events, so attaching it cannot perturb a run in which no
    timeout fires.
    """

    def __init__(self, storage, seed: int = 0, k_mean: float = 4.0,
                 k_dev: float = 8.0, cap_factor: float = 64.0,
                 jitter: float = 0.25, per_lane: bool = False) -> None:
        self.storage = storage
        self.k_mean = k_mean
        self.k_dev = k_dev
        self.cap_factor = cap_factor
        self.jitter = jitter
        self.per_lane = per_lane
        self._rng = random.Random(seed ^ 0x7E0117)

    def _observed(self, lane: Optional[str]) -> Tuple[Optional[float], float]:
        if self.per_lane and lane is not None:
            lane_fn = getattr(self.storage, "lane_write_latency", None)
            got = lane_fn(lane) if lane_fn is not None else None
            if got is not None:
                return got
            # Lane never observed: keep the static floor rather than
            # inheriting another lane's congestion through the global EWMA.
            return None, 0.0
        return (getattr(self.storage, "write_lat_ewma", None),
                getattr(self.storage, "write_lat_dev", 0.0))

    def timeout_ms(self, kind: str, base_ms: float,
                   lane: Optional[str] = None) -> float:
        ewma, dev = self._observed(lane)
        t = base_ms
        if ewma is not None:
            t = max(base_ms, min(self.cap_factor * base_ms,
                                 self.k_mean * ewma + self.k_dev * dev))
        if self.jitter:
            t *= 1.0 + self.jitter * self._rng.random()
        return t


# --------------------------------------------------------------------------
# Threaded control plane (decision cache for blocking stores)
# --------------------------------------------------------------------------
class _Flight:
    """One in-flight threaded ``log_once`` round being shared."""

    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result: Optional[Vote] = None
        self.error: Optional[BaseException] = None


class ThreadControlPlane:
    """The blocking-store twin of the sim's decision-cache mixin.

    Owns ONE ``DecisionIndex`` (the same class the sim services use) and
    serializes access to it with a re-entrant lock; the wrapped store calls
    ``log_once(perform, ...)`` where ``perform()`` executes the real
    operation.  Semantics mirror the sim exactly:

      * cache hit   – the txn already holds a terminal record: return it
                      without running ``perform`` (no CAS, no quorum round).
      * singleflight – an identical (partition, txn, state) call is already
                      executing in another thread: block on its completion
                      and share its result (or its exception — a joiner of
                      a round that raised ``QuorumUnavailable`` must not
                      pretend it succeeded).
      * note/push   – terminal results feed the index; the first terminal
                      record fires registered ``watch_decision`` watchers
                      from the noting thread (there is no network leg to
                      charge in threaded deployments).

    Also observes per-lane (partition) write latency for the adaptive
    timeout policy — the same ``write_lat_ewma`` / ``write_lat_dev`` /
    ``lane_write_latency`` surface the sim services expose.
    """

    def __init__(self, cfg: Optional[DecisionCacheConfig] = None) -> None:
        self.cfg = cfg or DecisionCacheConfig()
        self.index = DecisionIndex(self.cfg)
        self._lock = threading.RLock()
        self._inflight: Dict[Tuple[str, str, str], _Flight] = {}
        self._lat = EwmaStat()
        self._lane_lat: Dict[str, EwmaStat] = {}

    # -- counters (mirror the sim mixin's surface) -------------------------
    @property
    def decision_cache_hits(self) -> int:
        return self.index.hits

    @property
    def singleflight_hits(self) -> int:
        return self.index.singleflight_hits

    @property
    def decisions_pushed(self) -> int:
        return self.index.pushes

    # -- write-latency observation -----------------------------------------
    @property
    def write_lat_ewma(self) -> Optional[float]:
        return self._lat.ewma

    @property
    def write_lat_dev(self) -> float:
        return self._lat.dev

    def note_write_latency(self, ms: float,
                           lane: Optional[str] = None) -> None:
        with self._lock:
            self._lat.note(ms)
            if lane is not None:
                st = self._lane_lat.get(lane)
                if st is None:
                    st = self._lane_lat[lane] = EwmaStat()
                st.note(ms)

    def lane_write_latency(self, lane: str
                           ) -> Optional[Tuple[float, float]]:
        st = self._lane_lat.get(lane)
        if st is None or st.ewma is None:
            return None
        return st.ewma, st.dev

    # -- watcher API (decision push) ---------------------------------------
    def watch_decision(self, txn: str, cb: Callable[[Vote], None],
                       node: Optional[str] = None) -> None:
        """Run ``cb(value)`` when the txn's first terminal record lands
        (immediately if it already has).  ``node`` is accepted for API
        parity with the sim services; threaded deployments have no
        modelled push leg to charge."""
        with self._lock:
            self.index.watch(txn, cb)

    def note(self, partition: str, txn: str,
             value: Optional[Vote]) -> None:
        """Feed a terminal value observed outside ``log_once`` (a plain
        ``log`` of a decision record, a read) into the index."""
        with self._lock:
            self.index.note(partition, txn, value)

    # -- the wrapped operation ---------------------------------------------
    def log_once(self, perform: Callable[[], Vote], partition: str,
                 txn: str, state: Vote, writer: str = "") -> Vote:
        key = (partition, txn, state.value)
        lead = False
        with self._lock:
            hit = self.index.lookup(txn)
            if hit is not None:
                # LogOnce "returns the existing value": the txn's log set
                # already holds a terminal record, so this attempt can only
                # read the decision — answer it without a CAS round.
                self.index.hits += 1
                return hit
            flight = self._inflight.get(key) if self.cfg.singleflight \
                else None
            if flight is not None:
                self.index.singleflight_hits += 1
            else:
                flight = _Flight()
                lead = True
                if self.cfg.singleflight:
                    self._inflight[key] = flight
        if not lead:
            # Joiner: share the leader's round (result OR exception).
            flight.event.wait()
            if flight.error is not None:
                raise flight.error
            return flight.result
        t0 = time.monotonic()
        try:
            result = flight.result = perform()
        except BaseException as e:
            flight.error = e
            raise
        finally:
            self.note_write_latency((time.monotonic() - t0) * 1e3,
                                    lane=partition)
            with self._lock:
                if self._inflight.get(key) is flight:
                    del self._inflight[key]
            flight.event.set()
        self.note(partition, txn, result)
        return result


# --------------------------------------------------------------------------
# Leadership-lease upkeep for long-lived committers
# --------------------------------------------------------------------------
class LeaseKeeper:
    """Automatic acquisition/renewal of a store leadership lease.

    Long-lived committers (the checkpoint loop, wall-clock bench workers)
    used to manage ``acquire_lease`` by hand — or not at all, paying the
    full prepare+accept on every post-failover LogOnce.  A ``LeaseKeeper``
    wraps the policy once:

      * ``ensure()`` returns a lease valid for at least
        ``renew_margin × duration_s`` more seconds, acquiring or renewing
        (an epoch bump) as needed — and returns ``None`` when the store has
        no lease API, another holder's lease is still valid (stealing a
        live peer's epoch would thrash), or acquisition fails because a
        quorum is unreachable.  ``None`` means: use the full-prepare slow
        path; it NEVER raises out of a renewal attempt.
      * safety is the store's (ballot order on the replicas); the keeper
        only decides when to spend an acquisition round.
      * degradation is NOT silent: every ``ensure()`` that answers "slow
        path" on a lease-capable store bumps ``degradations``, and the
        fast↔slow transitions emit one log line each — so a bench (or an
        operator) can assert the fast path actually re-engaged after a
        failover or membership reconfiguration instead of quietly paying
        full prepare+accept forever.
    """

    def __init__(self, store, holder: str, duration_s: float = 5.0,
                 renew_margin: float = 0.25) -> None:
        self.store = store
        self.holder = holder
        self.duration_s = duration_s
        self.renew_margin = renew_margin
        self.supported = hasattr(store, "acquire_lease") \
            and hasattr(store, "current_lease")
        self.acquisitions = 0
        self.renewals = 0
        self.failures = 0
        self.degradations = 0          # ensure() calls answered "slow path"
        self.reengagements = 0         # slow→fast transitions
        self._degraded = False

    def _slow(self, why: str):
        """Record (and, on the transition, log) a slow-path answer."""
        self.degradations += 1
        if not self._degraded:
            self._degraded = True
            log.warning("LeaseKeeper[%s]: degraded to full-prepare "
                        "slow path (%s)", self.holder, why)
        return None

    def _fast(self, lease):
        if self._degraded:
            self._degraded = False
            self.reengagements += 1
            log.info("LeaseKeeper[%s]: lease fast path re-engaged "
                     "(epoch %d)", self.holder, lease.epoch)
        return lease

    @property
    def degraded(self) -> bool:
        """True while the last ``ensure()`` answered "slow path"."""
        return self._degraded

    def ensure(self):
        """-> valid ``StoreLease`` held by ``holder``, or None (slow path)."""
        if not self.supported:
            return None
        lease = self.store.current_lease()
        now = time.monotonic()
        if lease is not None:
            if lease.holder == self.holder:
                if lease.expires_at - now > self.renew_margin * \
                        self.duration_s:
                    return self._fast(lease)
            else:
                # A live peer holds the lease: dueling epoch bumps would
                # invalidate each other's fast path every round.  Let the
                # holder serve; we take the (safe) full-prepare path.
                return self._slow(f"peer {lease.holder!r} holds the lease")
        try:
            lease = self.store.acquire_lease(self.holder,
                                             duration_s=self.duration_s)
        except QuorumUnavailable as e:
            # Degrade, don't error: the committer falls back to the full
            # proposer, which is correct (just slower) lease or no lease.
            self.failures += 1
            return self._slow(f"acquisition failed: {e}")
        if self.acquisitions:
            self.renewals += 1
        self.acquisitions += 1
        return self._fast(lease)
