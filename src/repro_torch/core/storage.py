"""Disaggregated storage layer: Log() / LogOnce() over pluggable stores.

The port's copy of ``repro/core/storage.py`` without its simulated
services: the threaded stores, with the JAX package's on-disk layout.
``SimStorage``, ``ReplicatedSimStorage``, ``GroupCommitIngress`` with its
``BatchConfig``, and ``_Forward`` (the discrete-event services) are not
here.  The paper's only storage-layer requirement is *log-once* semantics
built on a compare-and-swap primitive (§3.2, §4):

  * ``MemoryStore``  – lock-protected dict; used by threaded tests (stands
    in for Azure Redis / Blob).
  * ``FileStore``    – directory-backed; ``open(O_CREAT|O_EXCL)`` is the CAS
    (create-if-absent ≙ Azure Blob "If-None-Match:*" conditional PUT).  Used
    by the training driver's Cornus checkpoint commit.
  * ``ReplicatedStore`` – majority-quorum Paxos over R ``ReplicaLog``s, with
    leases (the owner-ballot fast path), replica failure and recovery with
    state transfer, live membership change, GC and scrub passes.
  * ``DelayedMemoryStore`` / ``DelayedReplicatedStore`` – the same with an
    injected per-op service time (the wall-clock and serving harnesses).
  * ``BatchingStore`` – group-commit decorator over any threaded store.
  * ``LatencyModel`` – the paper's measured service times (§5.1.2);
    ``RegionTopology`` – the simulated services' RTT matrix, which the
    protocols' ``Transport`` names.

Every store exposes the same three operations on the *transaction-state* log:

  log_once(partition, txn, state) -> resulting state   (CAS; first write wins)
  log(partition, txn, state)      -> resulting state   (blind append; 2PC path)
  read_state(partition, txn)      -> state | None
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .control import (DecisionCacheConfig, QuorumUnavailable,
                      ThreadControlPlane)
from .lifecycle import (CorruptRecord, GcEntry, LifecycleConfig,
                        RECORD_MAGIC, decode_record, encode_record)
from .state import Vote


# --------------------------------------------------------------------------
# Latency models (paper §5.1.2 measurements, in milliseconds)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class LatencyModel:
    """Service-time model for one storage deployment."""

    name: str
    conditional_write_ms: float   # LogOnce() mean
    plain_write_ms: float         # Log() mean
    read_ms: float                # state read mean
    jitter: float = 0.05          # lognormal-ish multiplicative spread
    # Separate-ACL deployments (Azure Blob §4.2) need TWO sequential requests
    # for LogOnce-with-data: data PUT then conditional state PUT.
    separate_acl: bool = False
    # Service-time growth per extra record in a batched write (coordinator-log
    # variant §5.6 ships ALL participants' redo data in one request).
    batch_size_factor: float = 0.15

    def sample(self, rng: random.Random, mean_ms: float) -> float:
        # Deterministic multiplicative jitter; heavy-ish right tail like the
        # paper's P99 plots (Fig 5/6) without a full trace model.
        u = rng.random()
        tail = 1.0 + (3.0 * rng.random() if u > 0.97 else 0.0)
        return mean_ms * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)) * tail

    def batched_write_ms(self, n_records: int,
                         base_ms: Optional[float] = None) -> float:
        """Mean service time for ONE write carrying ``n_records`` records.

        The amortization model shared by the coordinator-log §5.6 batch
        write and the storage-ingress group-commit lanes: one base service
        time plus ``batch_size_factor`` payload growth per extra record.
        """
        base = self.plain_write_ms if base_ms is None else base_ms
        return base * (1.0 + self.batch_size_factor * max(0, n_records - 1))


AZURE_REDIS = LatencyModel("redis", conditional_write_ms=1.96,
                           plain_write_ms=1.84, read_ms=0.9)
AZURE_BLOB = LatencyModel("blob", conditional_write_ms=10.40,
                          plain_write_ms=10.29, read_ms=5.0)
# §5.1.4: separate ACLs for txn-state vs user data raise LogOnce from
# 10.40ms to 18.43ms (two sequential requests).
AZURE_BLOB_SEPARATE_ACL = LatencyModel(
    "blob-acl", conditional_write_ms=18.43, plain_write_ms=10.29,
    read_ms=5.0, separate_acl=True)
# §5.6 coordinator-log experiment measured ~443ms writes ("such high latency
# of writing to Redis" — a heavily loaded/cross-region instance).
SLOW_REDIS = LatencyModel("slow-redis", conditional_write_ms=443.0,
                          plain_write_ms=443.0, read_ms=221.0)

COMPUTE_RTT_MS = 0.5  # measured compute↔compute round trip (§5.1.2)


# --------------------------------------------------------------------------
# Region topology (extended version §6: geo-distributed deployments)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class RegionTopology:
    """Multi-region RTT matrix replacing the single scalar ``rtt_ms``.

    ``rtt_ms(a, b)`` is the full round trip between two regions: ``intra_ms``
    within a region, an explicit entry of ``links`` across regions (keyed by
    the sorted region pair), else ``default_cross_ms``.  Presets below model
    the three deployment shapes of the extended paper: intra-zone (the §5
    measurement setup), cross-zone, and cross-region (geo).
    """

    name: str
    regions: Tuple[str, ...]
    intra_ms: float = COMPUTE_RTT_MS
    links: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    default_cross_ms: float = 2.0

    def rtt_ms(self, a: str, b: str) -> float:
        if a == b:
            return self.intra_ms
        key = (a, b) if a <= b else (b, a)
        return self.links.get(key, self.default_cross_ms)

    @property
    def max_rtt_ms(self) -> float:
        worst = max(self.intra_ms, self.default_cross_ms)
        return max([worst] + list(self.links.values()))

    @classmethod
    def uniform(cls, name: str, regions: Sequence[str],
                rtt_ms: float) -> "RegionTopology":
        """Every pair (including intra-region) costs the same RTT — used to
        validate the simulator against the analytic Table-3 RTT counts."""
        return cls(name, tuple(regions), intra_ms=rtt_ms,
                   default_cross_ms=rtt_ms)

    def place_round_robin(self, nodes: Sequence[str]) -> Dict[str, str]:
        return {n: self.regions[i % len(self.regions)]
                for i, n in enumerate(nodes)}


INTRA_ZONE = RegionTopology("intra-zone", ("zone-a",))
CROSS_ZONE = RegionTopology("cross-zone", ("zone-a", "zone-b", "zone-c"),
                            default_cross_ms=2.0)
# Public-cloud-shaped inter-region RTTs (coordinator home region first).
CROSS_REGION = RegionTopology(
    "cross-region", ("us-east", "us-west", "eu-west"),
    links={("us-east", "us-west"): 62.0,
           ("eu-west", "us-east"): 76.0,
           ("eu-west", "us-west"): 140.0},
    default_cross_ms=100.0)


# --------------------------------------------------------------------------
# Stores
# --------------------------------------------------------------------------
class _ControlledStoreMixin:
    """Threaded-store side of the shared control plane.

    The JAX package's simulated services drive the decision index with sim
    Events; the blocking stores drive the SAME index through a
    ``ThreadControlPlane`` (real threads, one lock).  The mixin adds the
    identical observable surface — ``decision_cache_hits`` /
    ``singleflight_hits`` / ``decisions_pushed`` counters,
    ``watch_decision``, and the ``write_lat_ewma`` / ``lane_write_latency``
    stats adaptive timeout policies read — so protocol code and benches
    are backend-agnostic.  With no active ``DecisionCacheConfig`` (the
    default) the plane is absent and every operation is exactly the raw
    store op."""

    control: Optional[ThreadControlPlane]

    def _init_control(self,
                      decisions: Optional[DecisionCacheConfig]) -> None:
        self.control = (ThreadControlPlane(decisions)
                        if decisions is not None and decisions.active
                        else None)

    # -- counters (same names as the sim services) -------------------------
    @property
    def decision_cache_hits(self) -> int:
        return self.control.decision_cache_hits if self.control else 0

    @property
    def singleflight_hits(self) -> int:
        return self.control.singleflight_hits if self.control else 0

    @property
    def decisions_pushed(self) -> int:
        return self.control.decisions_pushed if self.control else 0

    @property
    def write_lat_ewma(self) -> Optional[float]:
        return self.control.write_lat_ewma if self.control else None

    @property
    def write_lat_dev(self) -> float:
        return self.control.write_lat_dev if self.control else 0.0

    def lane_write_latency(self, lane: str
                           ) -> Optional[Tuple[float, float]]:
        return self.control.lane_write_latency(lane) if self.control \
            else None

    def watch_decision(self, txn: str, cb: Callable[[Vote], None],
                       node: Optional[str] = None) -> None:
        if self.control is not None:
            self.control.watch_decision(txn, cb, node)

    # -- op wrappers -------------------------------------------------------
    def _controlled_log_once(self, perform: Callable[[], Vote],
                             partition: str, txn: str, state: Vote,
                             writer: str) -> Vote:
        if self.control is None:
            return perform()
        return self.control.log_once(perform, partition, txn, state, writer)

    def _note_control(self, partition: str, txn: str,
                      value: Optional[Vote]) -> None:
        """Feed decisions landing outside log_once (2PC's plain decision
        logs, recovery reads) into the index."""
        if self.control is not None:
            self.control.note(partition, txn, value)


class MemoryStore(_ControlledStoreMixin):
    """Thread-safe CAS store holding per-partition transaction-state logs.

    With a ``LifecycleConfig`` armed the store additionally keeps a
    CRC32-framed durable image per record (torn tails are treated as
    absent — the write was never acknowledged — and bit-rot is detected
    and repaired from a sibling slot of the same txn holding the terminal
    decision), a per-partition append order the GC low-watermark advances
    over, and a truncation journal (``gc_log``) the history checker audits
    (AC-GC).  ``lifecycle=None`` (the default) is bit-identical to the
    pre-lifecycle store.
    """

    def __init__(self,
                 decisions: Optional[DecisionCacheConfig] = None,
                 lifecycle: Optional[LifecycleConfig] = None) -> None:
        self._lock = threading.Lock()
        # (partition, txn) -> (state, writer)
        self._state: Dict[Tuple[str, str], Tuple[Vote, str]] = {}
        self._data_bytes: Dict[str, int] = {}
        self._payloads: Dict[Tuple[str, str], bytes] = {}
        self.cas_attempts = 0
        self.cas_losses = 0
        self.lifecycle = LifecycleConfig.coerce(lifecycle)
        # Durable image: key -> mutable CRC32-framed record bytes (the
        # chaos BitFlip/TornTail hooks mutate these; reads verify them).
        self._frames: Dict[Tuple[str, str], bytearray] = {}
        self._order: Dict[str, List[str]] = {}     # partition -> txns, append order
        self._order_seen: set = set()
        self.watermarks: Dict[str, int] = {}       # partition -> truncated prefix
        self.gc_log: List[GcEntry] = []
        self._gc_index: Dict[Tuple[str, str], GcEntry] = {}
        self.gc_truncations = 0
        self.torn_records = 0
        self.corrupt_records = 0
        self.scrub_repairs = 0
        self.quarantines = 0
        self._corrupt_streak = 0
        self._init_control(decisions)

    # -- lifecycle-aware record access (lock held) -------------------------
    def _put(self, key: Tuple[str, str], state: Vote, writer: str) -> None:
        self._state[key] = (state, writer)
        lc = self.lifecycle
        if lc is not None:
            if key not in self._order_seen:
                self._order_seen.add(key)
                self._order.setdefault(key[0], []).append(key[1])
            if lc.checksums:
                self._frames[key] = bytearray(
                    encode_record(state.value, writer))

    def _get(self, key: Tuple[str, str]):
        """-> (state, writer) | (CorruptRecord, "") | None, verifying the
        CRC frame when checksums are armed.  Torn frames (unacknowledged
        writes) are dropped as absent; bit-rot is repaired from a sibling
        slot of the same txn, or surfaced as a typed `CorruptRecord`."""
        cur = self._state.get(key)
        lc = self.lifecycle
        if cur is None:
            if lc is not None and lc.gc:
                # Truncated slot: the journal entry is the tombstone — it
                # carries the settled terminal decision, which is the only
                # answer a post-truncation reader can soundly be given.
                e = self._gc_index.get(key)
                if e is not None and e.decision is not None:
                    return (Vote(e.decision), "gc")
            return None
        if lc is None or not lc.checksums:
            return cur
        fr = self._frames.get(key)
        if fr is None:
            return cur
        rec = decode_record(bytes(fr), key[0], key[1])
        if isinstance(rec, CorruptRecord):
            if rec.torn:
                # Torn tail: the write died mid-flight and was never
                # acknowledged — absent-or-corrupt, safe to treat absent.
                self.torn_records += 1
                self._state.pop(key, None)
                self._frames.pop(key, None)
                return None
            self.corrupt_records += 1
            self._corrupt_streak += 1
            if self._corrupt_streak >= lc.quarantine_threshold:
                self.quarantines += 1
                self._corrupt_streak = 0
            repaired = self._sibling_repair(key)
            if repaired is not None:
                return repaired
            return (rec, "")     # typed CorruptRecord, never garbage bytes
        val, w = rec
        return (Vote(val), w)

    def _sibling_repair(self, key: Tuple[str, str]):
        """Bit-rot repair from intra-txn redundancy: another slot of the
        same txn holding a verified terminal decision, or the truncation
        journal's recorded decision.  Rewrites the frame in place."""
        partition, txn = key
        found: Optional[Vote] = None
        for (p2, t2), cur in self._state.items():
            if t2 != txn or (p2, t2) == key:
                continue
            fr = self._frames.get((p2, t2))
            if fr is not None and isinstance(
                    decode_record(bytes(fr)), CorruptRecord):
                continue       # the sibling is rotted too
            if isinstance(cur[0], Vote) and cur[0].is_decision():
                found = cur[0]
                break
        if found is None:
            for e in reversed(self.gc_log):
                if e.txn == txn and e.decision is not None:
                    found = Vote(e.decision)
                    break
        if found is None:
            return None
        self._put(key, found, "scrub")
        self.scrub_repairs += 1
        return (found, "scrub")

    def log_once(self, partition: str, txn: str, state: Vote,
                 writer: str = "") -> Vote:
        return self._controlled_log_once(
            lambda: self._log_once_direct(partition, txn, state, writer),
            partition, txn, state, writer)

    def _log_once_direct(self, partition: str, txn: str, state: Vote,
                         writer: str = "") -> Vote:
        with self._lock:
            self.cas_attempts += 1
            key = (partition, txn)
            cur = self._get(key)
            if cur is not None:
                if not isinstance(cur[0], CorruptRecord):
                    self.cas_losses += 1
                return cur[0]
            self._put(key, state, writer)
            return state

    def log(self, partition: str, txn: str, state: Vote,
            writer: str = "") -> Vote:
        with self._lock:
            # Blind append: last record wins, but a decision record never
            # regresses to a vote NOR flips to the other decision (a zombie
            # re-issue from a dead incarnation racing crash recovery must
            # not make the slot serve both terminal values — AC3).
            key = (partition, txn)
            cur = self._get(key)
            if (cur is not None and isinstance(cur[0], Vote)
                    and cur[0].is_decision() and state != cur[0]):
                result = cur[0]
            else:
                self._put(key, state, writer)
                result = state
        self._note_control(partition, txn, result)
        return result

    def read_state(self, partition: str, txn: str) -> Optional[Vote]:
        with self._lock:
            cur = self._get((partition, txn))
            return cur[0] if cur else None

    def writer_of(self, partition: str, txn: str) -> Optional[str]:
        with self._lock:
            cur = self._state.get((partition, txn))
            return cur[1] if cur else None

    # -- durable-state lifecycle -------------------------------------------
    def gc_pass(self, now: float = 0.0) -> int:
        """Advance each partition's low-watermark past SETTLED txns (some
        slot of the txn holds a terminal decision — durable here by
        presence, this store being its own single volume) and truncate the
        slots below it, journaling every removal.  The watermark only ever
        moves forward (monotonic CAS under the store lock) and never past
        the first unsettled txn, so an in-doubt transaction blocks GC of
        its partition rather than losing recoverability."""
        lc = self.lifecycle
        if lc is None or not lc.gc:
            return 0
        with self._lock:
            settled: Dict[str, Vote] = {}
            for (_p, t), cur in self._state.items():
                if isinstance(cur[0], Vote) and cur[0].is_decision():
                    settled.setdefault(t, cur[0])
            for e in self.gc_log:
                if e.decision is not None:
                    settled.setdefault(e.txn, Vote(e.decision))
            n = 0
            for partition, order in self._order.items():
                wm = self.watermarks.get(partition, 0)
                while wm < len(order):
                    txn = order[wm]
                    key = (partition, txn)
                    cur = self._state.get(key)
                    if cur is None:
                        wm += 1           # torn-dropped or already truncated
                        continue
                    dec = settled.get(txn)
                    if dec is None:
                        break             # unsettled txn: watermark stops
                    e = GcEntry(partition, txn,
                                getattr(cur[0], "value", None), dec.value,
                                True, at=now)
                    self.gc_log.append(e)
                    self._gc_index[key] = e
                    self._state.pop(key, None)
                    self._frames.pop(key, None)
                    wm += 1
                    n += 1
                if wm > self.watermarks.get(partition, 0):
                    self.watermarks[partition] = wm
            self.gc_truncations += n
            return n

    def scrub_pass(self) -> int:
        """Verify every retained frame (repairing rot, dropping torn
        tails); returns the number of repairs made."""
        lc = self.lifecycle
        if lc is None or not lc.checksums:
            return 0
        with self._lock:
            before = self.scrub_repairs
            for key in list(self._state.keys()):
                self._get(key)
            return self.scrub_repairs - before

    def bitflip(self, rng: random.Random) -> bool:
        """Chaos hook: flip one body byte of a REPAIRABLE durable record.
        Eligible slots belong to a txn with a second, intact terminal slot
        (rot with no redundant copy is unrecoverable by any protocol — the
        Nemesis models survivable media rot).  Header bytes are spared:
        this format cannot distinguish header rot from a torn create."""
        lc = self.lifecycle
        if lc is None or not lc.checksums:
            return False
        with self._lock:
            terminal: Dict[str, int] = {}
            for (_p, t), cur in self._state.items():
                if isinstance(cur[0], Vote) and cur[0].is_decision():
                    terminal[t] = terminal.get(t, 0) + 1
            cands = sorted(
                key for key in self._frames
                if key in self._state
                and terminal.get(key[1], 0)
                >= (2 if isinstance(self._state[key][0], Vote)
                    and self._state[key][0].is_decision() else 1))
            if not cands:
                return False
            key = cands[rng.randrange(len(cands))]
            fr = self._frames[key]
            body_start = bytes(fr).find(b"\n") + 1
            if body_start <= 0 or body_start >= len(fr):
                return False
            i = rng.randrange(body_start, len(fr))
            fr[i] ^= rng.randrange(1, 256)
            return True

    def tear_slot(self, key: Tuple[str, str]) -> bool:
        """Chaos hook: truncate the slot's frame mid-write (a torn tail).
        The next read detects the short body and treats the record as
        absent — sound only because the Nemesis pairs this with losing the
        write's response (the record was never acknowledged)."""
        lc = self.lifecycle
        if lc is None or not lc.checksums:
            return False
        with self._lock:
            fr = self._frames.get(key)
            if fr is None or len(fr) < 2:
                return False
            del fr[len(fr) - 2:]
            return True

    def partition_log(self, partition: str) -> List[Tuple[str, str]]:
        """Retained (post-watermark) slots of ``partition`` in append
        order — what a durable restart scan must replay.  With no
        lifecycle armed there is no order metadata; fall back to the
        state map, sorted for determinism."""
        with self._lock:
            order = self._order.get(partition)
            if order is not None:
                wm = self.watermarks.get(partition, 0)
                return [(partition, t) for t in order[wm:]
                        if (partition, t) in self._state]
            return sorted(k for k in self._state if k[0] == partition)

    def is_truncated(self, key: Tuple[str, str]) -> bool:
        return key in self._gc_index

    def watermark_lag(self) -> int:
        """Slots retained above the watermark, summed over partitions —
        how far truncation is behind the append frontier."""
        with self._lock:
            return sum(len(order) - self.watermarks.get(p, 0)
                       for p, order in self._order.items())

    def log_data(self, partition: str, nbytes: int) -> None:
        with self._lock:
            self._data_bytes[partition] = self._data_bytes.get(partition, 0) + nbytes

    # -- bulk payloads (same surface as FileStore's data/ prefix) ----------
    def put_data(self, partition: str, name: str, payload: bytes) -> None:
        with self._lock:
            self._payloads[(partition, name)] = bytes(payload)

    def get_data(self, partition: str, name: str) -> bytes:
        with self._lock:
            try:
                return self._payloads[(partition, name)]
            except KeyError:
                raise FileNotFoundError(f"no payload {partition}/{name}") \
                    from None

    def snapshot(self) -> Dict[Tuple[str, str], Vote]:
        with self._lock:
            return {k: v[0] for k, v in self._state.items()}


class FileStore(_ControlledStoreMixin):
    """Directory-backed store: O_CREAT|O_EXCL create-if-absent is the CAS.

    Layout:  <root>/state/<partition>/<txn>            (one small state file)
             <root>/data/<partition>/<name>            (bulk shard payloads)

    This is the deployment target for the checkpoint committer: the directory
    stands in for a blob container; partitions are per-host prefixes and the
    ACL separation of §4 maps to the state/ vs data/ prefixes.
    """

    def __init__(self, root: str,
                 decisions: Optional[DecisionCacheConfig] = None,
                 lifecycle: Optional[LifecycleConfig] = None) -> None:
        self.root = root
        os.makedirs(os.path.join(root, "state"), exist_ok=True)
        os.makedirs(os.path.join(root, "data"), exist_ok=True)
        self.lifecycle = LifecycleConfig.coerce(lifecycle)
        self.torn_records = 0
        self.corrupt_records = 0
        self.scrub_repairs = 0
        self.quarantines = 0
        self.gc_truncations = 0
        self._corrupt_streak = 0
        self._torn_lock = threading.Lock()
        self.watermarks: Dict[str, int] = {}
        self.gc_log: List[GcEntry] = []
        self._gc_index: Dict[Tuple[str, str], GcEntry] = {}
        # A crash between the tmp write and os.replace strands a
        # `.tmp.<pid>.<tid>` file; sweep them at open (they were never
        # visible at the final path, so unlinking loses nothing).
        self.orphans_swept = self._sweep_orphans()
        self._init_control(decisions)

    def _sweep_orphans(self) -> int:
        n = 0
        for sub in ("state", "data"):
            top = os.path.join(self.root, sub)
            for dirpath, _dirs, files in os.walk(top):
                for name in files:
                    if ".tmp." in name:
                        try:
                            os.unlink(os.path.join(dirpath, name))
                            n += 1
                        except FileNotFoundError:
                            pass
        return n

    def _state_path(self, partition: str, txn: str) -> str:
        d = os.path.join(self.root, "state", partition)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, txn)

    def _payload(self, state: Vote, writer: str) -> bytes:
        lc = self.lifecycle
        if lc is not None and lc.checksums:
            return encode_record(state.value, writer)
        return f"{state.value}\n{writer}\n".encode()

    def log_once(self, partition: str, txn: str, state: Vote,
                 writer: str = "") -> Vote:
        return self._controlled_log_once(
            lambda: self._log_once_direct(partition, txn, state, writer),
            partition, txn, state, writer)

    def _log_once_direct(self, partition: str, txn: str, state: Vote,
                         writer: str = ""):
        path = self._state_path(partition, txn)
        payload = self._payload(state, writer)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            existing = self._read(path, partition, txn)
            if existing is None:
                # The file exists but holds a torn (never-acknowledged)
                # create.  Complete the CAS in place under a local lock;
                # cross-*process* races on a torn create are out of scope
                # here (a production port would re-run O_EXCL after an
                # unlink-if-unchanged).
                with self._torn_lock:
                    existing = self._read(path, partition, txn)
                    if existing is None:
                        self._replace(path, payload)
                        return state
            return existing
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        return state

    def _replace(self, path: str, payload: bytes) -> None:
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic overwrite

    def log(self, partition: str, txn: str, state: Vote,
            writer: str = "") -> Vote:
        path = self._state_path(partition, txn)
        cur = self.read_state(partition, txn)
        if isinstance(cur, Vote) and cur.is_decision() and state != cur:
            # Decisions never regress to a vote nor flip to the other
            # decision (AC3 at the disk).
            return cur
        self._replace(path, self._payload(state, writer))
        self._note_control(partition, txn, state)
        return state

    def _read(self, path: str, partition: str = "", txn: str = ""):
        """-> Vote | CorruptRecord | None (torn/absent).  Never raises on
        damaged bytes: a zero-length or truncated file left by a torn
        create reads as None (the write was never acknowledged), and
        bit-rot of a full-length record surfaces as a typed
        `CorruptRecord` instead of a garbage Vote."""
        with open(path, "rb") as f:
            blob = f.read()
        if blob.startswith(RECORD_MAGIC):
            rec = decode_record(blob, partition, txn)
            if isinstance(rec, CorruptRecord):
                if rec.torn:
                    self.torn_records += 1
                    return None
                self.corrupt_records += 1
                self._corrupt_streak += 1
                lc = self.lifecycle
                if (lc is not None
                        and self._corrupt_streak >= lc.quarantine_threshold):
                    self.quarantines += 1
                    self._corrupt_streak = 0
                return rec
            return Vote(rec[0])
        lines = blob.decode(errors="replace").splitlines()
        if not lines or not lines[0]:
            self.torn_records += 1      # zero-length / truncated legacy file
            return None
        try:
            return Vote(lines[0])
        except ValueError:
            self.corrupt_records += 1
            return CorruptRecord(partition, txn, torn=False,
                                 detail=f"unparsable state {lines[0]!r}")

    def read_state(self, partition: str, txn: str) -> Optional[Vote]:
        path = self._state_path(partition, txn)
        try:
            result = self._read(path, partition, txn)
        except FileNotFoundError:
            result = None
        if result is None and self._gc_index:
            e = self._gc_index.get((partition, txn))
            if e is not None and e.decision is not None:
                return Vote(e.decision)   # truncation tombstone
        return result

    # -- durable-state lifecycle -------------------------------------------
    def _state_files(self):
        """Yield (partition, txn, path) for every retained state file."""
        top = os.path.join(self.root, "state")
        for part in sorted(os.listdir(top)):
            pdir = os.path.join(top, part)
            if not os.path.isdir(pdir):
                continue
            for name in sorted(os.listdir(pdir)):
                if ".tmp." in name or name == ".watermark":
                    continue
                yield part, name, os.path.join(pdir, name)

    def scrub(self) -> List[str]:
        """Verify every state file; unlink torn tails (unacknowledged
        writes) and return the paths of rotted records needing repair
        from a replica of the volume."""
        rotted: List[str] = []
        for part, txn, path in self._state_files():
            try:
                result = self._read(path, part, txn)
            except FileNotFoundError:
                continue
            if result is None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            elif isinstance(result, CorruptRecord):
                rotted.append(path)
        return rotted

    def gc_pass(self, now: float = 0.0) -> int:
        """Truncate state files of settled txns (some slot of the txn
        holds a terminal decision on this volume), journaling each
        removal.  Files carry no total append order, so truncation is
        settled-only rather than strict-prefix; the per-partition
        watermark counts truncated slots and is persisted beside them."""
        lc = self.lifecycle
        if lc is None or not lc.gc:
            return 0
        slots: Dict[Tuple[str, str], Tuple[str, Optional[Vote]]] = {}
        for part, txn, path in self._state_files():
            try:
                result = self._read(path, part, txn)
            except FileNotFoundError:
                continue
            slots[(part, txn)] = (
                path, result if isinstance(result, Vote) else None)
        settled: Dict[str, Vote] = {}
        for (_p, t), (_path, vote) in slots.items():
            if vote is not None and vote.is_decision():
                settled.setdefault(t, vote)
        for e in self.gc_log:
            if e.decision is not None:
                settled.setdefault(e.txn, Vote(e.decision))
        n = 0
        removed_by_part: Dict[str, int] = {}
        for (part, txn), (path, vote) in sorted(slots.items()):
            dec = settled.get(txn)
            if dec is None:
                continue
            e = GcEntry(part, txn, None if vote is None else vote.value,
                        dec.value, True, at=now)
            self.gc_log.append(e)
            self._gc_index[(part, txn)] = e
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            removed_by_part[part] = removed_by_part.get(part, 0) + 1
            n += 1
        for part, removed in removed_by_part.items():
            wm = self.watermarks.get(part, 0) + removed
            self.watermarks[part] = wm
            wpath = os.path.join(self.root, "state", part, ".watermark")
            self._replace(wpath, f"{wm}\n".encode())
        self.gc_truncations += n
        return n

    def watermark_lag(self) -> int:
        return sum(1 for _ in self._state_files())

    # Bulk payloads (checkpoint shards) ------------------------------------
    def data_path(self, partition: str, name: str) -> str:
        d = os.path.join(self.root, "data", partition)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def put_data(self, partition: str, name: str, payload: bytes) -> str:
        path = self.data_path(partition, name)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def get_data(self, partition: str, name: str) -> bytes:
        with open(self.data_path(partition, name), "rb") as f:
            return f.read()


# --------------------------------------------------------------------------
# Replicated storage: quorum LogOnce over R replica logs (extended §6)
# --------------------------------------------------------------------------
# The extended paper argues Cornus ports to replicated storage services where
# LogOnce becomes a quorum operation: "the first value accepted by a majority
# of replicas wins" (Paxos-Commit-style, Gray & Lamport).  We implement the
# slot register as single-decree Paxos per (partition, txn): ballots make the
# participant-vs-termination CAS race safe under any interleaving of replica
# failures, which plain first-write-wins replicas cannot guarantee (a 1-1
# split across a 2-of-3 quorum has no winner without a second round).
#
# Ballots are ``(epoch, round, proposer_id)`` tuples — Multi-Paxos style.
# The *epoch* is a leadership term: whoever holds the epoch's lease holds an
# implicit phase-1 promise at round 1 for ALL current and future slots of
# the partition, so every slot costs one accept round (the phase-1-free
# fast path).  Within an epoch, a per-slot proposer (a termination CAS, a
# fallback after a lost batch) prepares at round >= 2 and beats the
# leaseholder's round-1 ballot on that slot alone — first-writer-wins races
# resolve exactly as before.  A new leader acquires epoch e+1 with ONE bulk
# ``prepare_epoch`` round (promoting the per-partition epoch ballot on a
# quorum), which supersedes every epoch-e ballot.
#
# Epoch 1 is the *implicit* initial lease: the slot's partition owner when
# compute coordinates replication ("coloc", the paper's participant-
# coordinates-replication rows of Table 3), or the storage service's
# initial leader replica in leader mode.  Its holder skips phase 1 from the
# first op with no acquisition round — which is what keeps the no-failure
# timing bit-identical to the single-epoch implementation and reproduces
# Table 3's 2pc=5 / cornus=3 / 2pc-coloc=3 / cornus-coloc=2 RTT totals.
#
# Leases are time-bounded (sim clock / wall clock) but safety NEVER rests
# on lease timing: an expired or superseded leaseholder's round-1 accepts
# simply fail (the replicas promised a higher ballot) and the op falls back
# to the full prepare+accept proposer, preserving single-winner-per-slot.

Ballot = Tuple[int, int, int]
OWNER_BALLOT: Ballot = (1, 1, 0)

# ``QuorumUnavailable`` moved to ``control`` (the lease keeper catches it
# without importing this module); re-exported here unchanged.


class _Slot:
    """Per-(partition, txn) state on ONE replica."""

    __slots__ = ("promised", "acc_ballot", "acc_value", "decided",
                 "value", "gen", "writer", "corrupt")

    def __init__(self) -> None:
        self.promised: Ballot = OWNER_BALLOT   # implicit phase-1 for owner
        self.acc_ballot: Optional[Ballot] = None
        self.acc_value: Optional[Vote] = None
        self.decided = False
        self.value: Optional[Vote] = None      # visible log record
        self.gen = 0                           # owner-assigned LSN of `value`
        self.writer = ""
        # Bit-rot flag: the visible record failed its checksum.  Only the
        # VISIBLE value is hidden from readers; acceptor metadata
        # (promised/acc_value/decided) survives — corruption of the log
        # record must not let a conflicting accept past the decided-guard.
        self.corrupt = False


class ReplicaLog:
    """One storage replica: a Paxos acceptor plus a visible MemoryStore-like
    log.  The first value of a slot is fixed by consensus (log_once); later
    blind ``write``s overwrite it with sticky-decision semantics (the 2PC /
    decision-record path).  Thread-safe; liveness is tracked by the enclosing
    store, a failed replica simply stops being called (disk survives)."""

    def __init__(self, index: int) -> None:
        self.index = index
        self._lock = threading.Lock()
        self._slots: Dict[Tuple[str, str], _Slot] = {}
        self._data_bytes: Dict[str, int] = {}
        self._payloads: Dict[Tuple[str, str], bytes] = {}
        # Highest epoch ballot promised — covers every slot, current and
        # future, of every partition this replica hosts (the bulk phase-1
        # of Multi-Paxos leases).  Starts at OWNER_BALLOT: the implicit
        # epoch-1 lease of the natural owner.
        self.epoch_promised: Ballot = OWNER_BALLOT

    def _slot(self, key: Tuple[str, str]) -> _Slot:
        s = self._slots.get(key)
        if s is None:
            s = self._slots[key] = _Slot()
        return s

    # -- acceptor ----------------------------------------------------------
    def prepare(self, key, ballot: Ballot):
        """-> (ok, acc_ballot, acc_value, visible_value, gen, decided,
        promised) — ``promised`` is the effective promise (max of the
        slot's own ballot and the epoch ballot), so a rejected proposer
        learns the epoch to exceed instead of blindly bumping rounds."""
        with self._lock:
            s = self._slot(key)
            ok = ballot > max(s.promised, self.epoch_promised)
            if ok:
                s.promised = ballot
            vis = None if s.corrupt else s.value
            return (ok, s.acc_ballot, s.acc_value, vis, s.gen,
                    s.decided, max(s.promised, self.epoch_promised))

    def prepare_epoch(self, ballot: Ballot):
        """Bulk phase-1 for a leadership epoch: promote the epoch ballot
        covering all current and future slots in ONE request.

        -> (ok, promised, inflight) where ``inflight`` lists
        (key, acc_ballot, acc_value) for every undecided slot holding an
        accepted value — the Multi-Paxos recovery obligation the new
        leaseholder must complete (re-propose at its epoch ballot) before
        serving fresh values on those slots."""
        with self._lock:
            ok = ballot > self.epoch_promised
            if ok:
                self.epoch_promised = ballot
            inflight = [(key, s.acc_ballot, s.acc_value)
                        for key, s in self._slots.items()
                        if s.acc_value is not None and not s.decided]
            return (ok, self.epoch_promised, inflight)

    def accept(self, key, ballot: Ballot, value: Vote) -> bool:
        with self._lock:
            s = self._slot(key)
            if ballot < max(s.promised, self.epoch_promised):
                return False
            if s.acc_ballot == ballot and s.acc_value not in (None, value):
                return False   # same-ballot different-value: never diverge
            if s.decided:
                # Consensus already reached here: a different value can
                # only come from a round-1 accept that skipped this slot's
                # phase-1 history (a NEW epoch's leaseholder serving a
                # fresh caller value).  Reject it — the proposer falls
                # back, runs prepare, and adopts the chosen value.  The
                # learned value is authoritative (acc_value may briefly
                # hold a losing round-1 value until learn aligns it).
                chosen = s.value if s.value is not None else s.acc_value
                if chosen is not None and value != chosen:
                    return False
            s.promised = ballot
            s.acc_ballot, s.acc_value = ballot, value
            return True

    def learn(self, key, value: Vote, writer: str = "") -> None:
        """Decision reached at a quorum: pin the slot's first value."""
        with self._lock:
            s = self._slot(key)
            s.decided = True
            if s.gen == 0:
                s.value, s.gen, s.writer = value, 1, writer
            # Align the acceptor state with the chosen value: a competing
            # round-1 accept may have parked a LOSING value here at a
            # higher ballot (a post-failover leaseholder serving a raced
            # CAS on a replica that missed the decide); once the decision
            # is known, any future adoption must carry the chosen value.
            if s.acc_value is not None and s.acc_value != value:
                s.acc_value = value
            if s.corrupt:
                # Learning the chosen value rewrites the rotted record.
                s.value, s.gen = value, max(s.gen, 1)
                s.corrupt = False

    # -- visible log -------------------------------------------------------
    def write(self, key, value: Vote, gen: int, writer: str = "") -> Vote:
        """Blind overwrite at generation ``gen``; decisions never regress
        to a vote nor flip to the other decision (AC3 at the disk)."""
        with self._lock:
            s = self._slot(key)
            if (not s.corrupt and s.value is not None
                    and s.value.is_decision() and value != s.value):
                return s.value
            if gen > s.gen or s.corrupt:
                s.value, s.gen, s.writer = value, max(gen, s.gen), writer
                s.corrupt = False
            return s.value if s.value is not None else value

    def read(self, key):
        with self._lock:
            s = self._slots.get(key)
            if s is None or s.corrupt:
                return (None, 0, False)
            return (s.value, s.gen, s.decided)

    def repair(self, key, value: Vote, gen: int, decided: bool,
               writer: str = "") -> None:
        """Read-repair push: adopt a fresher-or-equal merged view."""
        with self._lock:
            s = self._slot(key)
            if decided:
                s.decided = True
            if (gen > s.gen or (s.value is None and value is not None)
                    or (s.corrupt and value is not None)):
                s.value, s.gen, s.writer = value, max(gen, 1), writer
                s.corrupt = False

    # -- durable-state lifecycle -------------------------------------------
    def truncate(self, key) -> bool:
        """GC: drop the slot entirely (its decision is journaled by the
        enclosing store's watermark pass before this is called)."""
        with self._lock:
            return self._slots.pop(key, None) is not None

    def corrupt_slot(self, key) -> bool:
        """Chaos hook: rot the slot's visible record (checksum failure on
        next read).  Acceptor metadata survives — see `_Slot.corrupt`."""
        with self._lock:
            s = self._slots.get(key)
            if s is None or s.value is None:
                return False
            s.corrupt = True
            return True

    def corrupt_keys(self):
        with self._lock:
            return [k for k, s in self._slots.items() if s.corrupt]

    def partition_digests(self) -> Dict[str, int]:
        """Per-partition CRC32 over the replica's visible slot contents —
        what the anti-entropy scrubber exchanges to find divergence
        cheaply.  A corrupt record digests as empty, so rot always shows
        up as a digest mismatch against an intact peer."""
        with self._lock:
            lines: Dict[str, List[str]] = {}
            for (p, t), s in sorted(self._slots.items()):
                v = "" if (s.corrupt or s.value is None) else s.value.value
                lines.setdefault(p, []).append(
                    f"{t}:{v}:{s.gen}:{int(s.decided)}:{int(s.corrupt)}")
            return {p: zlib.crc32("\n".join(ls).encode())
                    for p, ls in lines.items()}

    def log_data(self, partition: str, nbytes: int) -> None:
        with self._lock:
            self._data_bytes[partition] = \
                self._data_bytes.get(partition, 0) + nbytes

    # -- bulk payloads (checkpoint shards on this replica's volume) --------
    def put_data(self, partition: str, name: str, payload: bytes,
                 version: int = 1) -> None:
        with self._lock:
            key = (partition, name)
            cur = self._payloads.get(key)
            if cur is None or version >= cur[0]:
                self._payloads[key] = (version, bytes(payload))

    def get_data(self, partition: str, name: str
                 ) -> Optional[Tuple[int, bytes]]:
        """-> (version, payload) so quorum readers can pick the freshest
        copy (a recovered volume may hold a stale rewrite)."""
        with self._lock:
            return self._payloads.get((partition, name))

    def drop_data(self) -> None:
        """Model a lost volume: the replica's shard payloads are gone
        (state slots survive separately, like a lost data disk)."""
        with self._lock:
            self._payloads.clear()

    def keys(self):
        with self._lock:
            return list(self._slots.keys())

    def data_keys(self):
        with self._lock:
            return list(self._payloads.keys())


def merge_reads(reads: Sequence[Tuple[Optional[Vote], int, bool]]):
    """Merge per-replica (value, gen, decided) into one view.

    A decision record anywhere wins (decisions are unique and sticky);
    otherwise the freshest (max-gen) record; `decided` is OR-ed.
    """
    value, gen, decided = None, 0, False
    for v, g, d in reads:
        decided = decided or d
        if v is None:
            continue
        better = (value is None or g > gen
                  or (v.is_decision() and not value.is_decision()))
        if value is not None and value.is_decision() and not v.is_decision():
            better = False
        if better:
            value, gen = v, g
    return value, gen, decided


@dataclass
class StoreLease:
    """One leadership epoch over a ``ReplicatedStore``/``ReplicatedSimStorage``.

    Holding a valid lease grants the phase-1-free fast path (round-1
    accepts at ``ballot``) for EVERY slot; validity is advisory only —
    expiry or preemption by a higher epoch costs round trips, never
    safety, because replicas enforce the ballot order regardless."""

    epoch: int
    holder: str                  # writer id (threaded) / replica idx (sim)
    ballot: Ballot
    expires_at: float            # time.monotonic() (threaded) / sim.now

    def valid_at(self, now: float) -> bool:
        return now < self.expires_at


@dataclass(frozen=True)
class MembershipConfig:
    """One quorum-membership configuration of a replicated store.

    Membership is a first-class, versioned object (Marlin-style): a config
    change is an epoch bump whose bulk ``prepare_epoch`` carries the new
    replica set, installed with a CAS on ``config_id`` — two concurrent
    reconfigurations cannot both win.  ``replica_ids`` index into the
    store's replica table; retired ids are never reused, so a removed
    replica's volume can hold arbitrarily stale state without ever being
    consulted (or counted toward a quorum) again.
    """

    config_id: int
    replica_ids: Tuple[int, ...]

    def __post_init__(self) -> None:
        ids = tuple(sorted(set(self.replica_ids)))
        if not ids:
            raise ValueError("membership needs at least one replica")
        object.__setattr__(self, "replica_ids", ids)

    @property
    def n(self) -> int:
        return len(self.replica_ids)

    @property
    def quorum(self) -> int:
        return self.n // 2 + 1

    def quorum_of(self, ids) -> bool:
        """True when ``ids`` contains a majority of THIS config."""
        members = set(self.replica_ids)
        return sum(1 for i in ids if i in members) >= self.quorum


# Bulk state-transfer streaming model (sim): a joiner pulls its catch-up
# image as TRANSFER_STREAMS parallel chunk streams of TRANSFER_CHUNK
# records each — wall time is one RTT plus ceil(n / (chunk*streams))
# chunk-batched service times, NOT one log write per record.
TRANSFER_CHUNK = 256
TRANSFER_STREAMS = 8


class ReplicatedStore(_ControlledStoreMixin):
    """Majority-quorum store over R ``ReplicaLog``s (threaded deployments).

    Same three-operation surface as ``MemoryStore``; ``log_once`` runs the
    Paxos proposer synchronously against the alive replicas, ``log`` is a
    quorum overwrite with owner-assigned generations, ``read_state`` is a
    quorum read with lazy repair of stale replicas.  ``fail_replica`` /
    ``recover_replica`` model per-replica outages; state survives an outage
    (crash, not amnesia), recovered replicas catch up via read repair.

    ``acquire_lease(holder)`` promotes a fresh epoch ballot on a quorum in
    one bulk prepare round (wall-clock bounded); while the lease is valid,
    every ``log_once`` issued with ``writer == holder`` skips phase 1 even
    for slots the writer does not own.  ``put_data``/``get_data`` replicate
    bulk shard payloads to every alive replica volume, so the checkpoint
    committer survives the loss of any minority of volumes.

    Membership is elastic: ``reconfigure`` (and the ``add_replica`` /
    ``remove_replica`` / ``set_replication`` conveniences) installs a new
    ``MembershipConfig`` as an epoch bump — joiners first catch up via
    recovery-driven state transfer (bulk slot + versioned ``put_data``
    copy), then one bulk ``prepare_epoch`` carrying the new membership is
    promised by a majority of the old AND the new config (joint quorum),
    in-flight slots are completed under it, and the lease hands over to
    the prior holder so the fast path survives the change.
    """

    def __init__(self, n_replicas: int = 3, seed: int = 0,
                 max_rounds: int = 256,
                 decisions: Optional[DecisionCacheConfig] = None,
                 membership: Optional[Sequence[int]] = None,
                 lifecycle: Optional[LifecycleConfig] = None) -> None:
        assert n_replicas >= 1
        ids = (tuple(membership) if membership is not None
               else tuple(range(n_replicas)))
        self._membership = MembershipConfig(1, ids)
        table = max(self._membership.replica_ids) + 1
        self.replicas = [ReplicaLog(i) for i in range(table)]
        self._alive = [True] * table
        self._gens: Dict[Tuple[str, str], int] = {}
        self._glock = threading.Lock()
        self._pids = itertools.count(1)
        self._rng = random.Random(seed)
        self.max_rounds = max_rounds
        self.cas_attempts = 0
        self.cas_losses = 0
        self._lease: Optional[StoreLease] = None
        self.lease_acquisitions = 0
        self.fast_path_ops = 0
        self.fallback_ops = 0
        # Slots whose in-flight value could NOT be re-proposed at quorum
        # during lease acquisition: the fast path must avoid them (a
        # round-1 accept there could contradict a possibly-chosen value);
        # the full proposer adopts the accepted value correctly.
        self._pinned: set = set()
        # Reconfiguration bookkeeping: one change at a time (the lock), a
        # full config history, and counters the benches surface.
        self._reconfig_lock = threading.RLock()
        self.membership_history: List[MembershipConfig] = [self._membership]
        self.reconfigurations = 0
        self.state_transfers = 0
        # Durable-state lifecycle (GC watermark + anti-entropy scrub).
        self.lifecycle = LifecycleConfig.coerce(lifecycle)
        self._order: Dict[str, List[str]] = {}
        self._order_seen: set = set()
        self.watermarks: Dict[str, int] = {}
        self.gc_log: List[GcEntry] = []
        self._gc_index: Dict[Tuple[str, str], GcEntry] = {}
        self.gc_truncations = 0
        self.scrub_repairs = 0
        self.quarantines = 0
        self.corrupt_records = 0
        self._init_control(decisions)

    @property
    def membership(self) -> MembershipConfig:
        return self._membership

    @property
    def n(self) -> int:
        return self._membership.n

    @property
    def quorum(self) -> int:
        return self._membership.quorum

    # -- replica liveness --------------------------------------------------
    def fail_replica(self, i: int) -> None:
        self._alive[i] = False

    def recover_replica(self, i: int) -> None:
        self._alive[i] = True

    def alive_replicas(self) -> List[ReplicaLog]:
        m = self._membership
        return [self.replicas[i] for i in m.replica_ids if self._alive[i]]

    def alive_ids(self) -> List[int]:
        m = self._membership
        return [i for i in m.replica_ids if self._alive[i]]

    def member_replicas(self) -> List[ReplicaLog]:
        """Every member's replica log, down ones included (crash, not
        amnesia — the disk survives an outage)."""
        return [self.replicas[i] for i in self._membership.replica_ids]

    # -- quorum read -------------------------------------------------------
    def _read_merge(self, key):
        if self._gc_index:
            e = self._gc_index.get(key)
            if e is not None and e.decision is not None:
                # Truncated slot: the journal entry is the tombstone.  Any
                # replica still holding the slot (e.g. it was down during
                # the truncation pass) is lazily truncated here.
                for r in self.member_replicas():
                    r.truncate(key)
                return (Vote(e.decision), 1, True,
                        len(self.alive_replicas()))
        alive = self.alive_replicas()
        reads = [(r, r.read(key)) for r in alive]
        value, gen, decided = merge_reads([rd for _, rd in reads])
        if value is not None or decided:
            for r, (v, g, d) in reads:       # stale-replica read repair
                if g < gen or (decided and not d):
                    r.repair(key, value, gen, decided)
        return value, gen, decided, len(alive)

    # -- leadership leases (epoch ballots, wall-clock bounded) -------------
    def current_lease(self) -> Optional[StoreLease]:
        lease = self._lease
        if lease is not None and lease.valid_at(time.monotonic()):
            return lease
        return None

    def acquire_lease(self, holder: str,
                      duration_s: float = 5.0) -> StoreLease:
        """One bulk prepare round: promote a fresh epoch ballot on a quorum
        (covering all current and future slots) and complete any in-flight
        undecided slots at it — then ``holder`` serves every slot with
        round-1 accepts until the lease expires or is superseded."""
        with self._glock:
            epoch = self._lease.epoch if self._lease is not None else 1
        for attempt in range(self.max_rounds):
            alive = self.alive_replicas()
            if len(alive) < self.quorum:
                raise QuorumUnavailable("majority down during lease acquire")
            epoch += 1
            ballot: Ballot = (epoch, 1, next(self._pids))
            oks = 0
            inflight: Dict[Tuple[str, str], Tuple[Ballot, Vote]] = {}
            for r in alive:
                ok, promised, acc = r.prepare_epoch(ballot)
                if ok:
                    oks += 1
                    for key, ab, av in acc:
                        cur = inflight.get(key)
                        if cur is None or ab > cur[0]:
                            inflight[key] = (ab, av)
                else:
                    epoch = max(epoch, promised[0])
            if oks < self.quorum:
                time.sleep(self._rng.random() * 1e-4 * (attempt + 1))
                continue
            # Multi-Paxos recovery: re-propose in-flight values at the new
            # epoch ballot so later round-1 accepts can never contradict a
            # value the previous epoch may already have chosen.  A slot
            # whose re-propose misses quorum stays PINNED: the lease is
            # still useful for every other slot, but fast-path serving of
            # a pinned slot could overwrite the unrecovered value.
            for key, (_ab, av) in sorted(inflight.items()):
                acks = [r for r in self.alive_replicas()
                        if r.accept(key, ballot, av)]
                if len(acks) >= self.quorum:
                    for r in self.alive_replicas():
                        r.learn(key, av)
                    self._pinned.discard(key)
                else:
                    self._pinned.add(key)
            lease = StoreLease(epoch, holder, ballot,
                               time.monotonic() + duration_s)
            with self._glock:
                # Install-if-newer: a concurrent acquirer whose ballot
                # already superseded ours on the replicas must not be
                # overwritten by our stale (and unusable) lease.
                cur = self._lease
                installed = cur is None or ballot > cur.ballot
                if installed:
                    self._lease = lease
                else:
                    epoch = max(epoch, cur.epoch)
            if not installed:
                # Lost the install race: retry above the winner so the
                # caller really ends up holding the lease it asked for.
                time.sleep(self._rng.random() * 1e-4 * (attempt + 1))
                continue
            self.lease_acquisitions += 1
            return lease
        raise QuorumUnavailable(
            f"no lease after {self.max_rounds} rounds")

    # -- elastic membership (versioned, CAS-installed config changes) ------
    def _state_transfer(self, i: int, donors_ids: Sequence[int]) -> int:
        """Recovery-driven catch-up: bulk-copy the donors' merged slot
        state and their freshest payload versions onto replica ``i`` —
        a full image push with versioned cutover, not lazy read repair.
        Returns the number of records moved."""
        donors = [self.replicas[j] for j in donors_ids
                  if self._alive[j] and j != i]
        target = self.replicas[i]
        moved = 0
        keys = set()
        for d in donors:
            keys.update(d.keys())
        for k in keys:
            if k in self._gc_index:
                continue    # truncated: the journal entry is authoritative
            v, g, dec = merge_reads([d.read(k) for d in donors])
            if v is not None or dec:
                target.repair(k, v, g, dec)
                moved += 1
        if self._gc_index:
            # Anti-resurrection sweep: a rejoiner must not re-serve slots
            # the watermark already truncated cluster-wide.
            for k in target.keys():
                if k in self._gc_index:
                    target.truncate(k)
        pkeys = set()
        for d in donors:
            pkeys.update(d.data_keys())
        for (partition, name) in pkeys:
            best: Optional[Tuple[int, bytes]] = None
            for d in donors:
                got = d.get_data(partition, name)
                if got is not None and (best is None or got[0] > best[0]):
                    best = got
            if best is not None:
                # put_data keeps the max version, so a racing rewrite with
                # a higher version is never clobbered (versioned cutover).
                target.put_data(partition, name, best[1], version=best[0])
                moved += 1
        self.state_transfers += 1
        return moved

    def revive_replica(self, i: int) -> int:
        """Bring a crashed member back AND restore its volume through the
        same recovery-driven state transfer a joiner gets.  Plain
        ``recover_replica`` models a crash (disk intact, lazy read repair
        fills gaps); revive models a replacement volume that must not
        serve stale state before it caught up."""
        self._alive[i] = True
        return self._state_transfer(i, self._membership.replica_ids)

    def reconfigure(self, new_ids: Sequence[int], holder: str = "",
                    duration_s: float = 5.0) -> MembershipConfig:
        """Install a new membership as an epoch bump.

        Sequence: grow the replica table for joiners → state-transfer the
        old config's image onto each joiner → one bulk ``prepare_epoch``
        promised by a majority of the old AND new config (the epoch bump
        that carries the new membership) → complete in-flight undecided
        slots under it → CAS-install the ``MembershipConfig`` (config_id
        + 1) and hand the lease to ``holder`` (default: the prior valid
        leaseholder) so the fast path survives the change.

        Safety: any two old-config majorities intersect, so a proposer
        still running on a pre-bump ballot meets a promoted replica and
        falls back; retired replicas are no longer read, repaired, or
        counted toward any quorum, so their stale writes can never be
        chosen under the new config.
        """
        with self._reconfig_lock:
            old = self._membership
            new = MembershipConfig(old.config_id + 1, tuple(new_ids))
            if new.replica_ids == old.replica_ids:
                return old
            with self._glock:
                for i in new.replica_ids:
                    while len(self.replicas) <= i:
                        self.replicas.append(ReplicaLog(len(self.replicas)))
                        self._alive.append(True)
            joiners = [i for i in new.replica_ids
                       if i not in old.replica_ids]
            for i in joiners:
                self._state_transfer(i, old.replica_ids)
            if not holder:
                lease = self.current_lease()
                holder = lease.holder if lease is not None else "reconfig"
            lease = self._joint_epoch_bump(old, new, holder, duration_s)
            # Delta pass: slots decided between the image copy and the
            # bump reached only old members; close the gap before the
            # joiners start counting toward read quorums.
            for i in joiners:
                self._state_transfer(i, old.replica_ids)
            with self._glock:
                if self._membership.config_id != old.config_id:
                    # CAS failed: somebody else installed concurrently
                    # (cannot happen under _reconfig_lock; kept as the
                    # invariant the install is defined by).
                    raise QuorumUnavailable("membership CAS lost")
                self._membership = new
                self.membership_history.append(new)
                cur = self._lease
                if cur is None or lease.ballot > cur.ballot:
                    self._lease = lease     # lease handover across configs
            self.reconfigurations += 1
            return new

    def _joint_epoch_bump(self, old: MembershipConfig,
                          new: MembershipConfig, holder: str,
                          duration_s: float) -> StoreLease:
        """One bulk prepare over the union of both configs, requiring a
        majority of EACH; in-flight undecided slots are re-proposed at the
        new ballot in both quorums (the Multi-Paxos recovery obligation,
        joint so neither config can contradict the completion)."""
        union_ids = sorted(set(old.replica_ids) | set(new.replica_ids))
        with self._glock:
            epoch = self._lease.epoch if self._lease is not None else 1
        for attempt in range(self.max_rounds):
            alive = [i for i in union_ids if self._alive[i]]
            if not (old.quorum_of(alive) and new.quorum_of(alive)):
                raise QuorumUnavailable(
                    "joint quorum unreachable for reconfiguration")
            epoch += 1
            ballot: Ballot = (epoch, 1, next(self._pids))
            ok_ids: List[int] = []
            inflight: Dict[Tuple[str, str], Tuple[Ballot, Vote]] = {}
            for i in alive:
                ok, promised, acc = self.replicas[i].prepare_epoch(ballot)
                if ok:
                    ok_ids.append(i)
                    for key, ab, av in acc:
                        cur = inflight.get(key)
                        if cur is None or ab > cur[0]:
                            inflight[key] = (ab, av)
                else:
                    epoch = max(epoch, promised[0])
            if not (old.quorum_of(ok_ids) and new.quorum_of(ok_ids)):
                time.sleep(self._rng.random() * 1e-4 * (attempt + 1))
                continue
            for key, (_ab, av) in sorted(inflight.items()):
                acks = [i for i in union_ids
                        if self._alive[i]
                        and self.replicas[i].accept(key, ballot, av)]
                if old.quorum_of(acks) and new.quorum_of(acks):
                    for i in union_ids:
                        if self._alive[i]:
                            self.replicas[i].learn(key, av)
                    self._pinned.discard(key)
                else:
                    self._pinned.add(key)
            self.lease_acquisitions += 1
            return StoreLease(epoch, holder, ballot,
                              time.monotonic() + duration_s)
        raise QuorumUnavailable(
            f"no joint epoch bump after {self.max_rounds} rounds")

    def add_replica(self, holder: str = "") -> int:
        """Grow the quorum by one fresh replica (never a retired id);
        returns the new replica's index."""
        with self._reconfig_lock:
            new_id = len(self.replicas)
            self.reconfigure(self._membership.replica_ids + (new_id,),
                             holder=holder)
            return new_id

    def remove_replica(self, i: int, holder: str = "") -> MembershipConfig:
        """Retire member ``i``: its volume stays on disk but it leaves the
        replica set permanently (retired ids are never reused)."""
        with self._reconfig_lock:
            ids = tuple(j for j in self._membership.replica_ids if j != i)
            if len(ids) == self._membership.n:
                raise ValueError(f"replica {i} is not a member")
            return self.reconfigure(ids, holder=holder)

    def set_replication(self, n: int, holder: str = "") -> MembershipConfig:
        """Scale the replica set to ``n``: grows with fresh replicas,
        shrinks from the highest member ids (never the leader-colocated
        lowest member)."""
        assert n >= 1
        with self._reconfig_lock:
            ids = list(self._membership.replica_ids)
            if len(ids) > n:
                ids = ids[:n]
            nxt = len(self.replicas)
            while len(ids) < n:
                ids.append(nxt)
                nxt += 1
            return self.reconfigure(tuple(ids), holder=holder)

    # -- operations --------------------------------------------------------
    def log_once(self, partition: str, txn: str, state: Vote,
                 writer: str = "") -> Vote:
        # The control plane wraps the WHOLE quorum operation: a cache hit
        # answers without any replica round, a singleflight joiner shares
        # the leader's round (including a QuorumUnavailable, if it raised).
        result = self._controlled_log_once(
            lambda: self._log_once_quorum(partition, txn, state, writer),
            partition, txn, state, writer)
        return result

    def _track(self, key: Tuple[str, str]) -> None:
        """Record first-write append order per partition — what the GC
        low-watermark advances over."""
        if self.lifecycle is None:
            return
        with self._glock:
            if key not in self._order_seen:
                self._order_seen.add(key)
                self._order.setdefault(key[0], []).append(key[1])

    def _log_once_quorum(self, partition: str, txn: str, state: Vote,
                         writer: str = "") -> Vote:
        key = (partition, txn)
        self._track(key)
        self.cas_attempts += 1
        value, _, decided, n_alive = self._read_merge(key)
        if n_alive < self.quorum:
            raise QuorumUnavailable(f"{n_alive}/{self.n} replicas alive")
        if value is not None and (decided or value.is_decision()):
            if value != state:
                self.cas_losses += 1
            return value
        lease = self.current_lease()
        use_lease = lease is not None and lease.holder == writer
        fast_ballot = lease.ballot if use_lease else OWNER_BALLOT
        # The partition owner's implicit fast path only exists in the
        # epoch-1 world: once ANY lease was acquired, every replica's
        # epoch promise permanently exceeds OWNER_BALLOT and a round-1
        # attempt at it is a guaranteed-dead quorum round.
        owner = (use_lease or (writer == partition
                               and self._lease is None)) \
            and key not in self._pinned
        first = self._propose(key, state, owner=owner,
                              fast_ballot=fast_ballot)
        # A concurrent gc_pass may have truncated the slot mid-propose
        # (emptying the decided-guard our accept raced against): the
        # journaled decision is authoritative, never the raced result.
        e = self._gc_index.get(key) if self._gc_index else None
        if e is not None and e.decision is not None:
            first = Vote(e.decision)
        if first != state:
            self.cas_losses += 1
            return first
        # The decided first value may already have been overwritten by a
        # decision record (can't happen before we return in the protocols,
        # but a quorum read keeps the API honest).
        value, _, _, _ = self._read_merge(key)
        return value if value is not None else first

    def _propose(self, key, my_value: Vote, owner: bool,
                 fast_ballot: Ballot = OWNER_BALLOT) -> Vote:
        pid = None
        # Seed the fallback epoch from the store's newest lease too — a
        # non-leaseholder starting at epoch 1 after an acquisition would
        # burn a guaranteed-rejected prepare round just to learn it.
        lease = self._lease
        epoch = max(fast_ballot[0],
                    lease.epoch if lease is not None else 1)
        fell_back = False
        for attempt in range(self.max_rounds):
            alive = self.alive_replicas()
            if len(alive) < self.quorum:
                raise QuorumUnavailable("majority down during propose")
            adopted = my_value
            if owner and attempt == 0:
                ballot = fast_ballot           # implicit phase 1
                voters = alive
            else:
                if not fell_back:
                    fell_back = True
                    self.fallback_ops += 1
                if pid is None:
                    pid = next(self._pids)
                ballot = (epoch, attempt + 2, pid)
                voters, best, seen = [], None, None
                for r in alive:
                    ok, ab, av, vis, gen, decided, promised = \
                        r.prepare(key, ballot)
                    if vis is not None and decided:
                        self._pinned.discard(key)
                        for rr in self.alive_replicas():
                            rr.learn(key, vis)   # converge stragglers
                        return vis             # already chosen and visible
                    if ok:
                        voters.append(r)
                    elif promised[0] > epoch:
                        epoch = promised[0]    # jump stale epochs, not rounds
                    if av is not None and (best is None or ab > best[0]):
                        best = (ab, av)
                    if vis is not None and seen is None:
                        seen = vis
                if len(voters) < self.quorum:
                    time.sleep(self._rng.random() * 1e-4 * (attempt + 1))
                    continue
                adopted = best[1] if best else (seen or my_value)
            acks = sum(1 for r in voters if r.accept(key, ballot, adopted))
            if acks >= self.quorum:
                if owner and attempt == 0:
                    self.fast_path_ops += 1
                else:
                    self._pinned.discard(key)   # settled by a full round
                for r in self.alive_replicas():
                    r.learn(key, adopted)
                return adopted
            time.sleep(self._rng.random() * 1e-4 * (attempt + 1))
        raise QuorumUnavailable(f"no decision after {self.max_rounds} rounds")

    def log(self, partition: str, txn: str, state: Vote,
            writer: str = "") -> Vote:
        key = (partition, txn)
        self._track(key)
        cur, gen, decided, n_alive = self._read_merge(key)
        if n_alive < self.quorum:
            raise QuorumUnavailable(f"{n_alive}/{self.n} replicas alive")
        if cur is not None and cur.is_decision() and state != cur:
            # Decisions never regress to a vote nor flip to the other
            # decision (AC3 at the disk).
            return cur
        with self._glock:
            g = self._gens[key] = max(self._gens.get(key, 0), gen) + 1
        results = [r.write(key, state, g, writer)
                   for r in self.alive_replicas()]
        if len(results) < self.quorum:
            raise QuorumUnavailable("majority down during log")
        e = self._gc_index.get(key) if self._gc_index else None
        if e is not None and e.decision is not None:
            # Raced a concurrent truncation: the journal is authoritative.
            return Vote(e.decision)
        self._note_control(partition, txn, state)
        return state

    def read_state(self, partition: str, txn: str) -> Optional[Vote]:
        value, _, _, n_alive = self._read_merge((partition, txn))
        if n_alive < self.quorum:
            raise QuorumUnavailable(f"{n_alive}/{self.n} replicas alive")
        return value

    def log_data(self, partition: str, nbytes: int) -> None:
        for r in self.alive_replicas():
            r.log_data(partition, nbytes)

    # -- bulk payloads (checkpoint shards, replicated R ways) --------------
    def put_data(self, partition: str, name: str, payload: bytes) -> None:
        alive = self.alive_replicas()
        if len(alive) < self.quorum:
            raise QuorumUnavailable(
                f"{len(alive)}/{self.n} replicas alive for put_data")
        with self._glock:
            # Version each rewrite so readers can spot a stale copy on a
            # replica that was down during the rewrite (crash, not
            # amnesia: its old payload survives recovery).
            key = ("data", partition, name)
            ver = self._gens[key] = self._gens.get(key, 0) + 1
        for r in alive:
            r.put_data(partition, name, payload, version=ver)

    def get_data(self, partition: str, name: str) -> bytes:
        best: Optional[Tuple[int, bytes]] = None
        for r in self.alive_replicas():
            got = r.get_data(partition, name)
            if got is not None and (best is None or got[0] > best[0]):
                best = got
        if best is not None:
            return best[1]
        # Same error surface as FileStore.get_data on a missing shard.
        raise FileNotFoundError(f"no alive replica holds "
                                f"{partition}/{name}")

    def snapshot(self) -> Dict[Tuple[str, str], Vote]:
        """Merged view over every MEMBER replica's disk — ground truth for
        tests and recovery tooling.  Deliberately includes down members
        (crash, not amnesia): a quorum-committed record must show up even
        while the replicas that hold it are offline.  Retired (removed)
        replicas are excluded — their stale writes can never be chosen."""
        members = self.member_replicas()
        keys = set()
        for r in members:
            keys.update(r.keys())
        out = {}
        for k in keys:
            if k in self._gc_index:
                continue      # truncated slots live in the journal
            v, _, _ = merge_reads([r.read(k) for r in members])
            if v is not None:
                out[k] = v
        return out

    # -- durable-state lifecycle -------------------------------------------
    def gc_pass(self, now: float = 0.0) -> int:
        """Advance each partition's low-watermark past txns whose terminal
        decision is durable on a QUORUM of members (down members count
        their disks — crash, not amnesia) and truncate the slots below it,
        journaling each removal.  Strict prefix order per partition: an
        in-doubt txn blocks GC behind it."""
        lc = self.lifecycle
        if lc is None or not lc.gc:
            return 0
        with self._reconfig_lock:
            members = self.member_replicas()
            # Durability census: (key, vote) -> copies on member disks.  A
            # terminal value on >= quorum disks IS quorum-durable whether
            # it got there via Paxos learn (decided=True) or a generation
            # write (``log``-path decisions never set the consensus flag).
            counts: Dict[Tuple[Tuple[str, str], str], int] = {}
            seen_keys = set()
            for r in members:
                seen_keys.update(r.keys())
            for k in seen_keys:
                if k in self._gc_index:
                    # Resurrected garbage from an op that raced an earlier
                    # truncation: re-truncate, keep it out of the census.
                    for r in members:
                        r.truncate(k)
                    continue
                for r in members:
                    v, _g, _d = r.read(k)
                    if v is not None and v.is_decision():
                        ck = (k, v.value)
                        counts[ck] = counts.get(ck, 0) + 1
            settled: Dict[str, Vote] = {}
            for e in self.gc_log:
                if e.decision is not None:
                    settled.setdefault(e.txn, Vote(e.decision))
            for (k, val), n_copies in counts.items():
                if n_copies >= self.quorum:
                    settled.setdefault(k[1], Vote(val))
            n = 0
            with self._glock:
                order_items = [(p, list(ts)) for p, ts in self._order.items()]
            for partition, order in order_items:
                wm = self.watermarks.get(partition, 0)
                while wm < len(order):
                    txn = order[wm]
                    key = (partition, txn)
                    if key in self._gc_index:
                        wm += 1
                        continue
                    dec = settled.get(txn)
                    if dec is None:
                        break
                    v, _g, _d = merge_reads([r.read(key) for r in members])
                    e = GcEntry(partition, txn,
                                None if v is None else v.value,
                                dec.value, True, at=now)
                    self.gc_log.append(e)
                    self._gc_index[key] = e
                    for r in members:
                        r.truncate(key)
                    wm += 1
                    n += 1
                if wm > self.watermarks.get(partition, 0):
                    self.watermarks[partition] = wm
            self.gc_truncations += n
            return n

    def scrub_pass(self) -> int:
        """Anti-entropy: exchange per-partition slot digests among alive
        members, repair divergent/corrupt replicas through `repair`, and
        quarantine (full state transfer) any member whose corrupt-record
        count crosses the threshold.  Returns repairs made."""
        lc = self.lifecycle
        if lc is None or not lc.scrub:
            return 0
        with self._reconfig_lock:
            alive = [(i, self.replicas[i])
                     for i in self._membership.replica_ids if self._alive[i]]
            if len(alive) < 2:
                return 0
            digests = [r.partition_digests() for _i, r in alive]
            suspect_parts = set()
            all_parts = set()
            for dg in digests:
                all_parts.update(dg)
            for p in all_parts:
                vals = {dg.get(p) for dg in digests}
                if len(vals) > 1:
                    suspect_parts.add(p)
            corrupt_by = {i: set(r.corrupt_keys()) for i, r in alive}
            self.corrupt_records += sum(
                len(ks) for ks in corrupt_by.values())
            keys = set()
            for _i, r in alive:
                keys.update(k for k in r.keys() if k[0] in suspect_parts)
            for ks in corrupt_by.values():
                keys.update(ks)
            repaired = 0
            for k in sorted(keys):
                if k in self._gc_index:
                    for _i, r in alive:
                        r.truncate(k)
                    continue
                reads = [(r, r.read(k)) for _i, r in alive]
                v, g, d = merge_reads([rd for _r, rd in reads])
                if v is None and not d:
                    continue
                for r, (rv, rg, rd) in reads:
                    if rg < g or (d and not rd) or (v is not None
                                                    and rv is None):
                        r.repair(k, v, g, d)
                        repaired += 1
            self.scrub_repairs += repaired
            threshold = lc.quarantine_threshold
            for i, _r in alive:
                if len(corrupt_by[i]) >= threshold:
                    # Quarantine: refresh the whole volume from its peers.
                    self.quarantines += 1
                    self._state_transfer(i, self._membership.replica_ids)
            return repaired

    def partition_log(self, partition: str) -> List[Tuple[str, str]]:
        with self._glock:
            order = self._order.get(partition)
            if order is not None:
                wm = self.watermarks.get(partition, 0)
                retained = order[wm:]
                return [(partition, t) for t in retained
                        if (partition, t) not in self._gc_index]
        keys = set()
        for r in self.member_replicas():
            keys.update(k for k in r.keys() if k[0] == partition)
        return sorted(keys)

    def is_truncated(self, key: Tuple[str, str]) -> bool:
        return key in self._gc_index

    def watermark_lag(self) -> int:
        with self._glock:
            return sum(len(order) - self.watermarks.get(p, 0)
                       for p, order in self._order.items())


class DelayedMemoryStore(MemoryStore):
    """MemoryStore whose store-side ops cost ``delay_s`` of service time.

    The sleep sits INSIDE the op (under ``perform()`` for ``log_once``),
    so a decision-cache hit — which never runs the op — skips it, and a
    singleflight joiner shares one leader's delay instead of paying its
    own.  Wall-clock harnesses (``txn.threaded``, ``serve``)
    use this to make throughput a property of the protocol's forced-write
    count rather than of the host machine."""

    def __init__(self, delay_s: float,
                 decisions: Optional[DecisionCacheConfig] = None,
                 lifecycle: Optional[LifecycleConfig] = None) -> None:
        super().__init__(decisions=decisions, lifecycle=lifecycle)
        self._delay_s = delay_s

    def _log_once_direct(self, partition, txn, state, writer=""):
        time.sleep(self._delay_s)
        return super()._log_once_direct(partition, txn, state, writer)

    def log(self, partition, txn, state, writer=""):
        time.sleep(self._delay_s)
        return super().log(partition, txn, state, writer)


class DelayedReplicatedStore(ReplicatedStore):
    """ReplicatedStore with the same injected per-op service delay."""

    def __init__(self, delay_s: float, n_replicas: int = 3, seed: int = 0,
                 max_rounds: int = 256,
                 decisions: Optional[DecisionCacheConfig] = None,
                 membership: Optional[Sequence[int]] = None,
                 lifecycle: Optional[LifecycleConfig] = None) -> None:
        super().__init__(n_replicas=n_replicas, seed=seed,
                         max_rounds=max_rounds, decisions=decisions,
                         membership=membership, lifecycle=lifecycle)
        self._delay_s = delay_s

    def _log_once_quorum(self, partition, txn, state, writer=""):
        time.sleep(self._delay_s)
        return super()._log_once_quorum(partition, txn, state, writer)

    def log(self, partition, txn, state, writer=""):
        time.sleep(self._delay_s)
        return super().log(partition, txn, state, writer)


# --------------------------------------------------------------------------
# Threaded group commit: BatchingStore decorator
# --------------------------------------------------------------------------
class _ThreadBatchOp:
    __slots__ = ("kind", "args", "event", "result", "error", "promoted")

    def __init__(self, kind: str, args: tuple):
        self.kind = kind
        self.args = args
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.promoted = False          # woken to LEAD, not with a result


class _ThreadLane:
    __slots__ = ("lock", "pending", "leader_active")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.pending: List[_ThreadBatchOp] = []
        self.leader_active = False


class BatchingStore:
    """Group-commit decorator for the threaded stores (``MemoryStore`` /
    ``FileStore`` / ``ReplicatedStore``).

    Same blocking three-operation surface as the wrapped store.  Concurrent
    ``log_once`` / ``log`` calls targeting one partition coalesce: the first
    caller becomes the batch *leader*, sleeps ``window_s`` collecting
    followers, then applies every queued op against the inner store in
    arrival order — one leader round trip (``round_trips``) per batch —
    and hands each follower its own result (or exception, e.g.
    ``QuorumUnavailable``).  Arrival order decides first-writer-wins per
    slot exactly as unbatched calls would; reads pass straight through.

    ``window_s=0`` still batches whatever queued while the previous leader
    was executing (piggyback group commit), which is the recommended
    deployment: zero added latency when idle, amortization under load.
    """

    def __init__(self, inner, window_s: float = 0.0,
                 max_batch: int = 64) -> None:
        assert max_batch >= 1
        self.inner = inner
        self.window_s = window_s
        self.max_batch = max_batch
        self._lanes: Dict[str, _ThreadLane] = {}
        self._lanes_lock = threading.Lock()
        self.round_trips = 0
        self.batched_ops = 0

    # Everything not intercepted (read_state, writer_of, snapshot, log_data,
    # put_data/get_data, fail_replica, cas_attempts, ...) delegates.
    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    def _lane(self, partition: str) -> _ThreadLane:
        with self._lanes_lock:
            lane = self._lanes.get(partition)
            if lane is None:
                lane = self._lanes[partition] = _ThreadLane()
            return lane

    def _apply(self, op: _ThreadBatchOp) -> None:
        try:
            fn = getattr(self.inner, op.kind)
            op.result = fn(*op.args)
        except BaseException as e:          # surfaced in the caller's thread
            op.error = e

    def _submit(self, partition: str, op: _ThreadBatchOp) -> Vote:
        lane = self._lane(partition)
        with lane.lock:
            lane.pending.append(op)
            lead = not lane.leader_active
            if lead:
                lane.leader_active = True
        if not lead:
            op.event.wait()
            if op.promoted:
                # The previous leader finished its round with ops (ours
                # included) still queued and handed leadership over, so no
                # caller ever leads more than one round (a leader trapped
                # draining other threads' ops would see unbounded latency).
                lead = True
        if lead:
            # ONE leader round: our op was queued before we took
            # leadership, so it is always in this batch.
            if self.window_s > 0:
                time.sleep(self.window_s)
            with lane.lock:
                batch = lane.pending[:self.max_batch]
                lane.pending = lane.pending[self.max_batch:]
            # One round trip for the whole batch.
            self.round_trips += 1
            self.batched_ops += len(batch)
            for b in batch:
                self._apply(b)
            with lane.lock:
                nxt = lane.pending[0] if lane.pending else None
                if nxt is None:
                    lane.leader_active = False
                else:
                    nxt.promoted = True
            for b in batch:
                if b is not op:
                    b.event.set()
            if nxt is not None:
                nxt.event.set()
        if op.error is not None:
            raise op.error
        return op.result

    def log_once(self, partition: str, txn: str, state: Vote,
                 writer: str = "") -> Vote:
        return self._submit(partition, _ThreadBatchOp(
            "log_once", (partition, txn, state, writer)))

    def log(self, partition: str, txn: str, state: Vote,
            writer: str = "") -> Vote:
        return self._submit(partition, _ThreadBatchOp(
            "log", (partition, txn, state, writer)))
