"""Disaggregated storage layer: Log() / LogOnce() over pluggable stores.

The port's trimmed copy of ``repro/core/storage.py``: the two threaded
stores the checkpoint commit runs on, with the JAX package's on-disk
layout, and nothing of its simulated, replicated, delayed or batching
stores.  The paper's only storage-layer requirement is *log-once*
semantics built on a compare-and-swap primitive (§3.2, §4):

  * ``MemoryStore``  – lock-protected dict; used by threaded tests (stands
    in for Azure Redis / Blob).
  * ``FileStore``    – directory-backed; ``open(O_CREAT|O_EXCL)`` is the CAS
    (create-if-absent ≙ Azure Blob "If-None-Match:*" conditional PUT).  Used
    by the training driver's Cornus checkpoint commit.
  * ``LatencyModel`` – the paper's measured service times (§5.1.2).

Every store exposes the same three operations on the *transaction-state* log:

  log_once(partition, txn, state) -> resulting state   (CAS; first write wins)
  log(partition, txn, state)      -> resulting state   (blind append; 2PC path)
  read_state(partition, txn)      -> state | None
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .control import DecisionCacheConfig, ThreadControlPlane
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
