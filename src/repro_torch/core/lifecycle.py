"""Durable-state lifecycle: checksummed records, truncation watermarks, scrub.

The port's copy of ``repro/core/lifecycle.py`` (the standard library
and numpy only; the port imports nothing of the JAX package).

Cornus delegates *all* durability to the storage layer: every vote and
decision is a LogOnce record, and historically those records lived forever
and were trusted blindly.  This module supplies the three primitives the
lifecycle layer is built from:

  * **CRC32 record framing** — `encode_record` / `decode_record` wrap a
    state record (``vote\nwriter\n``) in a ``crc1`` header carrying the
    body length and CRC32.  Readers distinguish a *torn tail* (body shorter
    than the declared length — an unacknowledged write that died mid-flight,
    safe to treat as absent) from *bit-rot* (full-length body whose CRC
    mismatches — a previously acknowledged record that must NOT be treated
    as absent, only repaired from redundancy).  Both surface as a typed
    `CorruptRecord` instead of garbage bytes.

  * **`LifecycleConfig`** — the default-off switch block threaded through
    `StoreConfig`/`BenchConfig`.  With ``lifecycle=None`` every store
    behaves bit-identically to the pre-lifecycle code.

  * **`GcEntry` truncation journal** — every slot the GC watermark
    truncates leaves a journal entry recording the value it held and the
    durable terminal decision that justified truncating it.  The history
    checker consumes this journal to enforce AC-GC: truncation must
    preserve recoverability (never truncate a slot whose transaction has
    no durable terminal decision, and never journal a decision the nodes
    did not actually reach).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field, asdict
from typing import Optional, Tuple, Union

RECORD_MAGIC = b"crc1 "

__all__ = [
    "CorruptRecord", "GcEntry", "LifecycleConfig",
    "encode_record", "decode_record", "RECORD_MAGIC",
]


@dataclass(frozen=True)
class CorruptRecord:
    """Typed result of reading a record that failed its checksum.

    ``torn=True`` means the body is shorter than the declared length: the
    write was never acknowledged, so the record is safe to treat as absent
    (LogOnce may claim the slot).  ``torn=False`` means full-length bit-rot
    of a previously acknowledged record: it must never be treated as absent
    — only repaired from a replica or a sibling slot of the same txn.
    """
    partition: str = ""
    txn: str = ""
    torn: bool = False
    detail: str = ""
    # Flows harmlessly through code that treats records as Vote-like.
    value = "CORRUPT"

    def is_decision(self) -> bool:
        return False


def encode_record(state_value: str, writer: str) -> bytes:
    """Frame ``state\\nwriter\\n`` with a crc1 header (length + CRC32)."""
    body = f"{state_value}\n{writer}\n".encode()
    head = RECORD_MAGIC + b"%08x %08x\n" % (zlib.crc32(body), len(body))
    return head + body


def decode_record(blob: bytes, partition: str = "",
                  txn: str = "") -> Union[Tuple[str, str], CorruptRecord]:
    """Decode a crc1-framed record; returns ``(state_value, writer)``.

    Returns a `CorruptRecord` (never raises) on framing damage:
    ``torn=True`` for empty blobs / short headers / short bodies,
    ``torn=False`` for full-length bodies whose CRC32 mismatches.
    Legacy (unframed) records are passed through by the caller — this
    function only handles blobs carrying the magic.
    """
    if not blob.startswith(RECORD_MAGIC):
        return CorruptRecord(partition, txn, torn=True, detail="missing frame header")
    head, sep, body = blob[len(RECORD_MAGIC):].partition(b"\n")
    if not sep:
        return CorruptRecord(partition, txn, torn=True, detail="truncated header")
    try:
        crc_hex, len_hex = head.split()
        want_crc, want_len = int(crc_hex, 16), int(len_hex, 16)
    except ValueError:
        return CorruptRecord(partition, txn, torn=True, detail="unparsable header")
    if len(body) < want_len:
        return CorruptRecord(
            partition, txn, torn=True,
            detail=f"torn tail: {len(body)}/{want_len} bytes")
    body = body[:want_len]
    if zlib.crc32(body) != want_crc:
        return CorruptRecord(
            partition, txn, torn=False,
            detail=f"crc mismatch: {zlib.crc32(body):08x} != {want_crc:08x}")
    try:
        state_value, writer = body.decode().splitlines()[:2]
    except (UnicodeDecodeError, ValueError):
        return CorruptRecord(partition, txn, torn=False, detail="undecodable body")
    return state_value, writer


@dataclass
class LifecycleConfig:
    """Default-off switches for the durable-state lifecycle.

    ``checksums`` arms CRC32 record framing (torn-tail / bit-rot detection).
    ``gc`` arms the per-partition low-watermark truncation pass.
    ``scrub`` arms the anti-entropy scrubber on replicated stores.
    Intervals are sim-ms cadences for the background passes (0 = manual
    passes only).  ``quarantine_threshold`` is the per-volume corrupt-record
    count at which the volume is quarantined and refreshed wholesale.
    """
    checksums: bool = True
    gc: bool = False
    scrub: bool = False
    gc_interval_ms: float = 25.0
    scrub_interval_ms: float = 40.0
    quarantine_threshold: int = 3

    @classmethod
    def coerce(cls, value) -> Optional["LifecycleConfig"]:
        """Accept None / dict (repro-bundle JSON) / LifecycleConfig."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot coerce {type(value).__name__} to LifecycleConfig")

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class GcEntry:
    """Truncation-journal entry: one slot removed by the GC watermark.

    ``value`` is the state the slot held when truncated; ``decision`` is
    the durable terminal decision that settled the txn and justified the
    truncation; ``settled`` records whether the watermark rule was actually
    satisfied (the checker flags AC-GC on any entry where it was not).
    """
    partition: str
    txn: str
    value: Optional[str]
    decision: Optional[str]
    settled: bool
    at: float = 0.0
