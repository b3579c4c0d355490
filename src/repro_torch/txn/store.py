"""Partitioned store: per-partition NO-WAIT 2PL lock tables.

The port's copy of ``repro/txn/store.py`` (the standard library only; the
port imports nothing of the JAX package).

The paper's default concurrency control is NO-WAIT (§5.1.4): a conflicting
lock request aborts the requesting transaction immediately — deadlock-free,
and the reason contention shows up as abort/retry time (Fig 7b) rather than
lock-wait time.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple


class LockMode(enum.Enum):
    SHARED = "S"
    EXCLUSIVE = "X"


@dataclass
class _Entry:
    mode: LockMode
    holders: Set[str] = field(default_factory=set)


class LockTable:
    """One partition's lock table. Keys are opaque strings."""

    def __init__(self, partition: str):
        self.partition = partition
        self._locks: Dict[str, _Entry] = {}
        self._held_by: Dict[str, Set[str]] = {}  # txn -> keys
        self.acquires = 0
        self.conflicts = 0

    def try_lock(self, txn: str, key: str, mode: LockMode) -> bool:
        """NO-WAIT acquire: False ⇒ caller must abort the transaction."""
        self.acquires += 1
        e = self._locks.get(key)
        if e is None or not e.holders:
            self._locks[key] = _Entry(mode, {txn})
        elif txn in e.holders:
            if mode == LockMode.EXCLUSIVE and e.mode == LockMode.SHARED:
                if len(e.holders) > 1:
                    self.conflicts += 1
                    return False  # upgrade blocked by co-readers
                e.mode = LockMode.EXCLUSIVE
        elif mode == LockMode.SHARED and e.mode == LockMode.SHARED:
            e.holders.add(txn)
        else:
            self.conflicts += 1
            return False
        self._held_by.setdefault(txn, set()).add(key)
        return True

    def release_all(self, txn: str) -> int:
        """Drop every lock txn holds here (commit/abort/ELR-precommit)."""
        keys = self._held_by.pop(txn, set())
        for k in keys:
            e = self._locks.get(k)
            if e is None:
                continue
            e.holders.discard(txn)
            if not e.holders:
                del self._locks[k]
        return len(keys)

    def held(self, txn: str) -> Set[str]:
        return set(self._held_by.get(txn, ()))
