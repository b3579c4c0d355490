"""Non-blocking restore: find the newest COMMITTED epoch and load it.

The port's copy of ``repro/ckpt/restore.py``, over the port's ``core``
stores and ``ckpt.shards``.

A restarting fleet must never block on an epoch left in-flight by a crash
(the 2PC failure mode in paper Fig 2b).  ``latest_committed`` walks epochs
newest-first; UNDETERMINED epochs are *resolved* — not waited on — with the
termination protocol, which either confirms the collective COMMIT or forces
ABORT in bounded time (Theorem 4).  Elasticity: shards are reassembled from
whatever host partitioning wrote them, so the restored fleet size may differ
from the writing fleet.

Erasure-coded epochs (``CornusCheckpointer(ec_k=...)``) restore from any
``k`` surviving replica volumes: ``fetch_payloads`` tries the plain payload
path first, then gathers fragments from whatever volumes still hold them
and decodes — volumes may keep dying *between* per-host reads (the
``after_host`` hook is how tests kill them mid-restore) and the restore
still succeeds as long as each host's fragment count stays >= k.
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.state import Decision
from .commit import CornusCheckpointer, _ec_name, _txn
from .shards import ec_decode, merge_into_tree, unpack_tree


def list_epochs(store, hosts: Sequence[str]) -> List[int]:
    """All epoch ids any host has a state record for (FileStore layout)."""
    seen = set()
    root = getattr(store, "root", None)
    if root is not None:
        for h in hosts:
            d = os.path.join(root, "state", h)
            if os.path.isdir(d):
                for name in os.listdir(d):
                    m = re.fullmatch(r"e(\d+)", name)
                    if m:
                        seen.add(int(m.group(1)))
    else:  # MemoryStore
        for (partition, txn), _ in store.snapshot().items():
            m = re.fullmatch(r"e(\d+)", txn)
            if m:
                seen.add(int(m.group(1)))
    return sorted(seen, reverse=True)


def latest_committed(store, hosts: Sequence[str],
                     resolver_host: str = "restore") -> Optional[int]:
    ck = CornusCheckpointer(store, resolver_host, hosts)
    for epoch in list_epochs(store, hosts):
        d = ck.global_decision(epoch)
        if d == Decision.UNDETERMINED:
            # In-flight epoch from a crashed run: resolve, don't wait.
            d, _ = ck.terminate(epoch)
        if d == Decision.COMMIT:
            return epoch
    return None


def _host_payload(store, host: str, epoch: int) -> bytes:
    """One host's shard payload: plain path first, then erasure fragments
    gathered from whichever replica volumes still hold them."""
    try:
        return store.get_data(host, _txn(epoch))
    except FileNotFoundError:
        if not hasattr(store, "alive_replicas"):
            raise
    frags = []
    for r in store.alive_replicas():
        got = r.get_data(host, _ec_name(epoch))
        if got is not None:
            frags.append(got[1])
    if not frags:
        raise FileNotFoundError(f"no volume holds a fragment of "
                                f"{host}/{_txn(epoch)}")
    try:
        return ec_decode(frags)
    except ValueError as e:
        # Fewer than k fragments survived: for the caller this is the
        # same condition as a missing plain payload.
        raise FileNotFoundError(
            f"unrecoverable erasure-coded payload "
            f"{host}/{_txn(epoch)}: {e}") from e


def fetch_payloads(store, hosts: Sequence[str], epoch: int,
                   after_host: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, bytes]:
    """Every recoverable host payload for ``epoch``.  ``after_host`` runs
    between per-host reads — the failure-injection point for tests that
    kill volumes *mid-restore*."""
    out: Dict[str, bytes] = {}
    for h in hosts:
        try:
            out[h] = _host_payload(store, h, epoch)
        except FileNotFoundError:
            pass
        if after_host is not None:
            after_host(h)
    return out


def restore_params(store, hosts: Sequence[str], epoch: int, template):
    """Reassemble the full tree from every host's shard payload."""
    flat: Dict[str, np.ndarray] = {}
    for payload in fetch_payloads(store, hosts, epoch).values():
        flat.update(unpack_tree(payload))
    return merge_into_tree(template, flat)
