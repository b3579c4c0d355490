"""Background checkpoint publisher: model snapshots commit mid-traffic.

The port's copy of ``repro/serve/publisher.py`` (the standard library only;
the port imports nothing of the JAX package).

A serving fleet periodically publishes a new model snapshot (weights after
an online update, adapter swap, KV-prefix warmup...).  The publish is a
Cornus checkpoint epoch — every publisher host uploads its shard and
LogOnce-votes through ``CornusCheckpointer`` — run against the SAME store
the live session traffic is committing through.  The point the engine test
makes: because Cornus puts no eager decision record on the critical path
and its termination protocol never blocks, a publish (or a replica volume
dying under one) dents serving throughput by a bounded, small amount
instead of stalling the ingress queue behind a wedged coordinator.

The publisher is payload-agnostic: pass ``payload_of(epoch, host)`` to
publish real packed pytrees (``ckpt.shards.pack_tree``); the default is
seeded synthetic bytes, so the serve bench needs no model.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..ckpt.commit import CornusCheckpointer
from ..core.state import Decision

__all__ = ["CheckpointPublisher", "PublishRecord"]


@dataclass
class PublishRecord:
    epoch: int
    decision: Decision
    ms: float                    # wall-clock for the whole epoch
    t_start: float               # monotonic stamps for window accounting
    t_end: float
    forced_aborts: int = 0


def _default_payload(nbytes: int) -> Callable[[int, str], bytes]:
    def payload_of(epoch: int, host: str) -> bytes:
        # A str seed: since Python 3.11 ``random.Random`` refuses the
        # JAX package's tuple seed ``(epoch, host)``, so there every
        # default-payload upload raises and no epoch commits.
        rng = random.Random(f"{epoch}/{host}")
        return rng.randbytes(nbytes)
    return payload_of


class CheckpointPublisher:
    """Commits snapshot epochs through ``CornusCheckpointer``s, one per
    publisher host, voting concurrently like a real fleet.

    ``publish_once`` runs a full epoch synchronously (the caller decides
    threading); ``start``/``stop`` run epochs every ``interval_s`` on a
    daemon thread for always-on background publishing.
    """

    def __init__(self, store, hosts: Sequence[str] = ("pub0", "pub1"),
                 payload_of: Optional[Callable[[int, str], bytes]] = None,
                 payload_bytes: int = 1 << 12,
                 interval_s: float = 0.25,
                 straggler_timeout_s: float = 2.0,
                 epoch0: int = 0) -> None:
        self.store = store
        self.hosts = list(hosts)
        self.payload_of = payload_of or _default_payload(payload_bytes)
        self.interval_s = interval_s
        self._ckpt = {h: CornusCheckpointer(
            store, h, self.hosts, straggler_timeout_s=straggler_timeout_s,
            poll_interval_s=0.005) for h in self.hosts}
        self._epoch = epoch0
        self.records: List[PublishRecord] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one epoch ----------------------------------------------------------
    def publish_once(self) -> PublishRecord:
        with self._lock:
            epoch = self._epoch
            self._epoch += 1
        t0 = time.monotonic()
        outcomes = [None] * len(self.hosts)

        def voter(i: int, h: str) -> None:
            outcomes[i] = self._ckpt[h].save(epoch,
                                             self.payload_of(epoch, h))

        threads = [threading.Thread(target=voter, args=(i, h), daemon=True)
                   for i, h in enumerate(self.hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t1 = time.monotonic()
        # All hosts converge on one decision (Lemma 1); any host's outcome
        # is the epoch's.
        decision = outcomes[0].decision if outcomes[0] else Decision.ABORT
        rec = PublishRecord(
            epoch=epoch, decision=decision, ms=(t1 - t0) * 1e3,
            t_start=t0, t_end=t1,
            forced_aborts=sum(o.forced_aborts for o in outcomes if o))
        with self._lock:
            self.records.append(rec)
        return rec

    # -- background loop ----------------------------------------------------
    def start(self) -> "CheckpointPublisher":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        # First epoch fires immediately — a publish window that closes
        # within one interval still publishes.
        while True:
            try:
                self.publish_once()
            except Exception:
                # A failed publish (quorum loss mid-epoch) must never take
                # down serving; the next interval retries a fresh epoch.
                pass
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> List[PublishRecord]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            return list(self.records)

    @property
    def committed_epochs(self) -> List[int]:
        with self._lock:
            return [r.epoch for r in self.records
                    if r.decision == Decision.COMMIT]
