"""Continuous-batching admission control (port of ``repro.serve.admission``).

``AdmissionConfig``, ``StepRequest``, ``StubDecode`` and
``ContinuousBatcher`` are the JAX package's pure-Python classes, copied so
the port imports nothing of it: a bounded ingress queue whose requests
coalesce into the next batch within a formation window, with backpressure
(block or reject on a full queue) and deadline drops at batch formation.

The decode call is pluggable.  ``KernelDecode`` is the counterpart of the
JAX package's ``PallasDecode``: one ``flash_decode`` launch per batch over a
pooled KV cache on the device.  ``StubDecode`` is a deterministic latency
model for machine-independent benches.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..device import resolve
from ..kernels import ops

__all__ = ["AdmissionConfig", "ContinuousBatcher", "KernelDecode",
           "StepRequest", "StubDecode", "make_decode"]


@dataclass
class AdmissionConfig:
    max_batch: int = 8
    window_ms: float = 2.0          # batch formation window from 1st arrival
    queue_depth: int = 64           # bounded ingress queue
    backpressure: str = "block"     # "block" | "reject" on a full queue
    deadline_ms: Optional[float] = None   # per-request; None = no deadline

    def __post_init__(self) -> None:
        if self.backpressure not in ("block", "reject"):
            raise ValueError(f"backpressure must be 'block' or 'reject', "
                             f"got {self.backpressure!r}")


class StepRequest:
    """One decode step for one session, in flight through the batcher."""

    __slots__ = ("session", "token", "submitted_at", "deadline_at", "done",
                 "result", "dropped", "batch_size", "decode_ms")

    def __init__(self, session: str, token: int,
                 deadline_at: Optional[float] = None) -> None:
        self.session = session
        self.token = token
        self.submitted_at = time.monotonic()
        self.deadline_at = deadline_at
        self.done = threading.Event()
        self.result: Optional[int] = None
        self.dropped = False
        self.batch_size = 0
        self.decode_ms = 0.0


class StubDecode:
    """Latency-modeled batched decode: one batch costs
    ``base_ms + per_item_ms * len(batch)`` of sleep.  The returned token is
    a deterministic hash of (session, token)."""

    def __init__(self, base_ms: float = 1.0, per_item_ms: float = 0.1,
                 vocab: int = 50_000) -> None:
        self.base_ms = base_ms
        self.per_item_ms = per_item_ms
        self.vocab = vocab

    def __call__(self, reqs: Sequence[StepRequest]) -> List[int]:
        time.sleep((self.base_ms + self.per_item_ms * len(reqs)) / 1e3)
        return [(hash((r.session, r.token)) & 0x7FFFFFFF) % self.vocab
                for r in reqs]


class KernelDecode:
    """``flash_decode``-backed batched decode over a pooled KV cache.

    Keeps one preallocated ``(slots, Hkv, T, hd)`` K/V pool on the device;
    each session owns a slot and a valid-prefix length.  A batch appends
    each session's new K/V at its write position, gathers the sessions'
    cache rows and runs ONE ``flash_decode`` for the whole batch with the
    single scalar ``kv_len = max(lens)``, as ``PallasDecode`` does (so a
    shorter session attends to zero or stale rows up to the batch maximum).

    The query and new K/V of each request are stand-ins drawn from a
    ``torch.Generator`` seeded by (seed, session, token, position): the same
    request draws the same numbers whatever batch it lands in.  The
    subsystem under test is batching, not the LM weights.
    """

    def __init__(self, slots: int = 64, q_heads: int = 4, kv_heads: int = 2,
                 head_dim: int = 64, max_len: int = 256, seed: int = 0,
                 dtype=torch.float32, device="cuda") -> None:
        self.device = resolve(device)
        self.slots = slots
        self.q_heads = q_heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.max_len = max_len
        self.seed = seed
        self.dtype = dtype
        shape = (slots, kv_heads, max_len, head_dim)
        self._k = torch.zeros(shape, dtype=dtype, device=self.device)
        self._v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._lens = [0] * slots
        self._by_session = {}
        self._free = list(range(slots))
        self._lock = threading.Lock()

    def _slot_of(self, session: str) -> int:
        with self._lock:
            i = self._by_session.get(session)
            if i is None:
                if not self._free:
                    # Recycle the lowest-numbered registered slot, as the
                    # JAX package does: the commit layer, not the cache, is
                    # the session's ground truth.
                    i = min(self._by_session.values())
                    stale = next(s for s, j in self._by_session.items()
                                 if j == i)
                    del self._by_session[stale]
                else:
                    i = self._free.pop()
                self._by_session[session] = i
                self._lens[i] = 0
            return i

    def release(self, session: str) -> None:
        with self._lock:
            i = self._by_session.pop(session, None)
            if i is not None:
                self._free.append(i)
                self._lens[i] = 0

    def _stand_ins(self, session: str, token: int, pos: int):
        key = (self.seed, zlib.crc32(session.encode()), int(token), pos)
        gen = torch.Generator()
        gen.manual_seed(hash(key) & 0x7FFF_FFFF_FFFF_FFFF)
        q = torch.randn((self.q_heads, self.head_dim), generator=gen)
        kv = torch.randn((2, self.kv_heads, self.head_dim), generator=gen)
        return q, kv

    @torch.inference_mode()
    def __call__(self, reqs: Sequence[StepRequest]) -> List[int]:
        idx = [self._slot_of(r.session) for r in reqs]
        qs, kvs, pos = [], [], []
        for r, i in zip(reqs, idx):
            # Append this step's K/V at the session's write position FIRST
            # so the query attends to its own token even on an empty cache.
            p = min(self._lens[i], self.max_len - 1)
            q, kv = self._stand_ins(r.session, r.token, p)
            qs.append(q)
            kvs.append(kv)
            pos.append(p)
            self._lens[i] = p + 1
        dev, dt = self.device, self.dtype
        q = torch.stack(qs)[:, :, None, :].to(device=dev, dtype=dt)
        kv = torch.stack(kvs, dim=1).to(device=dev, dtype=dt)   # (2,B,Hkv,hd)
        slot = torch.tensor(idx, dtype=torch.long, device=dev)
        at = torch.tensor(pos, dtype=torch.long, device=dev)
        self._k[slot, :, at] = kv[0]
        self._v[slot, :, at] = kv[1]
        k = self._k.index_select(0, slot)
        v = self._v.index_select(0, slot)
        kv_len = max(self._lens[i] for i in idx)
        out = ops.flash_decode(q, k, v, kv_len)
        # Reduce each session's attention output to a token id: a stand-in
        # for the LM head.
        scores = out.float().abs().sum(dim=(1, 2, 3)).tolist()
        return [int(s * 1e4) % 50_000 for s in scores]


def make_decode(kind: str, **kwargs):
    """'stub' | 'kernel'.  There is no automatic choice: the kernel backend
    raises where it cannot run rather than turning into the stub."""
    if kind == "stub":
        return StubDecode(**kwargs)
    if kind == "kernel":
        return KernelDecode(**kwargs)
    raise ValueError(f"unknown decode backend {kind!r}; use 'stub' or "
                     f"'kernel'")


class ContinuousBatcher:
    """Bounded ingress queue + one decode worker forming batches.

    ``submit`` returns True when the request was admitted (its ``done``
    event will fire with either a result or ``dropped=True``), False when
    it was load-shed by ``reject`` backpressure.  ``stop()`` drains
    nothing: queued requests are failed as dropped so no client blocks
    forever across shutdown.
    """

    def __init__(self, decode, cfg: AdmissionConfig) -> None:
        self.decode = decode
        self.cfg = cfg
        self._queue: List[StepRequest] = []
        self._cv = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.submitted = 0
        self.rejected = 0
        self.dropped = 0
        self.batches = 0
        self.decoded = 0
        self.max_batch_seen = 0
        self.last_error: Optional[BaseException] = None

    # -- client side --------------------------------------------------------
    def submit(self, req: StepRequest) -> bool:
        if self.cfg.deadline_ms is not None and req.deadline_at is None:
            req.deadline_at = req.submitted_at + self.cfg.deadline_ms / 1e3
        with self._cv:
            while (len(self._queue) >= self.cfg.queue_depth
                   and not self._stopped):
                if self.cfg.backpressure == "reject":
                    self.rejected += 1
                    return False
                self._cv.wait(timeout=0.05)
            if self._stopped:
                self.rejected += 1
                return False
            self._queue.append(req)
            self.submitted += 1
            self._cv.notify_all()
        return True

    # -- worker side --------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            leftovers = self._queue
            self._queue = []
            self._cv.notify_all()
        for req in leftovers:
            req.dropped = True
            req.done.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _take_batch(self) -> List[StepRequest]:
        """Block until a batch is formed: first arrival starts the window;
        the batch closes when the window elapses or ``max_batch`` queued."""
        with self._cv:
            while not self._queue and not self._stopped:
                self._cv.wait(timeout=0.05)
            if self._stopped and not self._queue:
                return []
            deadline = time.monotonic() + self.cfg.window_ms / 1e3
            while (len(self._queue) < self.cfg.max_batch
                   and not self._stopped):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = self._queue[:self.cfg.max_batch]
            self._queue = self._queue[len(batch):]
            self._cv.notify_all()     # wake blocked submitters
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stopped:
                    return
                continue
            now = time.monotonic()
            live: List[StepRequest] = []
            for req in batch:
                if req.deadline_at is not None and now >= req.deadline_at:
                    # Expired while queued: shed BEFORE spending decode
                    # compute on a result nobody will wait for.
                    req.dropped = True
                    self.dropped += 1
                    req.done.set()
                else:
                    live.append(req)
            if not live:
                continue
            self.batches += 1
            self.max_batch_seen = max(self.max_batch_seen, len(live))
            t0 = time.monotonic()
            try:
                results = self.decode(live)
            except Exception as exc:
                # A decode failure fails the batch's requests, never the
                # serving loop (clients see a drop and may retry).
                self.last_error = exc
                for req in live:
                    req.dropped = True
                    self.dropped += 1
                    req.done.set()
                continue
            ms = (time.monotonic() - t0) * 1e3
            for req, tok in zip(live, results):
                req.result = tok
                req.batch_size = len(live)
                req.decode_ms = ms
                self.decoded += 1
                req.done.set()

    @property
    def mean_batch(self) -> float:
        return self.decoded / self.batches if self.batches else 0.0
