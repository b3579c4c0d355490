"""Serving SLO accounting: tail latency, goodput, TTFT, disruption.

One ``LatencyRecorder`` per engine run collects per-step samples from all
client threads; ``report()`` folds them into an ``SloReport`` — the unit
the serve bench sweeps per (protocol, arrival rate, batch mode) cell:

  p50/p95/p99        – end-to-end step latency (queue + decode + commit),
                       nearest-rank percentiles (``txn.executor.percentile``).
  tail amplification – p99/p50: how much worse the tail is than the median.
                       This is where 2PC's extra forced decision write
                       shows up even when medians look comparable.
  goodput            – committed steps that ALSO met their deadline, per
                       second.  Drops, rejects, aborts, and late commits
                       all count against goodput but not against raw
                       throughput.
  TTFT               – time-to-first-token per session (first step's
                       end-to-end latency, the user-visible startup cost).
  disruption         – throughput inside a marked window (a checkpoint
                       publish, a replica kill) divided by throughput
                       outside it; 1.0 = the event was free.

The port's copy of ``repro/serve/slo.py`` (the standard library only; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..txn.executor import percentile

__all__ = ["LatencyRecorder", "SloReport", "windowed_tput"]


def windowed_tput(times: List[float], start: float, end: float) -> float:
    """Completions per second inside [start, end)."""
    if end <= start:
        return 0.0
    n = sum(1 for t in times if start <= t < end)
    return n / (end - start)


@dataclass
class SloReport:
    protocol: str = ""
    arrival: str = "closed"
    batch_mode: str = "batched"
    # Counts.
    completed: int = 0          # steps that came back from decode
    committed: int = 0          # ... and committed their txn
    aborted: int = 0            # ... but the commit lost to a termination
    dropped: int = 0            # shed by deadline or shutdown
    rejected: int = 0           # shed by backpressure
    # Rates.
    elapsed_s: float = 0.0
    throughput_tps: float = 0.0
    goodput_tps: float = 0.0
    # Latency (ms).
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    tail_amplification: float = 0.0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    mean_batch: float = 0.0
    # Throughput inside the marked event window / outside it (None when no
    # window was marked).
    publish_disruption: Optional[float] = None
    # Durability lifecycle (all zero unless the store was built with a
    # LifecycleConfig): anti-entropy repairs, volumes quarantined, slots
    # truncated by the GC watermark, and slots still behind it at run end.
    scrub_repairs: int = 0
    quarantines: int = 0
    gc_truncations: int = 0
    watermark_lag: int = 0

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}


class LatencyRecorder:
    """Thread-safe sample sink shared by every client thread of one run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lat_ms: List[float] = []
        self._ttft_ms: List[float] = []
        self._done_at: List[float] = []      # monotonic completion stamps
        self._good: int = 0
        self.committed = 0
        self.aborted = 0
        self.dropped = 0
        self.rejected = 0
        self._windows: List[Tuple[float, float]] = []

    # -- sample intake ------------------------------------------------------
    def record_step(self, latency_ms: float, committed: bool,
                    within_deadline: bool, t_done: float,
                    first: bool = False) -> None:
        with self._lock:
            self._lat_ms.append(latency_ms)
            self._done_at.append(t_done)
            if first:
                self._ttft_ms.append(latency_ms)
            if committed:
                self.committed += 1
                if within_deadline:
                    self._good += 1
            else:
                self.aborted += 1

    def record_drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def mark_window(self, start: float, end: float) -> None:
        """Mark a disruption window (publish / failure injection)."""
        with self._lock:
            self._windows.append((start, end))

    # -- folding ------------------------------------------------------------
    def report(self, elapsed_s: float, run_start: float,
               protocol: str = "", arrival: str = "closed",
               batch_mode: str = "batched",
               mean_batch: float = 0.0) -> SloReport:
        with self._lock:
            lat = list(self._lat_ms)
            ttft = list(self._ttft_ms)
            done = list(self._done_at)
            windows = list(self._windows)
            rep = SloReport(
                protocol=protocol, arrival=arrival, batch_mode=batch_mode,
                completed=len(lat), committed=self.committed,
                aborted=self.aborted, dropped=self.dropped,
                rejected=self.rejected, elapsed_s=elapsed_s,
                mean_batch=mean_batch)
        rep.throughput_tps = (rep.committed / elapsed_s
                              if elapsed_s > 0 else 0.0)
        rep.goodput_tps = self._good / elapsed_s if elapsed_s > 0 else 0.0
        rep.p50_ms = percentile(lat, 0.50)
        rep.p95_ms = percentile(lat, 0.95)
        rep.p99_ms = percentile(lat, 0.99)
        rep.tail_amplification = (rep.p99_ms / rep.p50_ms
                                  if rep.p50_ms > 0 else 0.0)
        rep.ttft_p50_ms = percentile(ttft, 0.50)
        rep.ttft_p99_ms = percentile(ttft, 0.99)
        if windows:
            run_end = run_start + elapsed_s
            inside = 0.0
            in_n = 0
            for (ws, we) in windows:
                ws, we = max(ws, run_start), min(we, run_end)
                if we > ws:
                    inside += we - ws
                    in_n += sum(1 for t in done if ws <= t < we)
            outside = max(1e-9, elapsed_s - inside)
            out_rate = (len(done) - in_n) / outside
            in_rate = in_n / inside if inside > 0 else 0.0
            rep.publish_disruption = (in_rate / out_rate
                                      if out_rate > 0 else 1.0)
        return rep
