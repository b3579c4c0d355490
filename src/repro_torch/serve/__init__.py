"""Transactional model serving: every session step is an atomic commit.

The port of ``repro.serve``.  An inference session's state changes (open,
per-token KV-cache update, close) are distributed transactions over the
partitioned KV store, committed through any registered protocol, so the
Cornus-vs-2PC latency gap shows up directly as serving tail latency,
goodput, and publish-window disruption.

  session    – sessions as transactions (``SessionManager``/``commit_txn``)
  admission  – continuous-batching ingress (bounded queue, backpressure,
               deadline drops; ``flash_decode`` on the card through
               ``KernelDecode``, or a latency-model stub)
  engine     – closed/open-loop serving with failure + publish injection
  publisher  – background Cornus checkpoint epochs mid-traffic
  slo        – p50/p95/p99, tail amplification, goodput, TTFT, disruption
"""
from .admission import (AdmissionConfig, ContinuousBatcher, KernelDecode,
                        StepRequest, StubDecode, make_decode)
from .engine import EngineConfig, ServeEngine, ServeResult, run_serve
from .publisher import CheckpointPublisher, PublishRecord
from .session import (Session, SessionConfig, SessionManager, StepOutcome,
                      build_session_store)
from .slo import LatencyRecorder, SloReport

__all__ = [
    "AdmissionConfig", "CheckpointPublisher", "ContinuousBatcher",
    "EngineConfig", "KernelDecode", "LatencyRecorder", "PublishRecord",
    "ServeEngine", "ServeResult", "Session", "SessionConfig",
    "SessionManager", "SloReport", "StepOutcome", "StepRequest",
    "StubDecode", "build_session_store", "make_decode", "run_serve",
]
