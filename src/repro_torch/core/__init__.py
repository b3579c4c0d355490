"""Cornus atomic commit — the paper's core contribution.

The port's copy of ``repro/core/__init__.py`` (the standard library and
numpy only; the port imports nothing of the JAX package), which also
exports the delayed threaded stores of the wall-clock and serving harnesses.

Public surface:
  state      – Vote / Decision / TxnSpec / global_decision (Def. 1)
  storage    – MemoryStore / FileStore / SimStorage + latency models
  protocols  – pluggable commit-protocol API: Transport + TxnContext +
               CommitProtocol strategies, register()/get_protocol() registry
               (cornus, 2pc, cl, cornus-opt1, paxos-commit)
  protocol   – Cluster facade wiring the three together (back-compat)
  variants   – Table-3 RTT model + runnable deployments per row
  sim        – deterministic discrete-event kernel
  chaos      – seeded FaultSchedule + Nemesis fault injection, retry
               policy / circuit breaker, failure-repro bundles
  history    – operation histories + AC1–AC3 / writer-of /
               recoverability / AC-GC checker (machine-verified safety)
  lifecycle  – checksummed record framing, LifecycleConfig, GC journal
"""
from .sim import Sim
from .state import Decision, TxnOutcome, TxnSpec, Vote, global_decision
from .control import (AdaptiveTimeouts, DecisionCacheConfig, DecisionIndex,
                      EwmaStat, LeaseKeeper, QuorumUnavailable,
                      ThreadControlPlane)
from .storage import (AZURE_BLOB, AZURE_BLOB_SEPARATE_ACL, AZURE_REDIS,
                      COMPUTE_RTT_MS, CROSS_REGION, CROSS_ZONE, INTRA_ZONE,
                      SLOW_REDIS, BatchConfig, BatchingStore,
                      DelayedMemoryStore, DelayedReplicatedStore, FileStore,
                      GroupCommitIngress, LatencyModel, MembershipConfig,
                      MemoryStore, RegionTopology, ReplicaLog,
                      ReplicatedSimStorage, ReplicatedStore, SimStorage,
                      StoreLease, merge_reads)
from .stores import (StoreConfig, build_store, get_store,
                     register_store, registered_stores)
from .chaos import (BitFlip, ChaosStore, CircuitBreaker, ClockSkew,
                    CrashRestart, FaultSchedule, GuardedStorage, LinkChaos,
                    Nemesis, NetPartition, RetryPolicy, TornTail, TornWrite,
                    Truncation, load_repro_bundle, write_repro_bundle)
from .history import (HistoryOp, HistoryRecorder, Violation, check_history,
                      check_run, collect_decisions)
from .lifecycle import (CorruptRecord, GcEntry, LifecycleConfig,
                        decode_record, encode_record)
from .protocols import (CommitProtocol, Transport, TxnContext, get_protocol,
                        register, registered_protocols)
from .protocol import Cluster, ProtocolConfig
from .variants import (SIMULATED_RTT_ROWS,
                       measured_caller_latency_ms,
                       predicted_caller_latency_ms, rtt_table)

__all__ = [
    "Sim", "Decision", "TxnOutcome", "TxnSpec", "Vote", "global_decision",
    "MemoryStore", "FileStore", "SimStorage", "LatencyModel",
    "AZURE_REDIS", "AZURE_BLOB", "AZURE_BLOB_SEPARATE_ACL", "SLOW_REDIS",
    "COMPUTE_RTT_MS", "Cluster", "ProtocolConfig",
    "CommitProtocol", "Transport", "TxnContext",
    "register", "get_protocol", "registered_protocols",
    "rtt_table", "predicted_caller_latency_ms", "measured_caller_latency_ms",
    "SIMULATED_RTT_ROWS",
    "RegionTopology", "INTRA_ZONE", "CROSS_ZONE", "CROSS_REGION",
    "ReplicatedStore", "ReplicatedSimStorage", "ReplicaLog", "merge_reads",
    "DelayedMemoryStore", "DelayedReplicatedStore",
    "QuorumUnavailable", "StoreLease", "MembershipConfig",
    "BatchConfig", "BatchingStore", "GroupCommitIngress",
    "DecisionCacheConfig", "DecisionIndex", "AdaptiveTimeouts", "EwmaStat",
    "LeaseKeeper", "ThreadControlPlane",
    "StoreConfig", "build_store", "get_store",
    "register_store", "registered_stores",
    "FaultSchedule", "Nemesis", "LinkChaos", "NetPartition", "ClockSkew",
    "TornWrite", "CrashRestart", "BitFlip", "TornTail", "Truncation",
    "RetryPolicy", "CircuitBreaker",
    "GuardedStorage", "ChaosStore", "write_repro_bundle",
    "load_repro_bundle",
    "HistoryOp", "HistoryRecorder", "Violation", "check_history",
    "check_run", "collect_decisions",
    "CorruptRecord", "GcEntry", "LifecycleConfig",
    "encode_record", "decode_record",
]
