"""The port's commit core: its copies of ``repro.core``'s state
vocabulary, control plane, record lifecycle, discrete-event kernel
(``sim``), commit protocols (``protocols``), threaded stores (``storage``:
memory, file, replicated, delayed and batching) and store factory
(``stores``).  The JAX package's simulated storage services, ``Cluster``
facade (``protocol``), Table-3 variants, chaos plane and history checker
are not here (ROADMAP Queue 1 item 10)."""
from .sim import Sim
from .state import Decision, TxnOutcome, TxnSpec, Vote, global_decision
from .control import (AdaptiveTimeouts, DecisionCacheConfig, DecisionIndex,
                      EwmaStat, LeaseKeeper, QuorumUnavailable,
                      ThreadControlPlane)
from .storage import (AZURE_BLOB, AZURE_BLOB_SEPARATE_ACL, AZURE_REDIS,
                      COMPUTE_RTT_MS, CROSS_REGION, CROSS_ZONE, INTRA_ZONE,
                      SLOW_REDIS, BatchingStore,
                      DelayedMemoryStore, DelayedReplicatedStore, FileStore,
                      LatencyModel, MembershipConfig, MemoryStore,
                      RegionTopology, ReplicaLog, ReplicatedStore,
                      StoreLease, merge_reads)
from .stores import (StoreConfig, build_store, get_store,
                     register_store, registered_stores)
from .lifecycle import (CorruptRecord, GcEntry, LifecycleConfig,
                        decode_record, encode_record)
from .protocols import (CommitProtocol, ProtocolConfig, Transport,
                        TxnContext, get_protocol, register,
                        registered_protocols)

__all__ = [
    "Sim", "Decision", "TxnOutcome", "TxnSpec", "Vote", "global_decision",
    "MemoryStore", "FileStore", "LatencyModel",
    "AZURE_REDIS", "AZURE_BLOB", "AZURE_BLOB_SEPARATE_ACL", "SLOW_REDIS",
    "COMPUTE_RTT_MS", "ProtocolConfig",
    "CommitProtocol", "Transport", "TxnContext",
    "register", "get_protocol", "registered_protocols",
    "RegionTopology", "INTRA_ZONE", "CROSS_ZONE", "CROSS_REGION",
    "ReplicatedStore", "ReplicaLog", "merge_reads",
    "DelayedMemoryStore", "DelayedReplicatedStore",
    "QuorumUnavailable", "StoreLease", "MembershipConfig",
    "BatchingStore",
    "DecisionCacheConfig", "DecisionIndex", "AdaptiveTimeouts", "EwmaStat",
    "LeaseKeeper", "ThreadControlPlane",
    "StoreConfig", "build_store", "get_store",
    "register_store", "registered_stores",
    "CorruptRecord", "GcEntry", "LifecycleConfig",
    "encode_record", "decode_record",
]
