"""The commit core that the checkpoint commit needs: the port's copies of
``repro.core``'s state vocabulary, control plane, record lifecycle and the
two threaded stores (``MemoryStore``, ``FileStore``).  The JAX package's
simulator, chaos plane, protocols and replicated stores are not here."""
from .state import Decision, TxnOutcome, TxnSpec, Vote, global_decision
from .control import (AdaptiveTimeouts, DecisionCacheConfig, DecisionIndex,
                      EwmaStat, LeaseKeeper, QuorumUnavailable,
                      ThreadControlPlane)
from .storage import (AZURE_BLOB, AZURE_BLOB_SEPARATE_ACL, AZURE_REDIS,
                      COMPUTE_RTT_MS, SLOW_REDIS, FileStore, LatencyModel,
                      MemoryStore)
from .lifecycle import (CorruptRecord, GcEntry, LifecycleConfig,
                        decode_record, encode_record)

__all__ = [
    "Decision", "TxnOutcome", "TxnSpec", "Vote", "global_decision",
    "MemoryStore", "FileStore", "LatencyModel",
    "AZURE_REDIS", "AZURE_BLOB", "AZURE_BLOB_SEPARATE_ACL", "SLOW_REDIS",
    "COMPUTE_RTT_MS",
    "QuorumUnavailable", "DecisionCacheConfig", "DecisionIndex",
    "AdaptiveTimeouts", "EwmaStat", "LeaseKeeper", "ThreadControlPlane",
    "CorruptRecord", "GcEntry", "LifecycleConfig",
    "encode_record", "decode_record",
]
