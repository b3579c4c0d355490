"""Pluggable commit-protocol API.

The port's copy of ``repro/core/protocols/__init__.py`` (the standard
library only; the port imports nothing of the JAX package).

Layers:
  transport  – Transport (messaging / liveness / slots) + ProtocolConfig
  context    – TxnContext (per-txn bookkeeping, outcomes, executor hooks)
  base       – CommitProtocol strategy interface (roles + hooks)
  registry   – register("name") / get_protocol(name)

Protocol strategies (one per Table-3 family member):
  cornus, 2pc, cl, cornus-opt1, paxos-commit
"""
from .transport import ProtocolConfig, Transport
from .context import TxnContext
from .base import CommitProtocol
from .registry import get_protocol, register, registered_protocols

# Importing the implementations populates the registry.
from .cornus import CornusProtocol
from .twopc import TwoPCProtocol
from .coordinator_log import CoordinatorLogProtocol
from .cornus_opt1 import CornusOpt1Protocol
from .paxos_commit import PaxosCommitProtocol

__all__ = [
    "ProtocolConfig", "Transport", "TxnContext", "CommitProtocol",
    "get_protocol", "register", "registered_protocols",
    "CornusProtocol", "TwoPCProtocol", "CoordinatorLogProtocol",
    "CornusOpt1Protocol", "PaxosCommitProtocol",
]
