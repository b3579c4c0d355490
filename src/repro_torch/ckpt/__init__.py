"""Cornus-committed distributed checkpointing (the paper → framework bridge).

A checkpoint epoch is a distributed transaction: every host uploads its shard
set to disaggregated storage, then CAS-writes VOTE-YES into its transaction-
state slot via LogOnce().  The epoch is committed iff ALL hosts' votes are
durable — no coordinator decision record exists (paper §3.1), so a dead
coordinator can never wedge the fleet, and any host (or a restarting job) can
resolve an in-flight epoch in bounded time with the termination protocol.

The port's copy of ``repro.ckpt``: the same commit and restore over the
port's stores, and shards keyed and laid out as the JAX package's, so an
epoch written by either package restores in the other.
"""
from .shards import (ec_decode, ec_encode, pack_tree, partition_leaves,
                     unpack_tree)
from .commit import CheckpointOutcome, CornusCheckpointer
from .restore import fetch_payloads, latest_committed, restore_params

__all__ = ["pack_tree", "unpack_tree", "partition_leaves",
           "ec_encode", "ec_decode",
           "CornusCheckpointer", "CheckpointOutcome", "latest_committed",
           "restore_params", "fetch_payloads"]
