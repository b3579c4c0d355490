"""Sundial-like distributed transaction substrate (paper §5.1).

Partitioned store with per-partition NO-WAIT 2PL lock tables, a closed-loop
transaction executor running on the discrete-event sim, and the paper's two
workloads (YCSB with zipfian skew, TPC-C NewOrder/Payment).

The port's copy of ``repro/txn/__init__.py`` (the standard library only;
the port imports nothing of the JAX package), which also exports the
wall-clock commit harness (``threaded``).
"""
from .store import LockTable, LockMode
from .workload import (GeoYCSBWorkload, TPCCWorkload, YCSBWorkload,
                       zipf_sampler)
from .executor import (AdaptiveTimeouts, BenchConfig, BenchResult,
                       median_of_trials, run_bench)
from .threaded import (WALLCLOCK_BACKENDS, WallclockConfig, WallclockResult,
                       commit_txn, run_wallclock, wallclock_rows)

__all__ = ["LockTable", "LockMode", "YCSBWorkload", "TPCCWorkload",
           "GeoYCSBWorkload",
           "zipf_sampler", "BenchConfig", "BenchResult", "run_bench",
           "median_of_trials", "AdaptiveTimeouts",
           "WALLCLOCK_BACKENDS", "WallclockConfig", "WallclockResult",
           "commit_txn", "run_wallclock", "wallclock_rows"]
