"""The transaction layer of the port: the wall-clock commit harness
(``threaded``), whose ``commit_txn`` replays each protocol's Table-3 write
choreography against a threaded store.  The JAX package's discrete-event
executor, workloads and lock table (``executor``, ``workload``, ``store``)
are not ported yet (ROADMAP Queue 1 item 10)."""
from .threaded import (WALLCLOCK_BACKENDS, WallclockConfig, WallclockResult,
                       commit_txn, run_wallclock)

__all__ = ["WALLCLOCK_BACKENDS", "WallclockConfig", "WallclockResult",
           "commit_txn", "run_wallclock"]
