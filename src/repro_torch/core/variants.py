"""Table-3 deployment rows + the analytical RTT model (§5.6, extended §6).

The port's copy of ``repro/core/variants.py`` (the standard library only;
the port imports nothing of the JAX package).

The protocol *implementations* live in ``protocols`` (one
registered strategy class per family member).  This module keeps:

* ``rtt_table()`` — the analytical RTT model of Table 3 for protocols
  integrating with Paxos-replicated storage.
* ``SIMULATED_RTT_ROWS`` — every Table-3 row's runnable deployment:
  (registered protocol name, replicated-storage mode).
* ``measured_caller_latency_ms()`` — runs one commit per row on the
  discrete-event sim and must land EXACTLY on the analytic RTT multiple.
"""
from __future__ import annotations

from typing import Dict

from .protocol import Cluster, ProtocolConfig
from .state import Decision, TxnSpec


def rtt_table() -> Dict[str, Dict]:
    """Table 3: RTTs on the critical path when storage is Paxos-replicated.

    Counted from coordinator starting the protocol until the decision can be
    returned to the caller, as `prepare + commit = total` RTTs.
    """
    rows = {
        "2pc": dict(prepare=3.0, commit=2.0,
                    requires=[]),
        "cornus": dict(prepare=3.0, commit=0.0,
                       requires=["storage supports conditional write"]),
        "cornus-opt1": dict(prepare=2.5, commit=0.0,
                            requires=["paxos leader forwards to coordinator"]),
        "2pc-coloc": dict(prepare=2.0, commit=1.0,
                          requires=["participant coordinates replication"]),
        "cornus-coloc": dict(prepare=2.0, commit=0.0,
                             requires=["participant coordinates replication"]),
        "paxos-commit": dict(prepare=1.5, commit=0.0,
                             requires=["participant coordinates replication",
                                       "acceptors forward to coordinator"]),
    }
    for r in rows.values():
        r["total"] = r["prepare"] + r["commit"]
    return rows


def predicted_caller_latency_ms(protocol: str, paxos_rtt_ms: float) -> float:
    """Caller latency predicted by Table 3 given one inter-replica RTT."""
    return rtt_table()[protocol]["total"] * paxos_rtt_ms


# Every Table-3 row now has a runnable simulated deployment:
# row name -> (registered protocol name, replicated-storage mode).
SIMULATED_RTT_ROWS = {
    "2pc": ("2pc", "leader"),
    "cornus": ("cornus", "leader"),
    "cornus-opt1": ("cornus-opt1", "leader"),
    "2pc-coloc": ("2pc", "coloc"),
    "cornus-coloc": ("cornus", "coloc"),
    "paxos-commit": ("paxos-commit", "coloc"),
}


def measured_caller_latency_ms(protocol: str, paxos_rtt_ms: float,
                               n_participants: int = 2,
                               n_replicas: int = 3,
                               seed: int = 0,
                               batch_window_ms: float = 0.0,
                               storm_control: bool = False) -> float:
    """Measured counterpart of ``predicted_caller_latency_ms``.

    Runs ONE commit on the discrete-event sim against a quorum-replicated
    store under a uniform topology where every link (compute↔compute,
    compute↔storage, inter-replica) costs ``paxos_rtt_ms`` and service
    times are ZERO — so the result lands exactly on Table 3's RTT
    multiples (validated with equality, not a tolerance, in the tests).

    ``batch_window_ms`` threads the storage-ingress group-commit window
    through: 0 (the default) is the exact passthrough the equality check
    runs against; a positive window exercises the batched fast path (adds
    up to one window of queueing delay to each logged vote).

    ``storm_control`` enables the full termination-storm stack (storage
    decision cache + singleflight + push, compute-side termination dedup)
    — on the no-failure critical path NONE of it may fire, so the measured
    latency must stay EXACTLY on the Table-3 prediction (tested).
    """
    from .sim import Sim
    from .storage import (BatchConfig, DecisionCacheConfig, LatencyModel,
                          RegionTopology, ReplicatedSimStorage)

    if protocol not in SIMULATED_RTT_ROWS:
        raise ValueError(f"no simulated deployment for {protocol!r}; "
                         f"one of {sorted(SIMULATED_RTT_ROWS)}")
    proto, mode = SIMULATED_RTT_ROWS[protocol]
    topo = RegionTopology.uniform("table3", ("r0",), paxos_rtt_ms)
    model = LatencyModel("paxos-null", conditional_write_ms=0.0,
                         plain_write_ms=0.0, read_ms=0.0, jitter=0.0)
    sim = Sim()
    storage = ReplicatedSimStorage(
        sim, model, n_replicas=n_replicas, seed=seed, topology=topo,
        mode=mode, batch=BatchConfig(window_ms=batch_window_ms,
                                     serial=batch_window_ms > 0),
        decisions=DecisionCacheConfig(cache=storm_control,
                                      singleflight=storm_control,
                                      push=storm_control))
    nodes = ["c"] + [f"p{i}" for i in range(n_participants)]
    tmo = 50.0 * paxos_rtt_ms
    cfg = ProtocolConfig(protocol=proto, topology=topo,
                         vote_timeout_ms=tmo, decision_timeout_ms=tmo,
                         votereq_timeout_ms=tmo, termination_retry_ms=tmo,
                         coop_retry_ms=tmo,
                         push_decisions=storm_control,
                         termination_dedup=storm_control)
    cl = Cluster(sim, storage, nodes, cfg)
    # Pure coordinator (owns no partition) — Table 3's accounting.
    spec = TxnSpec(txn_id="t3", coordinator="c",
                   participants=[n for n in nodes if n != "c"])
    cl.run_txn(spec)
    sim.run(until=1000.0 * paxos_rtt_ms)
    out = cl.outcomes[("t3", "c")]
    assert out.decision == Decision.COMMIT, out
    return out.caller_latency_ms
