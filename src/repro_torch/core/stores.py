"""Unified store registry: one ``StoreConfig`` for both backends.

The port's copy of ``repro/core/stores.py`` (the standard library only; the
port imports nothing of the JAX package).

The simulated services (``SimStorage`` / ``ReplicatedSimStorage``) and the
threaded stores (``MemoryStore`` / ``FileStore`` / ``ReplicatedStore``) grew
divergent constructor signatures; every bench and test picked a backend by
importing a class and hand-threading its kwargs.  This module mirrors
``protocols.registry``: backends register under a NAME, ``StoreConfig``
carries the union of knobs (each backend reads the subset it understands,
exactly the kwargs it always took), and ``build_store`` constructs the
store — so ``BenchConfig`` selects storage backends the way it selects
protocols.

Registered backends:

  memory          – ``MemoryStore``              (threaded, single node)
  file            – ``FileStore``                (threaded, needs ``root``)
  replicated      – ``ReplicatedStore``          (threaded, quorum Paxos)
  sim             – ``SimStorage``               (needs ``sim=``)
  replicated-sim  – ``ReplicatedSimStorage``     (needs ``sim=``)

Threaded backends optionally wrap in a ``BatchingStore`` group-commit
decorator (``batching=True``); simulated backends batch via ``BatchConfig``
as before.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from .control import DecisionCacheConfig
from .lifecycle import LifecycleConfig
from .storage import (AZURE_REDIS, BatchConfig, BatchingStore,
                      DelayedMemoryStore, DelayedReplicatedStore, FileStore,
                      LatencyModel, MemoryStore, RegionTopology,
                      ReplicatedSimStorage, ReplicatedStore, SimStorage)


@dataclass
class StoreConfig:
    """Union of every backend's knobs; unknown-to-a-backend fields are
    simply unread (the same contract ``BenchConfig`` has with protocols)."""

    backend: str = "memory"            # any name in the registry
    seed: int = 0
    # Control plane (decision cache / singleflight / push) — consumed by
    # every backend through the shared core in ``control``.
    decisions: Optional[DecisionCacheConfig] = None
    # Replicated backends (threaded and sim).
    replication: int = 3
    max_rounds: int = 256              # threaded proposer retry bound
    # Initial member ids (defaults to range(replication)); the live set can
    # then change via add_replica/remove_replica/set_replication.
    membership: Optional[Sequence[int]] = None
    # file backend.
    root: Optional[str] = None
    # Simulated services.
    model: Optional[LatencyModel] = None
    batch: Optional[BatchConfig] = None
    topology: Optional[RegionTopology] = None
    replica_regions: Optional[Sequence[str]] = None
    placement: Optional[Mapping[str, str]] = None
    mode: str = "leader"               # leader | coloc
    op_timeout_ms: Optional[float] = None
    lease_ms: float = 200.0
    # Threaded group-commit decorator (sim backends batch via ``batch``).
    batching: bool = False
    window_s: float = 0.0
    max_batch: int = 64
    # Injected per-op service time for wall-clock harnesses (memory /
    # replicated backends only): the sleep sits inside the op, under the
    # control plane, so cache hits and singleflight joiners skip it.
    # 0 (the default) constructs the plain store — bit-identical.
    service_delay_ms: float = 0.0
    # Threaded-store chaos decorator (core.chaos.ChaosStore): per-op
    # injected delay/jitter and drop→retry with exponential backoff.
    # Both 0 (the default) skips the wrapper entirely — bit-identical.
    chaos_drop_p: float = 0.0
    chaos_delay_ms: float = 0.0
    chaos_jitter_ms: float = 0.0
    # Durable-state lifecycle (checksummed records, GC watermark, scrub).
    # None (the default) keeps every backend bit-identical; accepts a
    # LifecycleConfig or a plain dict (repro-bundle JSON).
    lifecycle: Optional[object] = None


_REGISTRY: Dict[str, Callable] = {}
_SIMULATED = {"sim", "replicated-sim"}


def register_store(name: str):
    """Class/function decorator: register a builder under ``name``.

    A builder is ``fn(cfg: StoreConfig, sim) -> store``; ``sim`` is None
    for threaded backends."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_store(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown store backend {name!r} "
                       f"(registered: {known})") from None


def registered_stores() -> List[str]:
    return sorted(_REGISTRY)


def is_simulated(name: str) -> bool:
    """True if the backend runs inside the discrete-event sim (its builder
    requires ``sim=`` and its ops return sim Events)."""
    get_store(name)                    # validate, same error surface
    return name in _SIMULATED


def build_store(cfg: StoreConfig, sim=None):
    """Construct the configured backend (and, for threaded backends with
    ``batching=True``, wrap it in the group-commit decorator)."""
    builder = get_store(cfg.backend)
    simulated = is_simulated(cfg.backend)
    if simulated and sim is None:
        raise ValueError(f"backend {cfg.backend!r} needs sim= "
                         f"(it runs inside the discrete-event simulator)")
    store = builder(cfg, sim)
    if cfg.batching and not simulated:
        store = BatchingStore(store, window_s=cfg.window_s,
                              max_batch=cfg.max_batch)
    if not simulated and (cfg.chaos_drop_p > 0 or cfg.chaos_delay_ms > 0
                          or cfg.chaos_jitter_ms > 0):
        from .chaos import ChaosStore
        store = ChaosStore(store, seed=cfg.seed, drop_p=cfg.chaos_drop_p,
                           delay_ms=cfg.chaos_delay_ms,
                           jitter_ms=cfg.chaos_jitter_ms)
    return store


# --------------------------------------------------------------------------
# Builders — each constructs with EXACTLY the kwargs direct call sites
# always passed, so switching to the factory is bit-identical.
# --------------------------------------------------------------------------
@register_store("memory")
def _build_memory(cfg: StoreConfig, sim=None):
    lc = LifecycleConfig.coerce(cfg.lifecycle)
    if cfg.service_delay_ms > 0:
        return DelayedMemoryStore(cfg.service_delay_ms / 1e3,
                                  decisions=cfg.decisions, lifecycle=lc)
    return MemoryStore(decisions=cfg.decisions, lifecycle=lc)


@register_store("file")
def _build_file(cfg: StoreConfig, sim=None):
    if cfg.root is None:
        raise ValueError("file backend needs StoreConfig.root")
    return FileStore(cfg.root, decisions=cfg.decisions,
                     lifecycle=LifecycleConfig.coerce(cfg.lifecycle))


@register_store("replicated")
def _build_replicated(cfg: StoreConfig, sim=None):
    lc = LifecycleConfig.coerce(cfg.lifecycle)
    if cfg.service_delay_ms > 0:
        return DelayedReplicatedStore(cfg.service_delay_ms / 1e3,
                                      n_replicas=cfg.replication,
                                      seed=cfg.seed,
                                      max_rounds=cfg.max_rounds,
                                      decisions=cfg.decisions,
                                      membership=cfg.membership,
                                      lifecycle=lc)
    return ReplicatedStore(n_replicas=cfg.replication, seed=cfg.seed,
                           max_rounds=cfg.max_rounds,
                           decisions=cfg.decisions,
                           membership=cfg.membership,
                           lifecycle=lc)


@register_store("sim")
def _build_sim(cfg: StoreConfig, sim=None):
    return SimStorage(sim, cfg.model or AZURE_REDIS, seed=cfg.seed,
                      batch=cfg.batch, decisions=cfg.decisions,
                      lifecycle=LifecycleConfig.coerce(cfg.lifecycle))


@register_store("replicated-sim")
def _build_replicated_sim(cfg: StoreConfig, sim=None):
    return ReplicatedSimStorage(
        sim, cfg.model or AZURE_REDIS, n_replicas=cfg.replication,
        seed=cfg.seed, topology=cfg.topology,
        replica_regions=cfg.replica_regions,
        placement=cfg.placement, mode=cfg.mode,
        op_timeout_ms=cfg.op_timeout_ms, batch=cfg.batch,
        lease_ms=cfg.lease_ms, decisions=cfg.decisions,
        membership=cfg.membership,
        lifecycle=LifecycleConfig.coerce(cfg.lifecycle))
