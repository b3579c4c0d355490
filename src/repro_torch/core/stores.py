"""Unified store registry: one ``StoreConfig`` for the threaded backends.

The port's copy of ``repro/core/stores.py``, cut to what the port builds.
Backends register under a NAME, ``StoreConfig`` carries the knobs the
builders read, and ``build_store`` constructs the store.

Registered backends:

  memory          – ``MemoryStore``              (threaded, single node)
  file            – ``FileStore``                (threaded, needs ``root``)
  replicated      – ``ReplicatedStore``          (threaded, quorum Paxos)

Each optionally wraps in a ``BatchingStore`` group-commit decorator
(``batching=True``).

The JAX package's simulated backends (``sim``, ``replicated-sim``), their
knobs (latency model, batching, topology, placement, leader mode, timeouts,
leases) and the ``chaos_*`` knobs of its ``ChaosStore`` wrap are not here:
they come with the discrete-event services (ROADMAP Queue 1 item 10).
``is_simulated`` still names the two simulated backends, so that callers
that refuse them (``serve.session.build_session_store``) refuse them as in
the JAX package; ``build_store`` does not know them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from .control import DecisionCacheConfig
from .lifecycle import LifecycleConfig
from .storage import (BatchingStore, DelayedMemoryStore,
                      DelayedReplicatedStore, FileStore, MemoryStore,
                      ReplicatedStore)


@dataclass
class StoreConfig:
    """Union of the threaded backends' knobs; unknown-to-a-backend fields
    are simply unread.  Each field has the name and default of the JAX
    package's ``StoreConfig``."""

    backend: str = "memory"            # any name in the registry
    seed: int = 0
    # Control plane (decision cache / singleflight / push) — consumed by
    # every backend through the shared core in ``control``.
    decisions: Optional[DecisionCacheConfig] = None
    # Replicated backend.
    replication: int = 3
    max_rounds: int = 256              # threaded proposer retry bound
    # Initial member ids (defaults to range(replication)); the live set can
    # then change via add_replica/remove_replica/set_replication.
    membership: Optional[Sequence[int]] = None
    # file backend.
    root: Optional[str] = None
    # Threaded group-commit decorator.
    batching: bool = False
    window_s: float = 0.0
    max_batch: int = 64
    # Injected per-op service time for wall-clock harnesses (memory /
    # replicated backends only): the sleep sits inside the op, under the
    # control plane, so cache hits and singleflight joiners skip it.
    # 0 (the default) constructs the plain store — bit-identical.
    service_delay_ms: float = 0.0
    # Durable-state lifecycle (checksummed records, GC watermark, scrub).
    # None (the default) keeps every backend bit-identical; accepts a
    # LifecycleConfig or a plain dict (repro-bundle JSON).
    lifecycle: Optional[object] = None


_REGISTRY: Dict[str, Callable] = {}
_SIMULATED = {"sim", "replicated-sim"}   # the JAX package's, not ported


def register_store(name: str):
    """Class/function decorator: register a builder under ``name``.

    A builder is ``fn(cfg: StoreConfig) -> store``."""
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
    """True for the JAX package's discrete-event backends (not built
    here); otherwise the name must be registered."""
    if name in _SIMULATED:
        return True
    get_store(name)                    # validate, same error surface
    return False


def build_store(cfg: StoreConfig):
    """Construct the configured backend (and, with ``batching=True``, wrap
    it in the group-commit decorator)."""
    store = get_store(cfg.backend)(cfg)
    if cfg.batching:
        store = BatchingStore(store, window_s=cfg.window_s,
                              max_batch=cfg.max_batch)
    return store


# --------------------------------------------------------------------------
# Builders — each constructs with EXACTLY the kwargs direct call sites
# always passed, so switching to the factory is bit-identical.
# --------------------------------------------------------------------------
@register_store("memory")
def _build_memory(cfg: StoreConfig):
    lc = LifecycleConfig.coerce(cfg.lifecycle)
    if cfg.service_delay_ms > 0:
        return DelayedMemoryStore(cfg.service_delay_ms / 1e3,
                                  decisions=cfg.decisions, lifecycle=lc)
    return MemoryStore(decisions=cfg.decisions, lifecycle=lc)


@register_store("file")
def _build_file(cfg: StoreConfig):
    if cfg.root is None:
        raise ValueError("file backend needs StoreConfig.root")
    return FileStore(cfg.root, decisions=cfg.decisions,
                     lifecycle=LifecycleConfig.coerce(cfg.lifecycle))


@register_store("replicated")
def _build_replicated(cfg: StoreConfig):
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

