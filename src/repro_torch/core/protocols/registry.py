"""Commit-protocol registry: protocol names → strategy classes.

The port's copy of ``repro/core/protocols/registry.py`` (the standard
library only; the port imports nothing of the JAX package).

The transaction layer never branches on protocol names; it resolves the
configured name here and hands the class the shared Transport / TxnContext /
storage wiring.  Adding a Table-3 row is therefore:

    @register("my-variant")
    class MyVariant(CornusProtocol):
        ...override the relevant role hooks...

and ``BenchConfig(protocol="my-variant")`` works everywhere.
"""
from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, type] = {}


def register(name: str) -> Callable[[type], type]:
    """Class decorator registering a CommitProtocol under ``name``."""

    def deco(cls: type) -> type:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_protocol(name: str) -> type:
    """Resolve a protocol name to its strategy class (KeyError if unknown)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown commit protocol {name!r}; registered: "
            f"{registered_protocols()}") from None


def registered_protocols() -> List[str]:
    return sorted(_REGISTRY)
