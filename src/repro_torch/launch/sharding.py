"""Logical-axis sharding rules over a ``torch.distributed`` DeviceMesh (port
of ``repro.launch.sharding``).

Model code names tensor dims with *logical* axes ("batch", "model", "fsdp",
"expert", ...); ``Rules`` maps them onto the named dims of a ``DeviceMesh``
with the reference's divisibility rule (a dim smaller than the product of
its mesh axes is left whole, and the refusal is recorded in ``fallbacks``),
and ``constrain`` redistributes a DTensor to the rules' placements: a no-op
unless a rule set is active, so the same code runs on one device and over
a mesh.

Default rule set (the reference's):
  batch   -> (pod, data)     data parallel across pods
  fsdp    -> data            ZeRO-3 weight sharding
  model   -> model           tensor parallel (heads / d_ff / vocab)
  expert  -> model           expert parallel
  kv_seq  -> data            sequence-parallel KV cache (long-context decode)
  cache_seq -> model, cache_seq_full -> (data, model)   decode KV caches

``spec`` gives the reference's ``PartitionSpec`` entries: per tensor dim,
None, a mesh-axis name or a tuple of them, trailing Nones dropped.
``placements`` turns them into DTensor placements, one per mesh dim.  A
tensor dim sharded over several mesh dims is cut by DTensor in mesh-dim
order, the first mesh dim major; JAX cuts in the tuple's order.  The two
agree only while a tuple lists its axes in mesh order, as every rule here
does, so ``placements`` refuses a tuple that does not.  GSPMD pads a dim
that its axes do not divide; DTensor's ``Shard`` leaves the last shards
short instead.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, Optional, Sequence, Tuple,
                    Union)

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

SpecEntry = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


def _active() -> Optional["Rules"]:
    return getattr(_STATE, "rules", None)


@dataclass
class Rules:
    mesh: "DeviceMesh"
    logical: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # Dims we refused to shard (dim < axis size) land here for the report.
    fallbacks: list = field(default_factory=list)

    def __post_init__(self):
        axes = tuple(self.mesh.mesh_dim_names or ())
        base = {
            "batch": tuple(a for a in ("pod", "data") if a in axes),
            "fsdp": ("data",) if "data" in axes else (),
            "model": ("model",) if "model" in axes else (),
            "expert": ("model",) if "model" in axes else (),
            "kv_seq": ("data",) if "data" in axes else (),
            # Decode KV caches: batch takes "data", so the cache's seq dim
            # takes "model" (flash-decode style); at batch=1 (long-context)
            # seq takes BOTH axes.
            "cache_seq": ("model",) if "model" in axes else (),
            "cache_seq_full": tuple(a for a in ("data", "model")
                                    if a in axes),
        }
        base.update(self.logical)
        self.logical = base
        self.sizes = dict(zip(axes, self.mesh.shape))

    def axis_size(self, logical_name: str) -> int:
        return math.prod(self.sizes[a]
                         for a in self.logical.get(logical_name, ()))

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None
             ) -> Tuple[SpecEntry, ...]:
        """The PartitionSpec entries; drop shardings that don't fit the
        dim."""
        used: set = set()
        out: list = []
        for i, name in enumerate(axes):
            if name is None:
                out.append(None)
                continue
            mesh_axes = tuple(a for a in self.logical.get(name, ())
                              if a not in used)
            if not mesh_axes:
                out.append(None)
                continue
            total = math.prod(self.sizes[a] for a in mesh_axes)
            if shape is not None and shape[i] < total:
                self.fallbacks.append((tuple(axes), i, name, shape[i], total))
                out.append(None)
                continue
            used.update(mesh_axes)
            out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """DTensor placements of ``spec(axes, shape)``, one per mesh dim:
        ``Shard(i)`` on each mesh dim that serves tensor dim i, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names or ())
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec(axes, shape)):
            if entry is None:
                continue
            dims = [names.index(a) for a in
                    ((entry,) if isinstance(entry, str) else entry)]
            if dims != sorted(dims):
                raise ValueError(
                    f"tensor dim {i} is sharded over {entry}, not in the "
                    f"mesh's order {tuple(names)}: DTensor would cut it in "
                    f"another order than the rule names")
            for d in dims:
                out[d] = Shard(i)
        return tuple(out)

    def sharding(self, axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None):
        """(mesh, placements): what ``distribute_tensor`` takes."""
        return self.mesh, self.placements(axes, shape)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = _active()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the active rules' placements for ``axes``;
    the identity with no active rules, and for a plain tensor."""
    rules = _active()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(rules.mesh, rules.placements(axes, x.shape))


def current_rules() -> Optional[Rules]:
    return _active()


# Sharding profiles:
#   default — TP on "model", DP+ZeRO-3 on "data" (the baseline table)
#   fsdp    — no tensor parallelism: batch over every axis, weights ZeRO-3
#             over (data, model).  Right answer for small dense models where
#             TP activation all-reduces dwarf FSDP weight gathers.
#   sp      — Megatron-style sequence parallelism: residual stream sharded
#             on seq over the TP axis; converts activation all-reduce into
#             reduce-scatter + all-gather (half the wire bytes).
PROFILES = {
    "default": {},
    "fsdp": {
        "batch": ("pod", "data", "model"),
        "fsdp": ("data", "model"),
        "model": (),
        "expert": (),
        "cache_seq": (),
    },
    "sp": {
        "seq": ("model",),
    },
}


def make_rules(mesh: "DeviceMesh", profile: str = "default") -> Rules:
    overrides = dict(PROFILES[profile])
    if "pod" not in (mesh.mesh_dim_names or ()) and "batch" in overrides:
        overrides["batch"] = tuple(a for a in overrides["batch"]
                                   if a != "pod")
    return Rules(mesh, logical=overrides)
