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

The model runs on DTensor parameters placed by these rules (the port's
counterpart of the reference's steps under ``use_rules``).  Its
activations pass through ``constrain`` where the reference's do; tensors
that every rank computes whole (positions, the batch) join the mesh
through ``place``; and what runs on each rank's local shards (the
attention, the cache writes) reads them with ``shard_offsets`` and
``to_local`` and wraps its result with ``from_local``.  ``is_dtensor``
tells the paths apart without importing DTensor on a model that never
made one.
"""
from __future__ import annotations

import contextlib
import math
import sys
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
    the identity with no active rules, and for a plain tensor.  A
    parameter is ``frozen`` first."""
    rules = _active()
    if rules is None or not is_dtensor(x):
        return x
    return frozen(x).redistribute(rules.mesh,
                                  rules.placements(axes, x.shape))


def frozen(x):
    """``x``; with grad off, a DTensor that requires grad (a parameter)
    re-wrapped over its own local tensor, which requires none.  Under
    ``inference_mode`` DTensor fails on a parameter both ways: torch 2.11's
    redistribution calls ``detach_``, which DTensor has no rule for, and
    a view (``detach`` too) cannot set an inference tensor's version
    counter."""
    import torch
    if not (is_dtensor(x) and x.requires_grad
            and not torch.is_grad_enabled()):
        return x
    return from_local(x.to_local(), x.device_mesh, x.placements, x.shape)


def current_rules() -> Optional[Rules]:
    return _active()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; False, with nothing imported, in a
    process that never imported DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def place(t, axes: Sequence[Optional[str]], like):
    """``t``, which every rank holds whole, on the mesh of the DTensor
    ``like``: replicated (each rank keeps its copy, nothing moves), then
    ``constrain``-ed to ``axes`` (a shard is a local slice).  ``t`` itself
    when ``like`` is not a DTensor; a DTensor ``t`` is only constrained."""
    if not is_dtensor(t):
        if not is_dtensor(like):
            return t
        from torch.distributed.tensor import DTensor, Replicate
        mesh = like.device_mesh
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return constrain(t, axes)


def shard_bounds(shape, mesh, placements):
    """(offsets, sizes) of this rank's shard of a tensor of global
    ``shape`` placed as ``placements``, per dim: each mesh dim in order
    cuts what the ones before it left into ``torch.chunk``-sized pieces
    (DTensor's rule; a ragged last shard may be short or empty)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = mesh.size(mdim), coord[mdim]
            full = -(-size[p.dim] // n)
            lo = min(size[p.dim], full * c)
            off[p.dim] += lo
            size[p.dim] = min(size[p.dim], full * (c + 1)) - lo
    return tuple(off), tuple(size)


def shard_offsets(x) -> Tuple[int, ...]:
    """The global index of the first element of this rank's shard of the
    DTensor ``x``, per dim."""
    return shard_bounds(x.shape, x.device_mesh, x.placements)[0]


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous strides) whose shard on
    this rank is ``local``, placed as ``placements``; no check and no
    communication."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


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
