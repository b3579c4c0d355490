"""Logical-axis rules over a ``torch.distributed`` device mesh (the part of
``repro.launch.sharding`` that the expert-parallel MoE reads).

Model code names tensor dims with *logical* axes; ``Rules`` maps them onto
the named dims of a ``DeviceMesh``.  Two names are carried, as the JAX
package's ``Rules.__post_init__`` builds them:
  batch   -> (pod, data)     the token (data-parallel) axes
  expert  -> model           expert parallel
``use_rules`` makes a rule set current for the calling thread and
``current_rules`` reads it; with none active the model runs on one
device, as every single-process entry point does.

The two names are fixed by the mesh: there is no override of them, so
"batch" and "expert" never share a mesh dim.  The rest of the JAX module
(``spec``, ``constrain``, the profiles and their overrides, FSDP weight
sharding) is not ported.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Optional, Tuple

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

_STATE = threading.local()


def _active() -> Optional["Rules"]:
    return getattr(_STATE, "rules", None)


@dataclass
class Rules:
    mesh: "DeviceMesh"
    logical: Dict[str, Tuple[str, ...]] = field(init=False)

    def __post_init__(self):
        axes = tuple(self.mesh.mesh_dim_names or ())
        self.logical = {
            "batch": tuple(a for a in ("pod", "data") if a in axes),
            "expert": ("model",) if "model" in axes else (),
        }
        self.sizes = dict(zip(axes, self.mesh.shape))

    def axis_size(self, logical_name: str) -> int:
        return math.prod(self.sizes[a]
                         for a in self.logical.get(logical_name, ()))


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = _active()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[Rules]:
    return _active()
