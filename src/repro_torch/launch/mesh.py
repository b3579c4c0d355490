"""Production and host meshes as ``torch.distributed`` DeviceMeshes (port
of ``repro.launch.mesh``).

The production shapes are the reference's: 16 x 16 ("data", "model"), and
2 x 16 x 16 ("pod", "data", "model") for the multi-pod layout.  A
DeviceMesh spans the ranks of the default process group, so each function
needs one of the mesh's size initialized first
(``torch.distributed.init_process_group``; nothing on one machine tells a
program of a cluster, so the caller gives it the address, world size and
rank).  Both default to the card, as every entry point of the port does.
The reference's ``auto_axis_types_kwargs`` shims jax versions without
``AxisType``; a DeviceMesh has no axis types, so it has no counterpart.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Tuple

from ..device import resolve

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> "DeviceMesh":
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve(device_type).type
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh over {names} needs a process group of {n} "
            f"ranks, and "
            + ("none is initialized" if world is None else
               f"the initialized one has {world}")
            + ": call torch.distributed.init_process_group first")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> "DeviceMesh":
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> "DeviceMesh":
    """(world // model, model) over ("data", "model"): every rank of the
    current process group."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{world} ranks")
    return _mesh(device_type, (max(world, 1) // model, model),
                 ("data", "model"))
