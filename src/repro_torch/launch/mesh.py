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

``make_layout_mesh`` gives the production layouts with no process group
of their size, for the dry run (``launch.dryrun``), which places meta
tensors and so needs the mesh's shape, names and this rank's coordinate,
and no communicator.  ``counting_mesh`` gives one over a process group of
the layout's size whose collectives move nothing, for the dry run's count
of the collectives that a step on DTensors issues.
"""
from __future__ import annotations

import contextlib
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


def make_layout_mesh(*, multi_pod: bool = False) -> "DeviceMesh":
    """The production layout as a ``layout_mesh``: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return layout_mesh((2, 16, 16), ("pod", "data", "model"))
    return layout_mesh((16, 16), ("data", "model"))


def layout_mesh(shape: Tuple[int, ...],
                names: Tuple[str, ...]) -> "DeviceMesh":
    """A CPU DeviceMesh of ``shape`` built over a process group of one: no
    backend is created for the mesh's dims, so nothing of the mesh's size
    is initialized, and this process is rank 0 of the layout.  Without an
    initialized group it starts a one-rank gloo group on an in-memory
    ``HashStore`` for the build and destroys it before it returns: the
    mesh keeps its shape, names and coordinate, which is all that
    ``Rules`` and the meta DTensors read, and the process is left as it
    was found.  The route rests on DeviceMesh's private
    ``_init_backend=False`` argument (checked by
    tests/test_torch_dryrun.py)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        if dist.get_rank() != 0:
            raise RuntimeError("a layout mesh is built on rank 0 only")
        return DeviceMesh("cpu",
                          torch.arange(math.prod(shape)).reshape(shape),
                          mesh_dim_names=tuple(names), _init_backend=False)
    finally:
        if started:
            dist.destroy_process_group()


COUNTING_BACKEND = "layout"


def _register_counting_backend() -> None:
    """The ``COUNTING_BACKEND`` process group: torch's ``FakeProcessGroup``
    (every collective returns at once, nothing moves), registered here
    under a name of its own, since the package may not import
    ``torch.testing``, which registers it as "fake"."""
    import torch.distributed as dist
    if hasattr(dist.Backend, COUNTING_BACKEND.upper()):
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        rank, size = common_opts.group_rank, common_opts.group_size
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(rank, size, backend_opts)
        return FakeProcessGroup(rank, size)

    dist.Backend.register_backend(COUNTING_BACKEND, create,
                                  extended_api=True, devices=["cpu"])


@contextlib.contextmanager
def counting_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A CPU DeviceMesh of ``shape`` over a process group of its size whose
    collectives move nothing (``COUNTING_BACKEND``), with this process as
    rank 0.  DTensor ops on ``meta`` tensors over it issue the functional
    collectives that rank 0 of a real run of that size would, which a
    dispatch mode can count.  The group is started on an in-memory
    ``HashStore`` and destroyed on exit; it needs none initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        raise RuntimeError("a counting mesh starts its own process group: "
                           "destroy the initialized one first")
    _register_counting_backend()
    dist.init_process_group(COUNTING_BACKEND, store=dist.HashStore(),
                            rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()
