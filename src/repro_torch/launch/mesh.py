"""Device meshes over the ranks of the default ``torch.distributed``
group (the reference's ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  The group must exist first: ``torchrun``'s, or the dry
run's ``fake`` group (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import math

import torch.distributed as dist

# the device type DeviceMesh places each process group's ranks on
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu", "fake": "cpu"}


def make_mesh(shape, axes):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``shape``
    with axis names ``axes`` over every rank of the default group, rank r
    at the row-major position r.  Refuses a world that is not
    ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the default group has {world}")
    backend = str(dist.get_backend())
    return init_device_mesh(_BACKEND_DEVICE.get(backend, "cpu"), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes: (data=16, model=16) over 256
    ranks, or (pod=2, data=16, model=16) over 512.  These are the shapes
    of the reference's TPU v5e pod (a 16x16 torus) and of two such pods;
    no H100 cluster of that shape was ever measured, and the mesh needs a
    default group of that size, which only the dry run's ``fake`` group
    has on one machine.

    The two pods' data axes fold into one ``data`` axis of 32, row-major,
    as ``launch/train.py::gspmd_mesh_shape`` folds them: the sharding
    rules split a dim over both or neither, so every rank holds the same
    shard, and DTensor plans each redistribution of a dim split over two
    mesh dims by a search over placements that made a 2x16x16 training
    step take over ten times the 16x16 one."""
    shape = (32, 16) if multi_pod else (16, 16)
    return make_mesh(shape, ("data", "model"))
