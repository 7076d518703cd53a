"""Device meshes (``repro/launch/mesh.py``) over the process group that
exists: functions, so importing this module touches no device and no
group. A caller (or ``torchrun``) makes the group; the dry run makes a
``fake`` one of 256 or 512 ranks.

Each mesh also gets its flattened sub-meshes (every set of two or more of
its dims), so that DTensor reduces a partial sum spread over several mesh
dims in one collective over them, not in one per dim, whose order could
differ from rank to rank.
"""
from __future__ import annotations

import itertools
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.device import resolve_device


def with_flattened(mesh):
    """``mesh`` with a flattened sub-mesh for every set of two or more of
    its dims (every rank of the group calls it)."""
    names = mesh.mesh_dim_names
    for n in range(2, len(names) + 1):
        for dims in itertools.combinations(names, n):
            mesh[dims]._flatten()
    return mesh


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` on ``device``'s type
    (the card unless the caller names the CPU), with its flattened
    sub-meshes."""
    device = resolve_device(device)
    return with_flattened(init_device_mesh(device.type, tuple(shape),
                                            mesh_dim_names=tuple(names)))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis
    (512). The group must hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device=None):
    """(1, world size) with the production axis names: every rank on the
    ``model`` axis."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: on the card, the current device by
    index, which a worker thread (whose current device is the first
    card) would not otherwise see."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_from_env(kind: str, device=None):
    """The process group from ``torchrun``'s environment and the ``kind``
    mesh over it: ``local`` (1, world size), ``pod`` 16x16 or
    ``multipod`` 2x16x16. On the card NCCL, one rank a device (the rank's
    ``LOCAL_RANK``); gloo only where ``device`` names the CPU. Nothing
    falls back: a group NCCL cannot make raises."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl", device_id=torch.device(
            "cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo")
    if kind == "local":
        return make_local_mesh(device)
    return make_production_mesh(multi_pod=(kind == "multipod"),
                                device=device)


def first_rank(mesh) -> bool:
    """Whether this rank is the mesh's first (or there is no mesh): the
    one that prints."""
    return mesh is None or not any(mesh.get_coordinate())
