"""Device mesh: the ("dp", "mp") grid of ranks, one rank per device.

Port of the JAX package's ``parallel/mesh.py`` on ``torch.distributed``:

  dp — data parallel: batch rows of users; gradients are summed across it
  mp — model parallel: the item-catalog axis; it shards the catalog-sized
       parameters (the item and user tables, the towers' catalog-wide first
       weights, the frozen LightGCN tables) and the eval step's top-k.

A JAX process owns several devices; a torch rank owns one, so a mesh of
(dp, mp) is a world of dp * mp processes. Rank r sits at (r // mp, r % mp):
the mp ranks of one dp group are consecutive. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ("dp", "mp"); the
helpers below read its shape, a rank's coordinates and the process group of
an axis.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("dp", "mp")


def make_mesh(dp: int = 1, mp: int = 1, device_type: str = "cpu"):
    """The (dp, mp) DeviceMesh over the whole world, which must hold exactly
    dp * mp ranks (``multihost.initialize`` starts it); each axis's group
    raises after the world's collective timeout."""
    from torch.distributed.device_mesh import init_device_mesh

    need = dp * mp
    have = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or have != need:
        raise ValueError(
            f"mesh ({dp},{mp}) needs a world of {need} ranks, one per "
            f"device; this process sees {have if dist.is_initialized() else 'no'}"
            " process group (start one rank per device with "
            "gdmcf_torch.parallel.multihost.initialize)")
    from gdmcf_torch.parallel.multihost import hold_to_timeout

    mesh = init_device_mesh(device_type, (dp, mp), mesh_dim_names=AXES)
    for axis in AXES:   # the axes' groups wait no longer than the world's
        hold_to_timeout(mesh.get_group(axis))
    return mesh


def single_device_mesh(device=None):
    """A (1, 1) mesh on one device. Starts a one-rank process group (an
    in-memory store) when none is running."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cpu" if device is None else device)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo" if dev.type == "cpu" else "nccl",
            store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("single_device_mesh in a world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"dp": size, "mp": size}; None is the single device (1, 1), and a
    {axis: size} dict stands for a mesh of that shape."""
    if mesh is None:
        return {a: 1 for a in AXES}
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: mesh.size(mesh_dim=i) for i, a in enumerate(AXES)}


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's line along ``axis``."""
    return None if mesh is None else mesh.get_group(axis)
