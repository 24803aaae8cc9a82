"""Multi-process runtime: one rank per device, started from the environment.

Port of the JAX package's ``parallel/multihost.py`` on ``torch.distributed``.
Launch one process per rank with the env contract of common launchers

    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=4 PROCESS_ID=<rank> \\
        python -m gdmcf_torch.cli --mesh_dp 2 --mesh_mp 2 ...

and each calls ``initialize()`` before it builds a ``Trainer``. Where the
JAX package has processes that own several devices, a rank here owns one:
"process" in the JAX API means "rank", and the data feed unit is the dp
group (its mp ranks hold the same rows), so ``local_row_range`` shards by
the dp coordinate.

Backends: ``nccl`` for CUDA ranks, ``gloo`` for CPU ranks. ``backend="gloo"``
(or env DIST_BACKEND=gloo) runs CUDA ranks over gloo, which is what several
ranks sharing one card need (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the process group's collective timeout in seconds (initialize sets it)
_TIMEOUT_S: Optional[float] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: int = 300,
               heartbeat_timeout_s: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda") -> bool:
    """``init_process_group`` with env fallbacks; a no-op (False) without a
    coordinator address, i.e. a single-process run.

    Env contract: COORDINATOR_ADDRESS (host:port of rank 0's store),
    NUM_PROCESSES, PROCESS_ID. ``heartbeat_timeout_s`` (env
    HEARTBEAT_TIMEOUT_S) becomes the process group's timeout, and the mesh
    axes' groups get it too (``hold_to_timeout``): a collective waiting on a
    dead or silent peer raises after it instead of hanging; without it the
    timeout is ``timeout_s``. ``backend`` (env DIST_BACKEND) defaults
    to nccl for a ``device`` of cuda and gloo for cpu."""
    global _TIMEOUT_S
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False   # single-process run
    if num_processes is None:
        env = os.environ.get("NUM_PROCESSES")
        if env is None:
            # a silent default of 1 would "succeed" as a solo cluster and
            # train on the FULL dataset while the peers hang — fail loudly
            raise ValueError(
                "COORDINATOR_ADDRESS is set but NUM_PROCESSES is not: a "
                "multi-host launch must state its process count (env "
                "NUM_PROCESSES or the num_processes argument)")
        num_processes = int(env)
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    if heartbeat_timeout_s is None and os.environ.get("HEARTBEAT_TIMEOUT_S"):
        heartbeat_timeout_s = int(os.environ["HEARTBEAT_TIMEOUT_S"])
    backend = backend or os.environ.get("DIST_BACKEND")
    if backend is None:
        backend = "gloo" if str(device).startswith("cpu") else "nccl"
    _TIMEOUT_S = float(heartbeat_timeout_s or timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=_TIMEOUT_S))
    return True


def collective_timeout_s() -> float:
    """How long a collective waits for a peer before it raises: the
    process group's timeout (torch's default of 300 s for a group that
    ``initialize`` did not start)."""
    return 300.0 if _TIMEOUT_S is None else _TIMEOUT_S


def hold_to_timeout(group) -> None:
    """Give ``group`` (a subgroup of the world, e.g. a mesh axis) the
    world's collective timeout, when ``initialize`` set one: torch starts a
    new group with its own default of 30 minutes, so without this a rank
    waiting on a silent peer of its dp or mp group would hang that long."""
    if _TIMEOUT_S is not None:
        from torch.distributed.distributed_c10d import _set_pg_timeout

        _set_pg_timeout(timedelta(seconds=_TIMEOUT_S), group)


def shutdown() -> None:
    """Destroy the process group, if one is running: a rank that leaves
    without it can abort at exit while the group's threads still run."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def local_rank() -> int:
    """This rank's index among the ranks of its host (env LOCAL_RANK; on
    one host, the rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def global_mesh(dp: Optional[int] = None, mp: Optional[int] = None,
                device_type: str = "cpu"):
    """(dp, mp) mesh over every rank. Defaults: mp = the ranks of one host
    (env LOCAL_WORLD_SIZE, else the whole world), dp = the rest, so the
    catalog collectives stay within a host."""
    from gdmcf_torch.parallel.mesh import make_mesh

    world = process_count()
    if mp is None:
        mp = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dp is None:
        dp = world // max(mp, 1)
    if dp * mp != world:
        raise ValueError(
            f"mesh (dp={dp}, mp={mp}) does not tile the {world} ranks — "
            "pick dp*mp == world size")
    return make_mesh(dp, mp, device_type)


def row_range(n_rows: int, shards: int, index: int) -> range:
    """Shard ``index`` of ``shards`` exactly equal contiguous row ranges;
    the remainder rows are dropped (like drop_last), so every shard runs
    the same number of collective steps per epoch."""
    base = n_rows // shards
    if base == 0:
        raise ValueError(
            f"{n_rows} rows cannot shard over {shards} data-parallel groups:"
            " every group would get an empty shard and silently train on "
            "nothing")
    return range(index * base, (index + 1) * base)


def local_row_range(n_rows: int, mesh=None) -> range:
    """This rank's disjoint user-row shard for multi-process data loading:
    its dp group's shard. The mp ranks of one dp group get the same rows;
    the global batch is the concatenation of the dp groups' batches.
    Without a mesh every rank is its own group."""
    if mesh is None:
        return row_range(n_rows, process_count(), process_index())
    from gdmcf_torch.parallel.mesh import axis_index, axis_size

    return row_range(n_rows, axis_size(mesh, "dp"), axis_index(mesh, "dp"))


def _wire_device() -> torch.device:
    """Where a collective's host payload travels: CPU under gloo, the
    rank's current CUDA device under nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_host_vectors(vec: np.ndarray, group=None) -> np.ndarray:
    """Bit-exact all-gather of one small host array per rank: returns
    ``[n, *vec.shape]`` stacked in rank order (of ``group``, default the
    world).

    The payload rides the wire as raw bytes (a uint8 view), so float64
    metric sums arrive exactly. Collective — every rank of the group calls
    it with an array of equal shape and dtype."""
    vec = np.ascontiguousarray(vec)
    if process_count() == 1:
        return vec[None]
    payload = torch.from_numpy(vec.view(np.uint8).reshape(-1).copy()).to(
        _wire_device())
    n = dist.get_world_size(group)
    out = [torch.empty_like(payload) for _ in range(n)]
    dist.all_gather(out, payload, group=group)
    rows = np.stack([o.cpu().numpy() for o in out])
    return rows.view(vec.dtype).reshape((n,) + vec.shape)


def sync_hosts(name: str = "barrier") -> None:
    """Barrier over every rank (a no-op in a single process). ``name`` is
    a debugging label only."""
    if process_count() > 1:
        dist.barrier()
