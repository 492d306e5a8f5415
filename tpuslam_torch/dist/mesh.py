"""Process-group helpers for distributed bundle adjustment (port of
``tpuslam/dist/mesh.py``, with ``default_group`` in place of the
reference's ``default_mesh``, tpuslam/dist/ba.py:219-224).

The reference has two distributed paths: a mesh over the local devices of
one process (``shard_map``) and a mesh that spans processes
(``multihost_*``, tpuslam/dist/ba.py:153-201).  On ``torch.distributed``
they are one path: one rank per device, each rank a process, and the factor
axis split over the ranks of a process group.  The backend follows the
device: NCCL where each rank owns its own card, gloo for CPU ranks and for
ranks that share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(init_method: str, world_size: int, rank: int, device, backend: str = "",
               timeout_s: float = 300.0) -> None:
    """Join the default process group: ``init_method`` is a rendezvous URL
    (``file://...`` or ``tcp://host:port``); ``backend`` defaults to
    :func:`backend_for` of ``device``.  A collective that waits longer than
    ``timeout_s`` raises instead of hanging."""
    backend = backend or backend_for(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def default_group():
    """The process-wide group of every rank (the reference's mesh over all
    devices), or None when ``torch.distributed`` is not initialized."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def make_group(n_ranks: int = 0):
    """A group of the first ``n_ranks`` ranks (all if 0); every rank must
    call it, as ``dist.new_group`` asks."""
    world = world_size()
    if n_ranks <= 0 or n_ranks == world:
        return default_group()
    if n_ranks > world:
        raise ValueError(f"requested {n_ranks} ranks, have {world}")
    return dist.new_group(list(range(n_ranks)))


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group if None); 1 without
    ``torch.distributed``."""
    if default_group() is None:
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without ``torch.distributed``."""
    if default_group() is None:
        return 0
    return dist.get_rank(group)


def mesh_size(group=None) -> int:
    """The reference's ``mesh_size``: the ranks that share the factors."""
    return world_size(group)
