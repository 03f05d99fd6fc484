"""Process worlds and the data mesh (counterpart of
:mod:`repro.launch.mesh`, its data-parallel part).

JAX sees every device of a host from one process; ``torch.distributed``
runs one process a rank.  So a data-parallel run here is a *world*: N
processes, each joined with :func:`join_world` (NCCL for ``"cuda"``, one
card a rank; gloo for ``"cpu"``), each building the same one-axis
``("data",)`` mesh with :func:`make_data_mesh` and calling the same ops
with the same global inputs (the SPMD contract of
:class:`repro_torch.core.backend.ExecutionBackend`).

Every group gets an explicit ``timeout``: a rank that dies mid-collective
leaves the others blocked there, and gloo's default would hold them for 30
minutes.  The (data, model) meshes of the LM (``make_production_mesh``,
``make_debug_mesh``) wait for the LM's sharding (ROADMAP A8).
"""

from __future__ import annotations

import datetime
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 60.0
DATA_AXIS = "data"


def dist_backend(device_type: str) -> str:
    """The collective backend a device type runs on: NCCL on the card,
    gloo on the CPU.  Nothing else: a world on the card never drops to
    gloo."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {device_type!r}")


def join_world(rank: int, world_size: int, init_method: str, *,
               device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> torch.device:
    """Join a world of ``world_size`` processes as ``rank``.

    ``init_method`` is a ``file://`` path or ``env://``.  On ``"cuda"``
    rank ``r`` takes card ``r`` (NCCL refuses two ranks on one card, so a
    world larger than the cards raises); on ``"cpu"`` every rank runs on
    the CPU.  Returns the rank's device."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"a world of {world_size} ranks on cuda needs {world_size} cards, "
                f"this machine has {cards}: NCCL runs one rank a card")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        dist_backend(dev.type), init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def leave_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_data_mesh(device: str = "cuda"):
    """The one-axis ``("data",)`` mesh the RSNN backend shards its sample
    axis over, on every rank of the current world.  Every rank of the
    world must call it (it forms a process group).  ``device`` is the
    ranks' device type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_data_mesh: join a world first (join_world)")
    dev_type = torch.device(device).type
    dist_backend(dev_type)
    return init_device_mesh(dev_type, (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def mesh_over(ranks: Sequence[int], device_type: str):
    """A ``("data",)`` mesh over the given ranks of the current world
    (every rank of the world must call it)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, list(ranks), mesh_dim_names=(DATA_AXIS,))
