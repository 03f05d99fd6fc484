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
minutes.

The LM's meshes (``make_debug_mesh``, ``make_production_mesh``) carry the
JAX package's axis names in its order, ``("data", "model")`` or, across
pods, ``("pod", "data", "model")``, over every rank of the world.  The
compressed train step reduces over ``pod``
(:func:`repro_torch.train.train_step.make_train_step_compressed`), GPipe
hands activations along it (:mod:`repro_torch.distributed.pipeline`),
``reshard`` places a tree with the sharding rules' placements on it, and
the sharded (FSDP × TP) step runs over ``data`` and ``model``
(:func:`repro_torch.train.train_step.make_train_step_sharded`).

:func:`join_fake_world` is the counterpart of the reference dry run's
``--xla_force_host_platform_device_count=512``: one process joins a world
of any size as one of its ranks over PyTorch's fake process group, whose
collectives move nothing, and the meshes above then build unchanged (the
production mesh on 256 or 512 ranks); with ``FakeTensorMode`` the ranks'
tensors hold no memory (:mod:`repro_torch.launch.dryrun`).  A fake world
never shares a process with a real one.  The
reference's TPU constants (peak rates, link
bandwidths) are not ported: the card's figures live in
:mod:`repro_torch.kernels.traffic`.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 60.0
DATA_AXIS = "data"
# the timeout the current world joined with (join_world), which the groups
# formed later in it take too
_world_timeout_s = DEFAULT_TIMEOUT_S


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
               device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
               local_rank: Optional[int] = None) -> torch.device:
    """Join a world of ``world_size`` processes as ``rank``.

    ``init_method`` is a ``file://`` path or ``env://``.  On ``"cuda"``
    the rank takes card ``local_rank`` of its machine (default ``rank``:
    a world on one machine; ``torchrun`` sets ``LOCAL_RANK`` for worlds
    over several), and a card index past this machine's cards raises
    (NCCL runs one rank a card); on ``"cpu"`` every rank runs on the CPU.
    Returns the rank's device."""
    global _world_timeout_s
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        card = rank if local_rank is None else local_rank
        cards = torch.cuda.device_count()
        if card >= cards:
            raise ValueError(
                f"rank {rank} on cuda needs card {card}, this machine has {cards}: "
                f"NCCL runs one rank a card")
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        dist_backend(dev.type), init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _world_timeout_s = float(timeout_s)
    return dev


# the device type a fake world's ranks simulate (join_fake_world)
_fake_device_type: Optional[str] = None


def join_fake_world(world_size: int, rank: int = 0, *, device: str = "cuda") -> None:
    """Join a fake world of ``world_size`` ranks as ``rank``, simulating
    ``device`` ranks (``"cuda"`` by default; no card is needed): the
    backend is PyTorch's ``"fake"`` process group, every collective
    returns at once with its output's shape, and the meshes of this module
    build over it as over a real world.  Raises in a process that has
    joined a world already."""
    global _fake_device_type
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dev_type = torch.device(device).type
    dist_backend(dev_type)
    if dist.is_initialized():
        raise RuntimeError("join_fake_world: this process has joined a world already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    _fake_device_type = dev_type


def world_timeout_s() -> float:
    """The group timeout of the current world (:func:`join_world`'s
    ``timeout_s``; :data:`DEFAULT_TIMEOUT_S` for a world joined otherwise)."""
    return _world_timeout_s


def leave_world() -> None:
    global _fake_device_type
    if dist.is_initialized():
        dist.destroy_process_group()
    _fake_device_type = None


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


def world_device_type() -> str:
    """The device type the current world's backend runs on."""
    if not dist.is_initialized():
        raise RuntimeError("join a world first (join_world)")
    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    if backend == "fake" and _fake_device_type is not None:
        return _fake_device_type
    raise ValueError(f"no device type for backend {backend!r}")


def _world_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device: Optional[str]):
    """A mesh of ``shape`` over every rank of the world, in rank order."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = torch.device(device).type if device else world_device_type()
    dist_backend(dev_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks, "
                         f"this world has {world}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, n_pod: int = 0, *,
                    device: Optional[str] = None):
    """A small ``(data, model)`` mesh, or ``(pod, data, model)`` with
    ``n_pod``, over the whole world (its size must be the product).
    ``device`` defaults to the world backend's device type."""
    if n_pod:
        return _world_mesh((n_pod, n_data, n_model), ("pod", "data", "model"), device)
    return _world_mesh((n_data, n_model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device: Optional[str] = None):
    """The production layout: 16 × 16 ``(data, model)`` ranks a pod, two
    pods across ``pod``.  It needs a world of 256 (or 512) ranks and
    raises in any other; it never shrinks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, names, device)


def mesh_over(ranks: Sequence[int], device_type: str):
    """A ``("data",)`` mesh over the given ranks of the current world
    (every rank of the world must call it)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, list(ranks), mesh_dim_names=(DATA_AXIS,))
