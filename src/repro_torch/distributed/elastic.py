"""Elastic scaling of the data-parallel RSNN path (counterpart of
:mod:`repro.distributed.elastic`, its data-mesh part).

The RSNN stack is data-parallel over one ``("data",)`` mesh axis: the
weights are replicated on every rank, the sample axis is sharded, END_B's
``dw`` is summed over the ranks.  Checkpoints hold whole host arrays
(:mod:`repro_torch.distributed.checkpoint`), so a run saved on 8 ranks
restores onto 4, 2 or 1: resize the backend onto the survivors' mesh and
place each leaf on the rank's device
(:func:`~repro_torch.distributed.checkpoint.place_like`, which the
learner's restore already does).  With a ``commit_grid`` runtime (int32
code sums, :data:`repro_torch.core.quant.DW_COMMIT_SPEC`) the resized
run's END_B commits are bitwise the original's; without one they agree to
the float sum's order.

**A live group cannot shed a dead rank.**  ``torch.distributed`` forms a
sub-group (``new_group``, which a :class:`DeviceMesh` over some ranks
calls) only with every rank of the world taking part, and a rank that died
mid-collective leaves the others blocked in it until the group's timeout.
So :func:`survive_data_failure` resizes over ranks that are all still
alive (a rank taken out of service, every rank of the world calling it);
recovering from a rank that *died* is a restart onto a smaller world from
the newest checkpoint, which is what ``python -m repro_torch.train.chaos
--mesh-devices N`` drills (8 ranks killed, 4 resumed, bitwise).

``reshard`` is not needed (the weights are replicated), and the (data,
model) forms ``best_mesh_from`` / ``survive_failure`` wait for the LM's
tensor parallelism (ROADMAP A8).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.launch.mesh import mesh_over


def best_data_mesh_from(ranks: Sequence[int], device_type: str = "cuda"):
    """The survivors' one-axis ``("data",)`` mesh over ``ranks`` of the
    current world, or ``None`` for one survivor (single-device execution).
    More than one survivor forms a process group: every rank of the world
    must call it."""
    ranks = sorted(int(r) for r in ranks)
    if not ranks:
        raise ValueError("no surviving ranks")
    if len(ranks) == 1:
        return None
    return mesh_over(ranks, device_type)


def _ranks_of(backend) -> Sequence[int]:
    if backend.mesh is not None:
        return backend.mesh.mesh.flatten().tolist()
    return list(range(dist.get_world_size())) if dist.is_initialized() else [0]


def survive_data_failure(backend, failed_ranks: Sequence[int]) -> Tuple[Optional[object], object]:
    """Drop ``failed_ranks`` from ``backend``'s ranks (its mesh's, else the
    world's), build the survivors' ``("data",)`` mesh and resize
    ``backend`` onto it (:meth:`~repro_torch.core.backend.ExecutionBackend.
    resize`).  Every rank of the world calls it; a failed rank gets
    ``None`` for the backend (it has no place in the new mesh).  Restore
    the checkpointed state after resizing.  Returns ``(resized_backend,
    survivors_mesh)``."""
    failed = {int(r) for r in failed_ranks}
    survivors = [r for r in _ranks_of(backend) if r not in failed]
    mesh = best_data_mesh_from(survivors, backend.device.type)
    me = dist.get_rank() if dist.is_initialized() else 0
    if me in failed:
        return None, mesh
    return backend.resize(mesh), mesh
