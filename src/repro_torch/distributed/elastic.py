"""Elastic scaling: reload a run onto fewer ranks (counterpart of
:mod:`repro.distributed.elastic`).

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

The general (data, model) form serves layouts that do split a model
axis (the LM's; none of the RSNNs': their weights are a few hundred KB
and always replicated).  :func:`reshard` places a host tree with the
sharding rules' placements (:func:`repro_torch.distributed.sharding.
param_shardings`) as DTensors; :func:`best_mesh_from` builds the largest
(data, model) mesh that the survivors hold; :func:`survive_failure`
drops ranks, rebuilds the mesh and reshards, over ranks that are all
still alive, for the reason above.  The sharded step
(:func:`repro_torch.train.train_step.make_train_step_sharded`) trains on
such a mesh from the resharded state.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import ShardingRules, param_shardings, place_state
from repro_torch.launch.mesh import mesh_over, world_device_type
from repro_torch.models.transformer import tree_map


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


def reshard(host_tree: Any, specs: Any, mesh, rules: ShardingRules) -> Any:
    """Place a host tree (numpy arrays or tensors) onto ``mesh`` with its
    logical-axes ``specs``: each leaf becomes a DTensor whose placements
    the rules give (:func:`~repro_torch.distributed.sharding.place_state`),
    its shard alone copied to the mesh's device (the rank's card for
    ``"cuda"``).  Every rank of the mesh calls it with the same tree; each
    keeps its own shards."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    tensors = tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                       if isinstance(x, np.ndarray) else x, host_tree)
    return place_state(tensors, param_shardings(specs, mesh, rules), mesh, dev)


def best_mesh_from(ranks: Sequence[int], model_parallel: int,
                   device_type: Optional[str] = None):
    """The largest ``(data, model)`` mesh the surviving ``ranks`` hold,
    with the model axis kept at ``model_parallel`` (the tensor-parallel
    degree the program was built for); survivors beyond the largest
    multiple stay idle.  Every rank of the world calls it (it forms
    process groups).  ``device_type`` defaults to the world's."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = sorted(int(r) for r in ranks)
    data = len(ranks) // model_parallel
    if data < 1:
        raise ValueError(
            f"{len(ranks)} surviving ranks cannot host model_parallel={model_parallel}")
    grid = torch.tensor(ranks[:data * model_parallel]).reshape(data, model_parallel)
    return DeviceMesh(device_type or world_device_type(), grid,
                      mesh_dim_names=("data", "model"))


def survive_failure(host_state: Any, specs: Any, failed_ranks: Sequence[int],
                    rules: ShardingRules, model_parallel: int = 1) -> Tuple[Any, Any]:
    """Drop ``failed_ranks`` from the world, build the survivors'
    :func:`best_mesh_from` mesh and :func:`reshard` the host state onto
    it.  Every rank of the world calls it (the ranks taken out of service
    too: they are alive, see the module's note); a rank outside the new
    mesh, failed or idle, gets ``None`` for the state.  Returns
    ``(state, mesh)``."""
    failed = {int(r) for r in failed_ranks}
    survivors = [r for r in range(dist.get_world_size()) if r not in failed]
    mesh = best_mesh_from(survivors, model_parallel)
    if mesh.get_coordinate() is None:      # not a rank of the new mesh
        return None, mesh
    return reshard(host_state, specs, mesh, rules), mesh
