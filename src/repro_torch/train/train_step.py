"""The LM's train step (counterpart of :mod:`repro.train.train_step`):
gradients of ``Model.train_loss`` and an AdamW update, with optional
microbatch accumulation.

``make_train_step(model, opt, n_micro=1)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``, a function of its
inputs as in JAX (new trees come back; the inputs are left as they were).

* ``n_micro == 1``: one backward; the gradients stay in the parameters'
  dtype, as ``jax.value_and_grad`` returns them, and AdamW's
  ``global_norm`` sees those.
* ``n_micro > 1``: the batch splits along its first axis into ``n_micro``
  slices (``x.reshape(n_micro, B // n_micro, ...)``), each slice's
  gradients are added into f32 accumulators and divided by ``n_micro``,
  and each metric is the mean over the slices.

Metrics are detached 0-d tensors on the parameters' device (``loss``,
``accuracy``, ``tokens``, ``aux_loss``, ``grad_norm``, ``lr``); reading
one (``float(...)``) waits for the card.

``make_train_step_parts(model, n_micro)`` is the gradient half alone,
``(params, batch) -> (grads, metrics)`` (the reference also takes the
optimizer, which it does not use).
``make_train_step_compressed(model, opt, mesh, n_micro=1)`` returns
``step(params, opt_state, residual, batch) -> (params, opt_state,
residual, metrics)``: each rank of the mesh's ``pod`` axis takes its
pod's contiguous slice of the global batch (the reference's ``P("pod")``
on axis 0), computes its gradients, and the mean over the pods goes
through int8 with error feedback (:func:`repro_torch.optim.compression.
compressed_psum_mean`, the f32 ``residual`` tree its state) before
AdamW.  The metrics are the rank's own pod's (the reference returns one
pod's under its replicated out spec); ``grad_norm`` and ``lr`` are
every rank's.  Over a pod of more than one rank (a ``data`` or ``model``
axis over 1), or when the params arrive as DTensors (the state already
placed on the pod's mesh), each pod runs the sharded step's gradients on
its ``(data, model)`` sub-mesh and the int8 mean crosses ``pod`` alone,
one scale a whole leaf (the amax spans every shard of it).

``make_train_step_sharded(model, opt, mesh, rules)`` is the sharded
(FSDP × TP) step, what the reference's ``jax.jit(make_train_step(...),
in_shardings=param_shardings(...))`` computes: parameters and AdamW
moments are DTensors placed by the sharding rules
(:func:`~repro_torch.distributed.sharding.param_shardings`; the moments
take the parameters' layout, :func:`opt_state_specs`), the batch is split
over ``("pod", "data")``, the model runs on DTensors under ``use_mesh``
(``shard()`` redistributes its activations, the flash kernels run on the
local shards), and the gradients come back in the parameters'
placements before AdamW, whose clip norm reduces over every shard.
Plain tensors handed to either step are taken as the global values every
rank holds and placed first; the state comes back placed, and the
metrics as plain tensors, alike on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    BASE_RULES,
    ShardingRules,
    from_global,
    logical_sharding,
    on_mesh,
    param_shardings,
    place_state,
    shard,
)
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import compressed_psum_mean


def opt_state_specs(param_specs: Any) -> Dict[str, Any]:
    """AdamW state's layout: moments shaped (and placed) like the
    parameters, a scalar step."""
    return {"mu": param_specs, "nu": param_specs, "step": ()}


def abstract_opt_state(params: Any) -> Dict[str, Any]:
    """AdamW state as ``meta`` tensors: shapes and dtypes, no memory."""
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def grads_of(model, params: Any, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Gradients of ``model.train_loss`` with respect to every leaf of
    ``params`` (a tree shaped like it, in the leaves' dtype) and the
    detached metrics.  ``params`` itself is left as it was."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    with torch.enable_grad():
        loss, metrics = model.train_loss(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, live)
    # a DTensor's gradient may come back partial or otherwise placed
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) and g.placements != p.placements else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return tree_map(lambda _: next(it), params), {k: v.detach() for k, v in metrics.items()}


def make_train_step_parts(model, n_micro: int = 1) -> Callable:
    """``(params, batch) -> (grads, metrics)``: one backward (gradients in
    the parameters' dtype), or ``n_micro`` slices of the batch along its
    first axis with f32 accumulators divided by ``n_micro`` and each
    metric the mean over the slices."""

    def grads_only(params, batch):
        if n_micro == 1:
            return grads_of(model, params, batch)
        micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                  memory_format=torch.contiguous_format),
                       params)
        ms = []
        for i in range(n_micro):
            g, m = grads_of(model, params, {k: v[i] for k, v in micro.items()})
            tree_map(lambda a, gg: a.add_(gg.float()), acc, g)
            ms.append(m)
        grads = tree_map(lambda a: a / n_micro, acc)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return grads, metrics

    return grads_only


def make_train_step(model, opt: AdamW, *, n_micro: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``."""
    grads_only = make_train_step_parts(model, n_micro)

    def train_step(params, opt_state, batch):
        grads, metrics = grads_only(params, batch)
        params, opt_state, om = opt.update(params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def _pod_mesh(mesh):
    """The mesh of one pod: ``mesh`` without its ``pod`` axis (itself when
    it has none)."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    return mesh[tuple(n for n in names if n != "pod")]


def _place_batch(t: torch.Tensor, mesh, rules: ShardingRules) -> torch.Tensor:
    """A batch tensor split along its first axis over the ``batch`` rule's
    mesh axes: a plain one is the global batch every rank holds (each
    keeps its rows, no communication)."""
    axes = ("batch",) + (None,) * (t.dim() - 1)
    if isinstance(t, DTensor):
        return shard(t, *axes)
    return from_global(t, *logical_sharding(axes, mesh, rules))


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_sharded_parts(model, opt: AdamW, mesh, rules: Optional[ShardingRules] = None, *,
                       n_micro: int = 1) -> Tuple[Callable, Callable, Callable]:
    """``(place, grads_only, update)``, the pieces of the sharded step on
    ``mesh`` (a mesh with ``data`` and ``model`` axes, ``pod`` too for
    the whole run's mesh): ``place(params[, opt_state])`` puts the state
    on the mesh with the rules' placements; ``grads_only(params, batch)
    -> (grads, metrics)`` runs the model on DTensors under ``use_mesh``
    (the batch split over the ``batch`` rule's axes), the gradients in
    the parameters' placements, the metrics still DTensors;
    ``update(params, grads, opt_state)`` is ``opt.update`` under the
    mesh (its clip norm a sum over every shard)."""
    rules = rules or ShardingRules(BASE_RULES)
    p_place = param_shardings(model.param_specs(), mesh, rules)
    parts = make_train_step_parts(model, n_micro)

    def place(params, opt_state=None):
        params = place_state(params, p_place, mesh)
        if opt_state is None:
            return params
        moments = {k: place_state(opt_state[k], p_place, mesh) for k in ("mu", "nu")}
        return params, {**opt_state, **moments}

    def grads_only(params, batch):
        with on_mesh(mesh, rules):
            batch = {k: _place_batch(v, mesh, rules) for k, v in batch.items()}
            return parts(params, batch)

    def update(params, grads, opt_state):
        with on_mesh(mesh, rules):
            return opt.update(params, grads, opt_state)

    return place, grads_only, update


def make_train_step_sharded(model, opt: AdamW, mesh, rules: Optional[ShardingRules] = None,
                            *, n_micro: int = 1) -> Callable:
    """The sharded (FSDP × TP) train step over ``mesh``: returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, every rank of the mesh calling it with the same global
    batch.  The state comes back as DTensors placed by ``rules``; the
    metrics are plain tensors, alike on every rank (so the ``Trainer``'s
    non-finite rollback takes the same decision everywhere, and each rank
    keeps its old state for it)."""
    place, grads_only, update = make_sharded_parts(model, opt, mesh, rules, n_micro=n_micro)

    def train_step(params, opt_state, batch):
        params, opt_state = place(params, opt_state)
        grads, metrics = grads_only(params, batch)
        params, opt_state, om = update(params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, {k: _whole(v) for k, v in metrics.items()}

    return train_step


def make_train_step_compressed(model, opt: AdamW, mesh, *, n_micro: int = 1,
                               rules: Optional[ShardingRules] = None) -> Callable:
    """Pod-axis int8 + error-feedback gradient compression over ``mesh``
    (a ``("pod", "data", "model")`` mesh).  Returns ``step(params,
    opt_state, residual, batch) -> (params, opt_state, residual,
    metrics)``; ``residual`` starts as
    :func:`repro_torch.optim.compression.init_residual` of the params.
    Every rank calls it with the same global batch.

    A pod of more than one rank, or params that arrive as DTensors (the
    state already placed on the pod's ``(data, model)`` mesh,
    :func:`_pod_mesh`, by ``make_sharded_parts``' ``place``), runs each
    pod's gradients through the sharded step there: the state and
    residual come back as DTensors, each leaf's int8 scale spans all its
    shards, and the codes cross ``pod`` alone.  Otherwise each pod is one
    rank, which steps plain tensors."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        raise ValueError(f"make_train_step_compressed needs a 'pod' axis, the mesh has {names}")
    inner = [n for n in names if n != "pod"]
    several = any(mesh.size(names.index(n)) != 1 for n in inner)
    group = mesh.get_group("pod")
    n_pod, pod = mesh.size(names.index("pod")), mesh.get_local_rank("pod")
    place, sharded_grads, sharded_update = make_sharded_parts(
        model, opt, _pod_mesh(mesh), (rules or ShardingRules(BASE_RULES)).strip("pod"),
        n_micro=n_micro)
    plain_grads = make_train_step_parts(model, n_micro)

    def step(params, opt_state, residual, batch):
        local = {k: v.reshape(n_pod, v.shape[0] // n_pod, *v.shape[1:])[pod]
                 for k, v in batch.items()}
        if several or isinstance(tree_leaves(params)[0], DTensor):
            params, opt_state = place(params, opt_state)
            residual = place(residual)
            grads_only, update = sharded_grads, sharded_update
            scale_groups = [mesh.get_group(n) for n in inner]
        else:
            grads_only, update, scale_groups = plain_grads, opt.update, []
        grads, metrics = grads_only(params, local)
        grads, residual = compressed_psum_mean(grads, residual, group, scale_groups)
        params, opt_state, om = update(params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, residual, {k: _whole(v) for k, v in metrics.items()}

    return step
