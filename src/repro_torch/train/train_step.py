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
every rank's.  A pod of more than one rank (a ``data`` or ``model`` axis
over 1) needs the sharded step, which waits for ROADMAP A8 item 5's second
half, and raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

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
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
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


def make_train_step_compressed(model, opt: AdamW, mesh, *, n_micro: int = 1) -> Callable:
    """Pod-axis int8 + error-feedback gradient compression over ``mesh``
    (a ``("pod", "data", "model")`` mesh whose ``data`` and ``model`` axes
    are 1).  Returns ``step(params, opt_state, residual, batch) ->
    (params, opt_state, residual, metrics)``; ``residual`` starts as
    :func:`repro_torch.optim.compression.init_residual` of the params.
    Every rank of the pod axis calls it with the same global batch."""
    names = tuple(mesh.mesh_dim_names)
    inner = [n for n in names if n != "pod"]
    if "pod" not in names or any(mesh.size(names.index(n)) != 1 for n in inner):
        raise NotImplementedError(
            f"make_train_step_compressed over a {dict(zip(names, mesh.shape))} mesh: a pod "
            f"of more than one rank needs the sharded step (ROADMAP A8 item 5, second half)")
    group = mesh.get_group("pod")
    n_pod, pod = mesh.size(names.index("pod")), mesh.get_local_rank("pod")
    grads_only = make_train_step_parts(model, n_micro)

    def step(params, opt_state, residual, batch):
        local = {k: v.reshape(n_pod, v.shape[0] // n_pod, *v.shape[1:])[pod]
                 for k, v in batch.items()}
        grads, metrics = grads_only(params, local)
        grads, residual = compressed_psum_mean(grads, residual, group)
        params, opt_state, om = opt.update(params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, residual, metrics

    return step
