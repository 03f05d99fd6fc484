"""Layer plans and stacks of the dense LM family (counterpart of
:mod:`repro.models.transformer`).

A stack is described by a :class:`Plan`: a ``period`` of layers repeated
``repeats`` times.  The parameters keep the JAX package's tree layout —
``{"prefix": [], "scan": {"0": {...}}}`` with the period's leaves stacked
along a leading layer axis — so a JAX tree converts by a tree map, and
each layer of the loop reads its slice of the stack (a view, no copy).
Caches follow the same layout, and every layer writes its slice of them
in place.  The JAX package's unrolled ``prefix`` (the first dense layers
of the MoE archs, or every layer without scan-over-layers) comes with the
families that need it; the dense family's prefix is empty.

Training (no caches) unbinds the stacked leaves once and, with
``cfg.remat``, runs each period under ``torch.utils.checkpoint`` as the
JAX package's ``_remat`` wraps its scan body: ``remat_policy="full"``
keeps only the period's input and recomputes the rest in the backward,
``"dots"`` also keeps the outputs of the 2-D matmuls (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).  The
gradients are the same either way: the recompute runs the same
arithmetic.

Layer kinds are ``(mixer, ffn)`` pairs; the port runs ``("attn", "dense")``
(the dense family).  MoE, MLA, Mamba, cross-attention and the encoder
raise ``NotImplementedError`` (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    init_embedding,
    init_mlp,
    init_rms_norm,
    make_param,
    mlp_forward,
    rms_norm,
)

Kind = Tuple[str, str]
DENSE: Kind = ("attn", "dense")


@dataclasses.dataclass(frozen=True)
class Plan:
    period: Tuple[Kind, ...]
    repeats: int


def layer_plan(cfg) -> Plan:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP A8)")
    return Plan((DENSE,), cfg.n_layers)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every tensor leaf of a tree of dicts and lists, with the
    leaves at the same place in the ``rest`` trees as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of a tree, in order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen, cfg, kind: Kind, device: torch.device) -> Dict[str, Any]:
    if kind != DENSE:
        raise NotImplementedError(f"layer kind {kind} is not ported yet (ROADMAP A8)")
    d, dt = cfg.d_model, cfg.torch_dtype
    return {
        "ln1": init_rms_norm(d, dt, device),
        "mixer": attn.init_gqa(gen, cfg, device),
        "ln2": init_rms_norm(d, dt, device),
        "ffn": init_mlp(gen, d, cfg.d_ff, dt, device),
    }


def init_stack(gen, cfg, plan: Plan, device: torch.device) -> Dict[str, Any]:
    """The period's layers drawn one repeat at a time into their slots of
    the stacked leaves, so that the peak memory is the stack plus one
    layer."""
    stacked = None
    for r in range(plan.repeats):
        rep = {str(j): init_layer(gen, cfg, kind, device)
               for j, kind in enumerate(plan.period)}
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((plan.repeats, *t.shape)), rep)
        if device.type != "meta":
            for dst, src in zip(tree_leaves(stacked), tree_leaves(rep)):
                dst[r].copy_(src)
    return {"prefix": [], "scan": stacked}


def init_model(gen, cfg, device: torch.device) -> Dict[str, Any]:
    """The full parameter tree: ``embed``, ``ln_f``, ``layers`` and, unless
    the embeddings are tied, ``lm_head``."""
    dt = cfg.torch_dtype
    tree: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "ln_f": init_rms_norm(cfg.d_model, dt, device),
        "layers": init_stack(gen, cfg, layer_plan(cfg), device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = make_param(gen, (cfg.d_model, cfg.vocab), dt, device)
    return tree


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no memory."""
    return init_model(None, cfg, torch.device("meta"))


def count_params(cfg) -> int:
    return sum(t.numel() for t in tree_leaves(param_shapes(cfg)))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def block_forward(kind: Kind, p: Dict[str, Any], x: torch.Tensor, cfg, *,
                  cache: Optional[Dict] = None, pos: Optional[int] = None) -> torch.Tensor:
    """One layer; its attention writes ``cache`` in place (prefill when
    ``pos`` is None, else decode at slot ``pos``); without a cache, train
    mode."""
    if kind != DENSE:
        raise NotImplementedError(f"layer kind {kind} is not ported yet (ROADMAP A8)")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer_cache = None if cache is None else cache["mixer"]
    x = x + attn.gqa_forward(p["mixer"], h, cfg, mixer_cache, causal=True, pos=pos)
    return x + mlp_forward(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))


# The 2-D matmuls, whose outputs the "dots" policy keeps (what the x @ W
# projections and the logits reach as aten ops); attention's batched
# products are recomputed, as dots_with_no_batch_dims_saveable does.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
REMAT_POLICIES = ("full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` as ``cfg.remat`` and
    ``cfg.remat_policy`` say; a policy other than "full" or "dots"
    raises."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} not in {REMAT_POLICIES}")
    if not cfg.remat:
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` layer slices of a stacked tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients once, where ``t[r]`` would add
    ``n`` zero-padded full-size ones."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p, r=r: p[r], parts) for r in range(n)]


def stack_forward(stack_params: Dict[str, Any], x: torch.Tensor, cfg, plan: Plan,
                  caches: Optional[Dict[str, Any]] = None, *,
                  pos: Optional[int] = None):
    """Run a stack over ``caches`` (stacked like the parameters).  Returns
    (x, caches).

    Modes: train (``caches`` None: no cache, each period under
    :func:`_remat`; returns (x, None)), prefill (``pos`` None: each layer
    writes the keys and values of positions ``[0, S)`` into its slice of
    the caches) and decode (``pos`` the write slot of the one new token).
    Either way the caches are written in place, and the same caches come
    back.
    """
    if caches is None:
        if pos is not None:
            raise ValueError("stack_forward: decode needs the caches")

        def period(x, layer_p):
            for j, kind in enumerate(plan.period):
                x = block_forward(kind, layer_p[str(j)], x, cfg)
            return x

        body = _remat(period, cfg)
        for layer_p in _unstack(stack_params["scan"], plan.repeats):
            x = body(x, layer_p)
        return x, None
    for r in range(plan.repeats):
        layer_p = tree_map(lambda t: t[r], stack_params["scan"])
        layer_c = tree_map(lambda t: t[r], caches["scan"])
        for j, kind in enumerate(plan.period):
            x = block_forward(kind, layer_p[str(j)], x, cfg,
                              cache=layer_c[str(j)], pos=pos)
    return x, caches


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def stack_cache_specs(cfg, plan: Plan, batch: int, max_len: int) -> Dict[str, Any]:
    """The cache tree of a stack as ``meta`` tensors (shapes and dtypes)."""
    def layer(kind):
        if kind != DENSE:
            raise NotImplementedError(f"layer kind {kind} is not ported yet (ROADMAP A8)")
        return {"mixer": attn.gqa_cache_spec(cfg, batch, max_len)}

    per = {str(j): layer(kind) for j, kind in enumerate(plan.period)}
    return {"prefix": [],
            "scan": tree_map(lambda t: t.new_empty((plan.repeats, *t.shape)), per)}
