"""Layer plans and stacks of the LM families (counterpart of
:mod:`repro.models.transformer`).

A stack is described by a :class:`Plan`: an unrolled ``prefix`` (deepseek's
dense first layer) and a ``period`` of layers repeated ``repeats`` times
(jamba's period is 8 layers: attention at ``attn_offset``, Mamba
elsewhere, the MoE FFN where ``i % moe_every == moe_every - 1``; the vlm's
is a cross-attention layer, then ``cross_attn_every - 1`` self-attention
layers).  The ``audio`` family has a second stack, the encoder
(:func:`encoder_plan`: ``n_enc_layers`` bidirectional layers), whose
output, after ``enc_ln_f``, is the memory every decoder layer
cross-attends.
The parameters keep the JAX package's tree layout — ``{"prefix": [layer,
...], "scan": {"0": {...}, ...}}`` with the period's leaves stacked along a
leading layer axis — so a JAX tree converts by a tree map, and each layer
of the loop reads its slice of the stack (a view, no copy).  Caches follow
the same layout, one tree per layer kind (an attention layer's keys and
values, a Mamba layer's conv tails and state, a cross-attention layer's
memory keys and values), and every layer writes its slice of them in
place.

Training (no caches) unbinds the stacked leaves once and, with
``cfg.remat``, runs each prefix layer and each period under
``torch.utils.checkpoint`` as the JAX package's ``_remat`` wraps its prefix
layers and its scan body: ``remat_policy="full"`` keeps only the inputs and
recomputes the rest in the backward, ``"dots"`` also keeps the outputs of
the 2-D matmuls (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
projections are kept, attention's and the SSD's batched einsums are
recomputed).  The cross-attention memory is an input of each checkpointed
function, so the encoder gets its gradient through every decoder layer.
The gradients are the same either way: the recompute runs the same
arithmetic.  Every layer returns its MoE aux loss (0 for a dense FFN or
none), summed over the prefix and then the periods in the JAX package's
order.

Layer kinds are ``(mixer, ffn)`` pairs: mixer ``"attn"`` (MLA when
``cfg.mla`` is set, else GQA), ``"mamba"``, ``"xattn"`` (cross-attention
alone), ``"attn_xattn"`` (causal self-attention, then ``ln_x`` and
cross-attention: the audio decoder) or ``"attn_enc"`` (bidirectional
self-attention, no cache: the audio encoder); ffn ``"dense"``, ``"moe"``
or ``"none"`` (no ``ln2`` and no ``ffn`` leaves).
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

from repro_torch.distributed.sharding import gather_fsdp, layer_at, recompute_in_mesh
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    init_embedding,
    init_mlp,
    init_rms_norm,
    make_param,
    mlp_forward,
    rms_norm,
    with_axes,
)

Kind = Tuple[str, str]
DENSE: Kind = ("attn", "dense")
MOE: Kind = ("attn", "moe")
MAMBA: Kind = ("mamba", "none")
XATTN: Kind = ("xattn", "dense")
ATTN_XATTN: Kind = ("attn_xattn", "dense")
ENC: Kind = ("attn_enc", "dense")
KINDS = frozenset({DENSE, MOE, MAMBA, ("mamba", "dense"), ("mamba", "moe"), XATTN,
                   ATTN_XATTN, ENC})


@dataclasses.dataclass(frozen=True)
class Plan:
    prefix: Tuple[Kind, ...]
    period: Tuple[Kind, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + len(self.period) * self.repeats


def layer_plan(cfg) -> Plan:
    """The decoder's plan; with ``cfg.scan_layers`` off, every layer in the
    prefix (no stacked period: ``{"prefix": [L layers], "scan": None}``)."""
    plan = _layer_plan(cfg)
    if not cfg.scan_layers:
        return Plan(plan.prefix + plan.period * plan.repeats, (), 0)
    return plan


def _layer_plan(cfg) -> Plan:
    if cfg.family == "ssm":
        return Plan((), (MAMBA,), cfg.n_layers)
    if cfg.family == "hybrid":
        per = cfg.attn_every
        if cfg.n_layers % per != 0:
            raise ValueError(f"n_layers={cfg.n_layers} must divide into attn_every={per}")
        period = []
        for i in range(per):
            mixer = "attn" if i == cfg.attn_offset else "mamba"
            ffn = "dense"
            if cfg.moe is not None and i % cfg.moe.moe_every == cfg.moe.moe_every - 1:
                ffn = "moe"
            period.append((mixer, ffn))
        return Plan((), tuple(period), cfg.n_layers // per)
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        if cfg.n_layers % per != 0:
            raise ValueError(
                f"n_layers={cfg.n_layers} must divide into cross_attn_every={per}")
        return Plan((), (XATTN,) + (DENSE,) * (per - 1), cfg.n_layers // per)
    if cfg.family == "moe":
        if cfg.moe.first_dense:
            return Plan((DENSE,), (MOE,), cfg.n_layers - 1)
        return Plan((), (MOE,), cfg.n_layers)
    if cfg.family == "audio":
        return Plan((), (ATTN_XATTN,), cfg.n_layers)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return Plan((), (DENSE,), cfg.n_layers)


def encoder_plan(cfg) -> Optional[Plan]:
    """The encoder's plan (``cfg.encdec``), else None; all prefix with
    ``cfg.scan_layers`` off."""
    if not cfg.encdec:
        return None
    if not cfg.scan_layers:
        return Plan((ENC,) * cfg.n_enc_layers, (), 0)
    return Plan((), (ENC,), cfg.n_enc_layers)


def _check_kind(kind: Kind) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind}; known: {sorted(KINDS)}")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every tensor leaf of a tree of dicts and lists, with the
    leaves at the same place in the ``rest`` trees as further arguments;
    ``None`` (an unscanned stack's ``"scan"``) stays ``None``."""
    if tree is None:
        return None
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
    """One layer's parameters: ``ln1`` and the mixer, then (``attn_xattn``)
    ``ln_x`` and the cross-attention ``xattn``, then ``ln2`` and the FFN
    unless the kind's FFN is ``"none"``."""
    _check_kind(kind)
    mixer, ffn = kind
    d, dt = cfg.d_model, cfg.torch_dtype
    if mixer == "mamba":
        p_mixer = mb.init_mamba(gen, cfg, device)
    elif mixer == "xattn":
        p_mixer = attn.init_cross_attn(gen, cfg, device)
    elif cfg.mla is not None and mixer != "attn_enc":
        p_mixer = attn.init_mla(gen, cfg, device)
    else:
        p_mixer = attn.init_gqa(gen, cfg, device)
    p = {"ln1": init_rms_norm(d, dt, device), "mixer": p_mixer}
    if mixer == "attn_xattn":
        p["ln_x"] = init_rms_norm(d, dt, device)
        p["xattn"] = attn.init_cross_attn(gen, cfg, device)
    if ffn != "none":
        p["ln2"] = init_rms_norm(d, dt, device)
        p["ffn"] = (moe_mod.init_moe(gen, cfg, device) if ffn == "moe"
                    else init_mlp(gen, d, cfg.d_ff, dt, device))
    return p


def _stacked(leaf: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """``stack`` (``leaf`` with a leading layer axis) and, on the ``meta``
    device, ``leaf``'s logical axes behind ``"layers"``."""
    if leaf.device.type != "meta":
        return stack
    return with_axes(stack, ("layers", *leaf.logical_axes))


def init_stack(gen, cfg, plan: Plan, device: torch.device) -> Dict[str, Any]:
    """The prefix's layers, then the period's drawn one repeat at a time
    into their slots of the stacked leaves, so that the peak memory is the
    stack plus one repeat; a single repeat is its own stack (a view with
    a leading axis of 1, no copy)."""
    prefix = [init_layer(gen, cfg, kind, device) for kind in plan.prefix]
    stacked = None
    for r in range(plan.repeats):
        rep = {str(j): init_layer(gen, cfg, kind, device)
               for j, kind in enumerate(plan.period)}
        if plan.repeats == 1:
            return {"prefix": prefix, "scan": tree_map(lambda t: _stacked(t, t[None]), rep)}
        if stacked is None:
            stacked = tree_map(
                lambda t: _stacked(t, t.new_empty((plan.repeats, *t.shape))), rep)
        if device.type != "meta":
            for dst, src in zip(tree_leaves(stacked), tree_leaves(rep)):
                dst[r].copy_(src)
    return {"prefix": prefix, "scan": stacked}


def init_model(gen, cfg, device: torch.device) -> Dict[str, Any]:
    """The full parameter tree: ``embed``, ``ln_f``, ``layers``, unless the
    embeddings are tied ``lm_head``, and with an encoder (``cfg.encdec``)
    its stack ``encoder`` and its final norm ``enc_ln_f``."""
    dt = cfg.torch_dtype
    tree: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "ln_f": init_rms_norm(cfg.d_model, dt, device),
        "layers": init_stack(gen, cfg, layer_plan(cfg), device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = make_param(gen, (cfg.d_model, cfg.vocab), dt, device,
                                     axes=("embed", "vocab"))
    eplan = encoder_plan(cfg)
    if eplan is not None:
        tree["encoder"] = init_stack(gen, cfg, eplan, device)
        tree["enc_ln_f"] = init_rms_norm(cfg.d_model, dt, device)
    return tree


def unscan(stack: Dict[str, Any], plan: Plan) -> Dict[str, Any]:
    """A scanned stack (parameters, gradients or caches laid out by
    ``plan``) as ``scan_layers=False`` lays it out: the prefix's layers,
    then each repeat's period layers in order, all under ``"prefix"``
    (views of the stacked leaves), ``"scan"`` None."""
    layers = list(stack["prefix"])
    for r in range(plan.repeats):
        rep = tree_map(lambda t: t[r], stack["scan"])
        layers += [rep[str(j)] for j in range(len(plan.period))]
    return {"prefix": layers, "scan": None}


def unscan_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A scanned model's parameter tree as the same model with
    ``scan_layers=False`` takes it (the decoder's stack and, with an
    encoder, its stack unscanned; the other leaves as they are)."""
    out = dict(params)
    out["layers"] = unscan(params["layers"], layer_plan(cfg.replace(scan_layers=True)))
    if "encoder" in params:
        out["encoder"] = unscan(params["encoder"], encoder_plan(cfg.replace(scan_layers=True)))
    return out


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no memory."""
    return init_model(None, cfg, torch.device("meta"))


def abstract_model(cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(param_shapes(cfg), specs)``: ``specs`` mirrors the parameter tree
    with each leaf's logical axes, a tuple of one name (or ``None``) a
    dimension, stacked leaves led by ``"layers"`` (the JAX package's
    ``abstract_model``).  No memory is allocated."""
    shapes = param_shapes(cfg)
    return shapes, tree_map(lambda t: t.logical_axes, shapes)


# The routed experts' leaves of a MoE FFN: a token runs through top_k of
# n_experts of each (the JAX package counts the leaves with an "experts"
# axis: these four).
EXPERT_LEAVES = ("w_router", "w_gate", "w_up", "w_down")


def count_params(cfg, active_only: bool = False) -> int:
    """Parameters of ``cfg``'s tree; ``active_only`` counts each MoE FFN's
    :data:`EXPERT_LEAVES` at ``top_k / n_experts`` of their size, as the
    JAX package's ``count_params`` does."""
    total = 0

    def walk(tree, moe_ffn: bool) -> None:
        nonlocal total
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if v is None:
                continue
            if isinstance(v, (dict, list)):
                walk(v, isinstance(v, dict) and k == "ffn" and "w_router" in v)
            elif active_only and moe_ffn and k in EXPERT_LEAVES:
                total += v.numel() * cfg.moe.top_k // cfg.moe.n_experts
            else:
                total += v.numel()

    walk(param_shapes(cfg), False)
    return total


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def block_forward(kind: Kind, p: Dict[str, Any], x: torch.Tensor, cfg, *,
                  memory: Optional[torch.Tensor] = None, cache: Optional[Dict] = None,
                  pos: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer → (x, aux loss); its mixers write ``cache`` in place
    (prefill when ``pos`` is None, else decode at slot ``pos``); without a
    cache, train mode.  A cross-attention reads ``memory`` in train and
    prefill, its cache in decode; ``attn_enc`` takes no cache.  The aux
    loss is the MoE FFN's, or an f32 zero."""
    _check_kind(kind)
    mixer, ffn = kind
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer_cache = None if cache is None else cache["mixer"]
    if mixer == "mamba":
        x = x + mb.mamba_forward(p["mixer"], h, cfg, mixer_cache, pos=pos)
    elif mixer == "xattn":
        x = x + attn.cross_attn_forward(p["mixer"], h, memory, cfg, mixer_cache, pos=pos)
    elif mixer == "attn_enc":
        x = x + attn.gqa_forward(p["mixer"], h, cfg, None, causal=False)
    elif cfg.mla is not None:
        x = x + attn.mla_forward(p["mixer"], h, cfg, mixer_cache, pos=pos)
    else:
        x = x + attn.gqa_forward(p["mixer"], h, cfg, mixer_cache, causal=True, pos=pos)
    if mixer == "attn_xattn":
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + attn.cross_attn_forward(p["xattn"], h, memory, cfg,
                                        None if cache is None else cache["xattn"], pos=pos)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, zero
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_mod.moe_forward(p["ffn"], h, cfg)
        return x + y, aux
    return x + mlp_forward(p["ffn"], h), zero


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
    context_fn = None
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    context_fn = recompute_in_mesh(context_fn)
    if context_fn is not None:
        kw["context_fn"] = context_fn
    return lambda *args: checkpoint(fn, *args, **kw)


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` layer slices of a stacked tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients once, where ``t[r]`` would add
    ``n`` zero-padded full-size ones."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p, r=r: p[r], parts) for r in range(n)]


def stack_forward(stack_params: Dict[str, Any], x: torch.Tensor, cfg, plan: Plan,
                  caches: Optional[Dict[str, Any]] = None, *,
                  memory: Optional[torch.Tensor] = None, pos: Optional[int] = None):
    """Run a stack over ``caches`` (laid out like the parameters), its
    cross-attention layers over ``memory``.  Returns (x, caches, aux).

    Modes: train (``caches`` None: no cache, each prefix layer and each
    period under :func:`_remat`, ``memory`` an input of each; returns (x,
    None, aux) with the aux loss summed over the prefix, then the
    periods), prefill (``pos`` None: each layer writes its cache of
    positions ``[0, S)``, and each cross-attention the memory's keys and
    values, into its slice of the caches) and decode (``pos`` the write
    slot of the one new token; no ``memory``: its keys and values are in
    the caches).  Either way the caches are written in place, and the same
    caches come back; their aux is the prefix's alone, as in the JAX
    package.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is None:
        if pos is not None:
            raise ValueError("stack_forward: decode needs the caches")
        for kind, layer_p in zip(plan.prefix, stack_params["prefix"]):
            one = lambda p, xx, mem, kind=kind: block_forward(kind, gather_fsdp(p), xx, cfg,
                                                              memory=mem)
            x, a = _remat(one, cfg)(layer_p, x, memory)
            aux = aux + a

        def period(x, layer_p, memory):
            layer_p = gather_fsdp(layer_p)
            aux_l = torch.zeros((), dtype=torch.float32, device=x.device)
            for j, kind in enumerate(plan.period):
                x, a = block_forward(kind, layer_p[str(j)], x, cfg, memory=memory)
                aux_l = aux_l + a
            return x, aux_l

        body = _remat(period, cfg)
        for layer_p in _unstack(stack_params["scan"], plan.repeats):
            x, a = body(x, layer_p, memory)
            aux = aux + a
        return x, None, aux
    for i, kind in enumerate(plan.prefix):
        x, a = block_forward(kind, gather_fsdp(stack_params["prefix"][i]), x, cfg,
                             memory=memory, cache=caches["prefix"][i], pos=pos)
        aux = aux + a
    for r in range(plan.repeats):
        layer_p = tree_map(lambda t: layer_at(t, r), stack_params["scan"])
        layer_c = tree_map(lambda t: layer_at(t, r), caches["scan"])
        for j, kind in enumerate(plan.period):
            x, _ = block_forward(kind, gather_fsdp(layer_p[str(j)]), x, cfg, memory=memory,
                                 cache=layer_c[str(j)], pos=pos)
    return x, caches, aux


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def stack_cache_axes(specs: Dict[str, Any]) -> Dict[str, Any]:
    """The logical axes of every leaf of a cache tree of
    :func:`stack_cache_specs`, a tree of tuples shaped like it."""
    return tree_map(lambda t: t.logical_axes, specs)


def stack_cache_specs(cfg, plan: Plan, batch: int, max_len: int,
                      mem_len: int = 0) -> Dict[str, Any]:
    """The cache tree of a stack as ``meta`` tensors (shapes and dtypes):
    ``{"prefix": [layer, ...], "scan": stacked}``, each layer's by its kind:
    a Mamba layer's conv tails and state (no length axis: ``max_len``
    sizes only the self-attention caches), a cross-attention's memory keys
    and values of ``mem_len`` slots (``"mixer"`` for ``xattn``, ``"xattn"``
    beside the self-attention's for ``attn_xattn``), else its MLA cache
    when ``cfg.mla`` is set, else its GQA cache.  Each leaf carries its
    logical axes (``logical_axes``; a stacked leaf's led by
    ``"layers"``), which place a cache on a mesh
    (:func:`stack_cache_axes`)."""
    def layer(kind):
        _check_kind(kind)
        mixer = kind[0]
        if mixer == "mamba":
            return {"mixer": mb.mamba_cache_spec(cfg, batch)}
        if mixer == "xattn":
            return {"mixer": attn.cross_cache_spec(cfg, batch, mem_len)}
        spec = attn.mla_cache_spec if cfg.mla is not None else attn.gqa_cache_spec
        out = {"mixer": spec(cfg, batch, max_len)}
        if mixer == "attn_xattn":
            out["xattn"] = attn.cross_cache_spec(cfg, batch, mem_len)
        return out

    per = {str(j): layer(kind) for j, kind in enumerate(plan.period)}
    scan = (tree_map(lambda t: _stacked(t, t.new_empty((plan.repeats, *t.shape))), per)
            if plan.repeats else None)
    return {"prefix": [layer(kind) for kind in plan.prefix], "scan": scan}
