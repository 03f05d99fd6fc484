"""Mixture-of-Experts FFN with capacity-based dispatch (counterpart of
:mod:`repro.models.moe`, its single-device path).

Routing is top-k over a learned router; dispatch is the sort-based
"dropped-token" scheme with static shapes, as in the JAX package:

  1. expand tokens × top-k hits, stable-sort by expert id;
  2. slot = rank within the expert group (the cummax trick); hits beyond
     the per-expert ``capacity`` are dropped;
  3. scatter into an (E, C, D) buffer, run all experts as batched matrix
     products, gather back with gate weighting.

The JAX package has no Pallas kernel here: its expert products are plain
einsums outside any kernel, so the port's are ``torch.bmm`` (large
matrix products).  With ``dispatch_groups = G`` the tokens split into G
groups of ``B·S / G``, each routed, sized (its capacity from its own
tokens), dispatched and combined on its own, and the aux loss is the
mean over the groups (the reference's dp-grouped dispatch).  With
``use_shard_map`` under a mesh that has a ``model`` axis, each ``model``
rank runs its ``E/n`` experts over every token and the parts are summed
over the axis (:func:`_moe_expert_parallel`, the reference's
``shard_map`` body).

The other paths on a mesh (a DTensor x) run on each rank's own work
(:func:`_moe_on_mesh`): its own rows over the batch axes
(:func:`repro_torch.distributed.sharding.batch_rows`) and its ``E/n``
experts over ``model`` (the reference constrains the dispatch buffers
to ``act_expert`` → ``model``).  Grouped, a rank takes its own ``G /
n_batch`` groups (the reference places the groups on the data axes);
plain, the routing stays global (the router runs on the call's rows
gathered over the batch axes, capacity from all ``B·S``) and the rank
emits its own rows' hits alone.  Each rank fills the weighted hit rows of
its experts and zeros elsewhere, the rows are summed over ``model``
exactly (a value plus zeros), and each token's rows combined as below, so
the output is the unsharded path's bit for bit.  DTensor has no rules
for the sorted dispatch: it runs on plain local tensors.

Two places keep the card's results repeatable and the JAX package's:

* top-k: ``jax.lax.top_k`` puts the lower index first on ties, and
  ``torch.topk`` promises no order; the port takes the first k of a
  stable descending sort;
* the combine: JAX adds each hit's weighted output into its token's row
  with a scatter-add, which on the card (``index_add_``) would sum a
  token's k rows with atomics in any order.  The port un-permutes the
  rows to ``(N, k, D)`` and sums each token's k rows in the sort's order
  (ascending expert id; JAX's sequential scatter on the CPU adds them in
  that order too), so two runs give the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    axis_names,
    batch_rows,
    copy_to_group,
    current_mesh,
    from_global,
    shard,
    sum_over_group,
    use_mesh,
)
from repro_torch.models.layers import make_param, mlp_forward


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    n_shared: int = 0            # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01       # load-balance loss coefficient
    z_coef: float = 1e-3         # router z-loss
    moe_every: int = 1           # hybrid plan: MoE FFN where idx % moe_every == moe_every - 1
    first_dense: bool = False    # layer 0 uses a dense FFN (DeepSeek-V2)
    use_shard_map: bool = False  # expert parallelism over 'model' under a mesh
    dispatch_groups: int = 0     # >0 = dp-grouped dispatch


def init_moe(gen, cfg, device: torch.device) -> Dict[str, Any]:
    """Router (f32 in every dtype, as in JAX), the routed experts'
    ``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down`` ``(E, f, d)``, and the
    shared experts' dense MLP of width ``n_shared · f``."""
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    dt = cfg.torch_dtype
    p = {
        "w_router": make_param(gen, (d, e), torch.float32, device, axes=("embed", "experts")),
        "w_gate": make_param(gen, (e, d, f), dt, device,
                             axes=("experts", "embed", "expert_mlp")),
        "w_up": make_param(gen, (e, d, f), dt, device, axes=("experts", "embed", "expert_mlp")),
        "w_down": make_param(gen, (e, f, d), dt, device, scale=f ** -0.5,
                             axes=("experts", "expert_mlp", "embed")),
    }
    if m.n_shared:
        fs = m.n_shared * f
        p["shared"] = {
            "w_gate": make_param(gen, (d, fs), dt, device, axes=("embed", "mlp")),
            "w_up": make_param(gen, (d, fs), dt, device, axes=("embed", "mlp")),
            "w_down": make_param(gen, (fs, d), dt, device, scale=fs ** -0.5,
                                 axes=("mlp", "embed")),
        }
    return p


def _route(x32: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Returns (gates (N,k) f32, experts (N,k), load-balance loss, z-loss).
    x32: (N, D) f32."""
    return _route_logits(x32 @ w_router, top_k)


def _route_logits(logits: torch.Tensor, top_k: int):
    """:func:`_route` from the router's logits (N, E)."""
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, the lower index first on ties
    experts = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    if _pin is not None:
        experts = _pin.route(experts)
    gates, aux, z = _gates_and_aux(logits, probs, experts)
    return gates, experts, aux, z


def _gates_and_aux(logits: torch.Tensor, probs: torch.Tensor, experts: torch.Tensor):
    """The chosen experts' probabilities renormalised to sum to one, the
    load-balance loss (top-1 density against mean probability) and the
    router z-loss."""
    gates = probs.gather(1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = probs.shape[1]
    density = F.one_hot(experts[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(density * probs.mean(dim=0))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gates.float(), aux, z


@contextlib.contextmanager
def _tf32_matmuls() -> Iterator[None]:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, returned in f32 and never rounded to the operands'
    dtype: JAX's ``preferred_element_type=jnp.float32``.  bf16 operands go
    in as f32 (``torch.bmm(..., out_dtype=torch.float32)``, forward and
    backward, failed on the H100 machine's PyTorch build).  On
    the card the tensor cores' TF32 path is switched on for this product
    alone: a bf16 value is exact in TF32's 10-bit mantissa, so the products
    are exact and summed in f32; the backward's products (an f32
    cotangent) run later, in full f32.  The flag is process-wide, so
    another thread's f32 matmul during this product would run in TF32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        with _tf32_matmuls():
            return torch.bmm(a.float(), b.float())
    return torch.bmm(a.float(), b.float())


def _dispatch_rows(x: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   e_offset: int, capacity: int, lo: int = 0, group=None) -> torch.Tensor:
    """Sort-based dispatch → batched expert FFN → each hit's weighted row.

    ``experts`` (N, k): the global expert ids of every token of the
    routing call (the capacity's sort runs over all of them).  ``x``
    (n, D) and ``gates`` (n, k) f32: the rows and gates of tokens ``[lo,
    lo + n)`` of the call, whose hits this call emits; only their rows
    enter the buffers (the other tokens' slots stay zero: an expert's
    output row depends on its own input row alone).  The weights hold the
    experts ``e_offset + [0, E_local)``.  Returns (n, k, D): each token's
    hits in ascending expert id, the expert's output times its gate where
    the expert is held here and kept the hit within ``capacity``, else
    zeros.  With ``group`` (the ranks that hold the other experts) the hit
    rows and gates are copied to the group: a hit's gradient is non-zero
    on its expert's rank alone, so their sum over the group is exact."""
    N, k = experts.shape
    n, D = x.shape
    e_local = w_gate.shape[0]
    dev = x.device
    sort_key = experts.reshape(-1) - e_offset                # (N*k,)
    sort_key = torch.where((sort_key >= 0) & (sort_key < e_local), sort_key, e_local)
    order = torch.argsort(sort_key, stable=True)             # others → the sentinel e_local
    s_e = sort_key[order]
    idx = torch.arange(N * k, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), s_e[1:] != s_e[:-1]])
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    slot = idx - group_start
    ok = (s_e < e_local) & (slot < capacity)
    dest = torch.where(ok, s_e * capacity + slot, e_local * capacity)

    # the emitted hits, each token's in ascending expert id, and their places in the sort
    by_expert = torch.argsort(experts[lo:lo + n], dim=-1, stable=True)      # (n, k)
    hit = (torch.arange(lo, lo + n, device=dev)[:, None] * k + by_expert).reshape(-1)
    at = torch.empty_like(order).scatter_(0, order, idx)[hit]
    dest, ok = dest[at], ok[at]
    gate = gates.gather(1, by_expert).reshape(-1)
    xh = x[:, None, :].expand(n, k, D).reshape(n * k, D)
    if group is not None:
        xh, gate = copy_to_group(xh, group), copy_to_group(gate, group)

    # row E*C is the sentinel that the dropped and foreign hits write, then thrown away
    buf = x.new_zeros((e_local * capacity + 1, D)).index_put((dest,), xh)
    buf = shard(buf[:-1].reshape(e_local, capacity, D), "act_expert", None, None)

    h = F.silu(bmm_f32(buf, w_gate)).to(x.dtype) * torch.bmm(buf, w_up)
    h = shard(h, "act_expert", None, None)
    out = torch.bmm(h, w_down).reshape(e_local * capacity, D)     # (E_local·C, D)
    picked = torch.where(ok[:, None], out[torch.clamp(dest, max=e_local * capacity - 1)], 0.0)
    return (picked * gate[:, None].to(x.dtype)).reshape(n, k, D)


def _combine(rows: torch.Tensor) -> torch.Tensor:
    """Each token's k rows (n, k, D) summed in their order (ascending
    expert id): JAX adds each hit's weighted output into its token's row
    with a scatter-add, which on the card (``index_add_``) would sum a
    token's rows with atomics in any order."""
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y


def _dispatch_ffn(x: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  e_offset: int, capacity: int) -> torch.Tensor:
    """Sort-based dispatch → batched expert FFN → weighted combine.
    x (N, D); gates (N, k) f32; experts (N, k) global ids."""
    return _combine(_dispatch_rows(x, gates, experts, w_gate, w_up, w_down, e_offset,
                                   capacity))


def capacity_of(n_tokens: int, m: MoEConfig) -> int:
    """Slots an expert holds for a call that routes ``n_tokens`` tokens:
    the JAX package's Python float arithmetic, exactly."""
    return max(8, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def _aux_of(aux: torch.Tensor, z: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """A routing call's load-balance loss plus its scaled z-loss."""
    return aux + m.z_coef / max(m.aux_coef, 1e-9) * z


def _routed(p: Dict, xf: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One routing call over the tokens ``xf`` (N, D): the dispatched
    experts' output (N, D), capacity from N, and the load-balance plus
    scaled z-loss."""
    gates, experts, aux, z = _route(xf.float(), p["w_router"], m.top_k)
    y = _dispatch_ffn(xf, gates, experts, p["w_gate"], p["w_up"], p["w_down"], 0,
                      capacity_of(xf.shape[0], m))
    return y, _aux_of(aux, z, m)


def _moe_plain(p: Dict, x: torch.Tensor, m: MoEConfig, groups: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over every token of x (B, S, D): one routing
    call, or ``groups`` calls of ``B·S / groups`` tokens each (the aux the
    groups' mean)."""
    B, S, D = x.shape
    if groups:
        G, n = groups, B * S
        if n % G != 0:
            raise ValueError(f"{n} tokens do not split into dispatch_groups={G}")
        xg = shard(x.reshape(G, n // G, D), "batch", None, None)
        ys, auxs = zip(*(_routed(p, g, m) for g in xg))
        y = shard(torch.stack(ys)[:, None], "batch", None, None, None)
        return y.reshape(B, S, D), torch.stack(auxs).mean()
    y, aux = _routed(p, x.reshape(-1, D), m)
    return y.reshape(B, S, D), aux


def _expert_parallel(x: torch.Tensor, w_router: torch.Tensor, experts: Tuple[torch.Tensor, ...],
                     e_offset: int, group, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``model`` rank's part of the routed experts, summed over the
    group: every token of x (B, S, D) routed with the replicated f32
    router, dispatched to this rank's experts ``e_offset + [0, E/n)`` with
    the whole call's capacity, the parts summed in f32 and cast back; the
    aux the mean over the group (every rank's is the same)."""
    B, S, D = x.shape
    n = dist.get_world_size(group)
    x = copy_to_group(x, group)
    w_router = copy_to_group(w_router, group)
    xf = x.reshape(-1, D)
    gates, hits, aux, z = _route(xf.float(), w_router, m.top_k)
    y = _dispatch_ffn(xf, gates, hits, *experts, e_offset, capacity_of(xf.shape[0], m))
    y = sum_over_group(y.float(), group).to(x.dtype)
    aux = sum_over_group(_aux_of(aux, z, m), group) / n
    return y.reshape(B, S, D), aux


def moe_forward(p: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) → (y, aux_loss).  The reference's order of paths: grouped
    dispatch when ``dispatch_groups`` is set and no mesh is active or
    ``use_shard_map`` is off; expert parallelism over ``model`` when an
    active mesh has that axis and ``use_shard_map`` is on; else one
    routing call over every token.  A DTensor x takes the grouped or the
    plain path on each rank's own work (:func:`_moe_on_mesh`)."""
    m: MoEConfig = cfg.moe
    mesh = current_mesh()
    grouped = bool(m.dispatch_groups) and (mesh is None or not m.use_shard_map)
    groups = m.dispatch_groups if grouped else 0
    if not grouped and m.use_shard_map and mesh is not None and "model" in axis_names(mesh):
        y, aux = _moe_expert_parallel(p, x, m, mesh)
    elif isinstance(x, DTensor):
        y, aux = _moe_on_mesh(p, x, m, groups)
    else:
        y, aux = _moe_plain(p, x, m, groups)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x)
    return shard(y, "batch", "act_seq", "act_embed"), m.aux_coef * aux


class _RouterLogits(torch.autograd.Function):
    """The router's logits of every token of a routing call, computed on
    the call's rows gathered over the batch ranks (the rows the unsharded
    path routes, so the routing's bits are the same); the backward takes
    this rank's rows ``[lo, lo + n)`` of the gradient alone.  Every rank
    computes the routing alike, the load-balance loss's gradient reaching
    every row, so each row's gradient is whole on its own rank and the
    router's gradient is partial over the batch ranks."""

    @staticmethod
    def forward(ctx, x, w, x_all, lo):
        ctx.save_for_backward(x, w)
        ctx.lo = lo
        return x_all.float() @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g[ctx.lo:ctx.lo + x.shape[0]]
        return (g @ w.t()).to(x.dtype), x.float().t() @ g, None, None


def _moe_on_mesh(p: Dict, x: torch.Tensor, m: MoEConfig, groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of a DTensor x (B, S, D), each rank on its own
    rows over the batch axes and its ``E/n`` experts over ``model``
    (all of them where the mesh has no ``model`` axis, or where it splits
    the batch).

    Grouped (``groups`` = G): G must be a multiple of the batch ranks; the
    rank routes, sizes and dispatches its own ``G / n_batch`` groups, each
    ``B·S / G`` contiguous tokens of its rows, and the aux is the mean of
    all G groups' (gathered over the batch axes).  Plain: the router runs
    on the whole call's rows (:class:`_RouterLogits`), capacity from
    ``B·S``, and the rank emits its own rows' hits.  Either way the hit
    rows are summed over ``model`` exactly and combined in ascending expert
    id.  The experts' and the router's gradients come back ``Partial``
    over the batch axes (the rank's tokens' share), as the train step's
    gradient sync expects; ``n_experts % n_model`` ≠ 0 raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, S, D = x.shape
    xl, rows = batch_rows(x)
    mesh = rows.mesh
    names = axis_names(mesh)
    md = names.index("model") if "model" in names else None
    if md in rows.dims:
        md = None
    n_model = 1 if md is None else mesh.size(md)
    if m.n_experts % n_model != 0:
        raise ValueError(f"{m.n_experts} experts do not shard over model axis of {n_model}")
    e_local = m.n_experts // n_model
    e0 = 0 if md is None else mesh.get_local_rank(md) * e_local
    group = None if n_model == 1 else mesh.get_group(md)

    whole = tuple(Replicate() for _ in names)
    ours = tuple(Shard(0) if i == md else Replicate() for i in range(len(names)))

    def local(t, pl):
        if not isinstance(t, DTensor):       # the global value every rank holds
            t = from_global(t, mesh, whole)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        grad = tuple(Partial() if i in rows.dims else q for i, q in enumerate(pl))
        return t.to_local(grad_placements=grad)

    w_router = local(p["w_router"], whole)
    ws = tuple(local(p[k], ours) for k in ("w_gate", "w_up", "w_down"))
    xf = xl.reshape(-1, D)
    with use_mesh(None):
        if groups:
            G, N = groups, B * S
            if N % G != 0:
                raise ValueError(f"{N} tokens do not split into dispatch_groups={G}")
            if G % rows.ranks != 0 or B % rows.ranks != 0:
                raise ValueError(f"dispatch_groups={G} over a batch of {B} rows do not split "
                                 f"over {rows.ranks} batch ranks")
            parts, auxs = [], []
            for xg in xf.split(N // G):      # this rank's groups
                gates, experts, aux, z = _route(xg.float(), w_router, m.top_k)
                parts.append(_dispatch_rows(xg, gates, experts, *ws, e0,
                                            capacity_of(N // G, m), group=group))
                auxs.append(_aux_of(aux, z, m))
            hit_rows = parts[0] if len(parts) == 1 else torch.cat(parts)
            aux = rows.gather(torch.stack(auxs), G).mean()
        else:
            lo = rows.offset * S
            with torch.no_grad():
                x_all = rows.gather(xl).reshape(-1, D)
            logits = _RouterLogits.apply(xf, w_router, x_all, lo)
            del x_all
            gates, experts, aux, z = _route_logits(logits, m.top_k)
            hit_rows = _dispatch_rows(xf, gates[lo:lo + xf.shape[0]], experts, *ws, e0,
                                      capacity_of(B * S, m), lo=lo, group=group)
            aux = _aux_of(aux, z, m)
        if group is not None:
            hit_rows = sum_over_group(hit_rows, group)
        y = _combine(hit_rows).reshape(xl.shape)
    return rows.wrap(y), DTensor.from_local(aux, mesh, whole)


def _moe_expert_parallel(p: Dict, x: torch.Tensor, m: MoEConfig, mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the mesh's ``model`` axis (the reference's
    ``shard_map`` body): each rank holds ``E/n`` experts.  A DTensor x is
    gathered whole (the whole call's tokens and capacity, as the
    reference's ``local`` sees them) and the rank's experts taken from
    their shards; plain tensors are the global values every rank holds,
    and each rank takes its experts' slice (their gradients summed over
    the group, so each rank's is whole).  ``n_experts % n`` ≠ 0 raises."""
    from torch.distributed.tensor import Replicate, Shard

    md = axis_names(mesh).index("model")
    n = mesh.size(md)
    if m.n_experts % n != 0:
        raise ValueError(f"{m.n_experts} experts do not shard over model axis of {n}")
    e_local = m.n_experts // n
    e0 = mesh.get_local_rank("model") * e_local
    group = mesh.get_group("model")
    keys = ("w_gate", "w_up", "w_down")
    with use_mesh(None):
        if not isinstance(x, DTensor):
            ws = tuple(copy_to_group(p[k], group)[e0:e0 + e_local] for k in keys)
            return _expert_parallel(x, p["w_router"], ws, e0, group, m)
        whole = [Replicate()] * mesh.ndim
        ours = [Shard(0) if i == md else Replicate() for i in range(mesh.ndim)]
        xl = x.redistribute(mesh, whole).to_local()
        rl = p["w_router"].redistribute(mesh, whole).to_local()
        ws = tuple(p[k].redistribute(mesh, ours).to_local() for k in keys)
        y, aux = _expert_parallel(xl, rl, ws, e0, group, m)
    return DTensor.from_local(y, mesh, whole), DTensor.from_local(aux, mesh, whole)


class RoutingPin:
    """What :func:`pinned_routing` records and replays: ``log`` the experts
    of every routing call in order; ``flips`` the (token, call) pairs whose
    own top-k differed from the replayed one."""

    def __init__(self):
        self.log: List[torch.Tensor] = []
        self.replaying = False
        self.at = 0
        self.flips = 0

    def replay(self, calls: Optional[List[torch.Tensor]] = None) -> None:
        """From now on each routing call takes the next experts of ``calls``
        (default: the recorded ``log``), each ``(tokens of the call, k)``."""
        if calls is not None:
            self.log = list(calls)
        self.replaying, self.at, self.flips = True, 0, 0

    def route(self, experts: torch.Tensor) -> torch.Tensor:
        """The experts a routing call takes, given its own top-k."""
        if not self.replaying:
            self.log.append(experts)
            return experts
        want = self.log[self.at]
        self.at += 1
        self.flips += int((experts.sort(-1).values != want.sort(-1).values).any(-1).sum())
        return want


_pin: Optional[RoutingPin] = None


@contextlib.contextmanager
def pinned_routing() -> Iterator[RoutingPin]:
    """Record, then replay, the experts every MoE routing call picks.

    Two runs that differ only in where their sums round (the attention
    kernels against their plain versions, two tile sizes) can pick a
    different k-th expert for a token whose router probabilities nearly
    tie, and that moves the token's output by that expert's share.  Under
    this context the first run records each call's experts; after
    ``pin.replay()`` each call takes the recorded experts of the same call
    (its gates and load-balance loss from its own probabilities, by the
    same :func:`_gates_and_aux` as an unpinned call), so the two runs
    route alike and what remains between them is rounding;
    ``pin.replay(calls)`` replays other calls' experts (rows of a longer
    run's calls, say).  ``pin.flips`` counts the tokens whose own choice
    differed."""
    global _pin
    outer, _pin = _pin, RoutingPin()
    try:
        yield _pin
    finally:
        _pin = outer


def moe_forward_dense_ref(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: every expert computed for every token, exact soft combine
    with the same top-k gates (no capacity drops)."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    gates, experts, _, _ = _route(xf.float(), p["w_router"], m.top_k)
    hg = torch.einsum("nd,edf->nef", xf.float(), p["w_gate"].float())
    h = F.silu(hg).to(x.dtype) * torch.einsum("nd,edf->nef", xf, p["w_up"])
    out_all = torch.einsum("nef,efd->ned", h, p["w_down"])    # (N, E, D)
    sel = out_all.gather(1, experts[..., None].expand(-1, -1, D))   # (N, k, D)
    y = (sel * gates[..., None].to(x.dtype)).sum(dim=1)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf)
    return y.reshape(B, S, D)
