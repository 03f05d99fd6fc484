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
mean over the groups (the reference's dp-grouped dispatch, whose groups
GSPMD places on the data axes; here they run one after another).
Expert parallelism over ``model`` (``use_shard_map``) raises
``NotImplementedError``: it waits for ROADMAP A8 item 5's second half.

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
import torch.nn.functional as F

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
    use_shard_map: bool = False  # expert parallelism over 'model' (not ported)
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
    logits = x32 @ w_router                       # (N, E)
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


def _dispatch_ffn(x: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  e_offset: int, capacity: int) -> torch.Tensor:
    """Sort-based dispatch → batched expert FFN → weighted combine.
    x (N, D); gates (N, k) f32; experts (N, k) global ids."""
    n, k = experts.shape
    e_local = w_gate.shape[0]
    dev = x.device
    flat_e = experts.reshape(-1) - e_offset               # (N*k,)
    flat_gate = gates.reshape(-1)
    flat_src = torch.arange(n, device=dev).repeat_interleave(k)
    valid = (flat_e >= 0) & (flat_e < e_local)
    sort_key = torch.where(valid, flat_e, e_local)        # invalid → sentinel
    order = torch.argsort(sort_key, stable=True)
    s_e = sort_key[order]
    idx = torch.arange(n * k, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), s_e[1:] != s_e[:-1]])
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    slot = idx - group_start
    ok = (s_e < e_local) & (slot < capacity)
    dest = torch.where(ok, s_e * capacity + slot, e_local * capacity)

    # row E*C is the sentinel that the dropped hits write, then thrown away
    buf = x.new_zeros((e_local * capacity + 1, x.shape[-1]))
    buf[dest] = x[flat_src[order]]
    buf = buf[:-1].reshape(e_local, capacity, -1)         # (E_local, C, D)

    h = F.silu(bmm_f32(buf, w_gate)).to(x.dtype) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down)                            # (E_local, C, D)

    out_rows = out.reshape(e_local * capacity, -1)
    picked = torch.where(ok[:, None],
                         out_rows[torch.clamp(dest, max=e_local * capacity - 1)], 0.0)
    weighted = picked * flat_gate[order][:, None].to(x.dtype)   # sort order
    # back to (N, k): hit i of the flat layout sits at sorted position inv[i]
    inv = torch.empty_like(order).scatter_(0, order, idx)
    rows = weighted[inv].reshape(n, k, -1)
    # each token's k rows in the sort's order (ascending expert id)
    by_expert = torch.argsort(sort_key.reshape(n, k), dim=-1, stable=True)
    rows = rows.gather(1, by_expert[..., None].expand(-1, -1, rows.shape[-1]))
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def capacity_of(n_tokens: int, m: MoEConfig) -> int:
    """Slots an expert holds for a call that routes ``n_tokens`` tokens:
    the JAX package's Python float arithmetic, exactly."""
    return max(8, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def _routed(p: Dict, xf: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One routing call over the tokens ``xf`` (N, D): the dispatched
    experts' output (N, D), capacity from N, and the load-balance plus
    scaled z-loss."""
    gates, experts, aux, z = _route(xf.float(), p["w_router"], m.top_k)
    y = _dispatch_ffn(xf, gates, experts, p["w_gate"], p["w_up"], p["w_down"], 0,
                      capacity_of(xf.shape[0], m))
    return y, aux + m.z_coef / max(m.aux_coef, 1e-9) * z


def moe_forward(p: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) → (y, aux_loss): one routing call over every token, or
    with ``dispatch_groups`` one a group."""
    m: MoEConfig = cfg.moe
    if m.use_shard_map:
        raise NotImplementedError(
            "MoE expert parallelism over 'model' (use_shard_map) is not ported yet "
            "(ROADMAP A8 item 5, second half)")
    B, S, D = x.shape
    if m.dispatch_groups:
        G, n = m.dispatch_groups, B * S
        if n % G != 0:
            raise ValueError(f"{n} tokens do not split into dispatch_groups={G}")
        ys, auxs = zip(*(_routed(p, xg, m) for xg in x.reshape(G, n // G, D)))
        y, aux = torch.cat(ys).reshape(B, S, D), torch.stack(auxs).mean()
    else:
        y, aux = _routed(p, x.reshape(-1, D), m)
        y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x)
    return y, m.aux_coef * aux


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
