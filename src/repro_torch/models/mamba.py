"""Mamba2's SSD (state-space duality) layer, chunked (counterpart of
:mod:`repro.models.mamba`).

Train and prefill run the chunked SSD algorithm (Dao & Gu, 2024): the
sequence is tiled into chunks of ``chunk`` steps; within a chunk the
interactions are a masked, decay-weighted attention-like batched product,
across chunks they ride the per-chunk states.  As in the JAX package
everything heavy is a matrix product (``torch.einsum``, f32 accumulation),
with no per-step recurrence and no kernel of the port's own: the JAX
package computes these products outside any Pallas kernel.

Decode holds the recurrent state explicitly: ``state ← exp(dt·A)·state +
dt·B·x`` per token, O(1) in the sequence length.

Two places differ from the JAX package's arithmetic, neither in a forward
value:

* the within-chunk decay matrix ``exp(cum_i − cum_j)`` is masked to −inf
  above the diagonal *before* the ``exp``, where the JAX package takes the
  ``exp`` of the whole (Q, Q) block and masks after it.  Above the diagonal
  the exponent is positive and grows with a chunk's decay sum; past 88.7
  the f32 ``exp`` overflows, and the ``where``'s backward gives 0 · inf =
  NaN in ``∂/∂dt``.  Masked first, the same forward has finite gradients;
* the cross-chunk recurrence ``s_c = d_c · s_{c−1} + b_c`` (a
  ``jax.lax.associative_scan`` in JAX, which PyTorch lacks) is one product
  with the lower-triangular (nc+1, nc+1) matrix of chunk-to-chunk decays,
  ``exp`` of segment sums of the chunks' log decays (:func:`_segsum`: a
  masked ``cumsum``, masked to −inf above the diagonal before its
  ``exp``), the initial state entering as chunk −1.  One batched product
  in place of ``nc`` dependent steps (32 at S=2,048): the decays are
  products of the same factors, taken as ``exp`` of their log sums, so the
  states differ from the scan's by f32 roundings (``tests/
  test_torch_mamba.py`` holds them to ``1e-5`` of max|y| in f32).

The caches are written in place, as the port's attention writes its own
(:mod:`repro_torch.models.transformer`): a prefill writes the conv tails
and the f32 state into the layer's cache; a decode step reads the old
state and tails into new tensors before it overwrites them.

The JAX package's ``shard(...)`` annotations stand at its call sites
(:func:`repro_torch.distributed.sharding.shard`): the identity outside
``use_mesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import copy_into, rows_local, shard
from repro_torch.models.layers import const_param, make_param, rms_norm, with_axes


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 64
    compute_dtype: str = "float32"  # bf16 for the O(Q²) SSD intermediates
                                    # (decay and score tensors)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


def init_mamba(gen, cfg, device: torch.device) -> Dict[str, Any]:
    """One Mamba2 mixer: the projections in the model dtype; ``dt_bias``,
    ``a_log`` and ``d_skip`` f32 in every model dtype, as in JAX.
    ``dt_bias`` is softplus⁻¹ of a log-uniform draw in [1e-3, 0.1]."""
    s: SSMConfig = cfg.ssm
    d, dt = cfg.d_model, cfg.torch_dtype
    di, h = s.d_inner(d), s.n_heads(d)
    gn = 2 * s.n_groups * s.d_state
    f32 = torch.float32
    if device.type == "meta":
        dt_bias = torch.empty((h,), dtype=f32, device=device)
    else:
        u = torch.rand((h,), generator=gen, dtype=f32, device=device)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "w_x": make_param(gen, (d, di), dt, device, axes=("embed", "ssm_inner")),
        "w_z": make_param(gen, (d, di), dt, device, axes=("embed", "ssm_inner")),
        "w_bc": make_param(gen, (d, gn), dt, device, axes=("embed", None)),
        "w_dt": make_param(gen, (d, h), dt, device, axes=("embed", "ssm_heads")),
        "dt_bias": with_axes(dt_bias, ("ssm_heads",)),
        "a_log": const_param((h,), f32, device, 0.0, axes=("ssm_heads",)),
        "d_skip": const_param((h,), f32, device, 1.0, axes=("ssm_heads",)),
        "conv_x": make_param(gen, (s.d_conv, di), dt, device, scale=s.d_conv ** -0.5,
                             axes=(None, "ssm_inner")),
        "conv_bc": make_param(gen, (s.d_conv, gn), dt, device, scale=s.d_conv ** -0.5,
                              axes=(None, None)),
        "norm": const_param((di,), dt, device, 1.0, axes=("norm",)),
        "w_out": make_param(gen, (di, d), dt, device, axes=("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along the sequence.  x: (B,S,C); w: (K,C).

    Returns (y, new_tail): the K shifted products summed in x's dtype in
    the JAX order, SiLU in f32 cast back; the tail is the raw last K−1
    inputs (a new tensor, never a view of ``tail``), for decode."""
    K, S = w.shape[0], x.shape[1]
    if tail is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+K-1, C)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y.float()).to(x.dtype), xp[:, -(K - 1):]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) → (..., T, T) with ``out[i, j] = x[j+1] + ... + x[i]`` for
    j <= i (0 on the diagonal) and −inf above it: a masked ``cumsum``
    (no difference of two large prefix sums), masked before any ``exp``."""
    T = x.shape[-1]
    xx = x[..., :, None].expand(*x.shape, T)                          # [k, j] = x[k]
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    ss = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return ss.masked_fill(~keep, -math.inf)


def _ssd_chunked(
    xh: torch.Tensor,     # (B,S,H,P)
    dt: torch.Tensor,     # (B,S,H)   f32, post-softplus
    a: torch.Tensor,      # (H,)      f32, negative
    B_: torch.Tensor,     # (B,S,G,N)
    C_: torch.Tensor,     # (B,S,G,N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,    # (B,H,P,N)
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    B, S0, H, Pd = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    # Ragged lengths: pad with dt=0 steps (decay 1, increment 0: the state
    # passes through unchanged); the padded outputs are sliced off below.
    S = -(-S0 // chunk) * chunk
    if S != S0:
        xh = F.pad(xh, (0, 0, 0, 0, 0, S - S0))
        dt = F.pad(dt, (0, 0, 0, S - S0))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, S - S0))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, S - S0))
    nc, Q = S // chunk, chunk
    hg = H // G                                        # heads per group
    f32 = torch.float32

    xh_c = xh.reshape(B, nc, Q, H, Pd)
    dt_c = dt.reshape(B, nc, Q, H).float()
    b_c = B_.reshape(B, nc, Q, G, N)
    c_c = C_.reshape(B, nc, Q, G, N)

    da = dt_c * a                                      # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                      # within-chunk cumsum
    # Within-chunk decay L[i,j] = exp(cum_i - cum_j), lower-triangular; the
    # O(Q²) tensors may run in bf16, the cross-chunk recurrence stays f32.
    cdt = getattr(torch, compute_dtype)
    cum_c = cum.to(cdt)                  # cast BEFORE the O(Q²) broadcast
    seg = cum_c[:, :, :, None, :] - cum_c[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    L = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], -math.inf))

    # Diagonal (within-chunk) term: scores over the group, decayed per head.
    scores = torch.einsum("bcign,bcjgn->bcijg", c_c.to(cdt), b_c.to(cdt))
    scores_h = scores.repeat_interleave(hg, dim=-1)                   # (B,nc,Q,Q,H)
    w_diag = scores_h * L * dt_c[:, :, None, :, :].to(cdt)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w_diag.to(f32), xh_c.to(f32))

    # Per-chunk input state: decay-to-end weighted sum of B x^T.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                    # (B,nc,Q,H)
    b_h = b_c.repeat_interleave(hg, dim=-2)                           # (B,nc,Q,H,N)
    bx = torch.einsum("bcjhn,bcjhp->bchpn",
                      b_h.to(f32) * (dt_c * decay_end)[..., None], xh_c.to(f32))

    # Across chunks: the state after chunk c is sum_{c' <= c} of chunk c''s
    # increment decayed through chunks c'+1..c, and the initial state as
    # chunk -1 with no increment of its own.
    s0 = (xh.new_zeros((B, H, Pd, N), dtype=f32) if init_state is None
          else init_state.to(f32))
    chunk_log = F.pad(cum[:, :, -1, :].transpose(1, 2), (1, 0))       # (B,H,nc+1)
    decay = torch.exp(_segsum(chunk_log))                             # (B,H,nc+1,nc+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay,
                          torch.cat([s0[:, None], bx], dim=1))        # (B,nc+1,H,P,N)
    prev_states, final = states[:, :-1], states[:, -1]

    # Off-diagonal term: contribution of the previous chunks' states.
    c_h = c_c.repeat_interleave(hg, dim=-2)                           # (B,nc,Q,H,N)
    y_off = torch.einsum("bcihn,bchpn->bcihp",
                         c_h.to(f32) * torch.exp(cum)[..., None], prev_states)
    y = (y_diag + y_off).reshape(B, S, H, Pd)[:, :S0]
    return y, final


def _ssd_on_shards(xh, dt, a, B_, C_, chunk: int, compute_dtype: str = "float32"):
    """:func:`_ssd_chunked` of DTensors (under a mesh) on each rank's
    shards: its batch rows and, where the heads split over a mesh
    dimension and the B/C groups are one, its heads (``a`` split alike, B
    and C whole); anything else is gathered first.  A gradient that each
    rank takes from its own share (``a`` over the batch split, B and C
    over the head split) comes back as a partial sum.  DTensor cannot
    place the chunked products' reshapes of a split dimension itself."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import contiguous_stride, from_global

    mesh = xh.device_mesh
    groups = B_.shape[2]
    want = {k: [] for k in ("x", "a", "bc", "st")}
    grad = {k: [] for k in ("a", "bc")}
    for pl in xh.placements:
        if pl == Shard(0):
            rows = (Shard(0), Replicate(), Shard(0), Shard(0))
            grads = (Partial(), Shard(0))
        elif pl == Shard(2) and groups == 1:
            rows = (Shard(2), Shard(0), Replicate(), Shard(1))
            grads = (Shard(0), Partial())
        else:
            rows = (Replicate(),) * 4
            grads = (Replicate(), Replicate())
        for k, r in zip(("x", "a", "bc", "st"), rows):
            want[k].append(r)
        grad["a"].append(grads[0])
        grad["bc"].append(grads[1])

    def local(t, pl, gp=None):
        t = t.redistribute(mesh, pl) if isinstance(t, DTensor) else from_global(t, mesh, pl)
        return t.to_local(grad_placements=gp)

    y, final = _ssd_chunked(local(xh, want["x"]), local(dt, want["x"]),
                            local(a, want["a"], grad["a"]),
                            local(B_, want["bc"], grad["bc"]), local(C_, want["bc"], grad["bc"]),
                            chunk, compute_dtype=compute_dtype)
    B, S, H, P = xh.shape
    wrap = lambda t, pl, shape: DTensor.from_local(t, mesh, pl, shape=torch.Size(shape),
                                                   stride=contiguous_stride(shape))
    return (wrap(y, want["x"], (B, S, H, P)),
            wrap(final, want["st"], (B, H, P, B_.shape[3])))


def _ssd_step(state, dt0, xh0, b0, c0, a, d_skip, hg: int):
    """One decode step of the recurrence → (y (B,H,P) f32, state (B,H,P,N)
    f32): ``state ← exp(dt·A)·state + dt·B·x``, ``y = C·state + D·x``."""
    da = torch.exp(dt0 * a)                                          # (B,H)
    b_h = b0.repeat_interleave(hg, dim=1)                            # (B,H,N)
    c_h = c0.repeat_interleave(hg, dim=1)
    inc = torch.einsum("bhp,bhn->bhpn", dt0[:, :, None] * xh0.float(), b_h.float())
    state = state * da[:, :, None, None] + inc
    y = torch.einsum("bhpn,bhn->bhp", state, c_h.float())
    return y + d_skip[None, :, None] * xh0.float(), state


def mamba_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                  cache: Optional[Dict[str, torch.Tensor]] = None, *,
                  pos: Optional[int] = None) -> torch.Tensor:
    """Mamba2 block over x (B, S, D).

    Train (``cache`` None): the chunked SSD over the whole sequence, no
    cache.  Prefill (``pos`` None): the same, and the conv tails and the
    f32 state go into ``cache`` (``{"conv_x", "conv_bc", "state"}``) in
    place.  Decode (x is (B, 1, D)): the one-step recurrence from the
    cache, whose new tails and state then overwrite the old.  ``pos`` is
    accepted and ignored, as in the JAX package: the state has no length
    axis."""
    s: SSMConfig = cfg.ssm
    B, S, D = x.shape
    di, H = s.d_inner(D), s.n_heads(D)
    G, N, Pd = s.n_groups, s.d_state, s.head_dim

    xz = x @ p["w_x"]
    z = x @ p["w_z"]
    bc_raw = x @ p["w_bc"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])          # (B,S,H) f32
    a = -torch.exp(p["a_log"])                                        # (H,) negative
    xz = shard(xz, "batch", "act_seq", "act_ssm_inner")
    z = shard(z, "batch", "act_seq", "act_ssm_inner")

    decode = cache is not None and pos is not None
    xc, tail_x = _causal_conv(xz, p["conv_x"], cache["conv_x"] if decode else None)
    bc, tail_bc = _causal_conv(bc_raw, p["conv_bc"], cache["conv_bc"] if decode else None)
    B_ = bc[..., :G * N].reshape(B, S, G, N)
    C_ = bc[..., G * N:].reshape(B, S, G, N)
    xh = xc.reshape(B, S, H, Pd)
    if not decode:
        xh = shard(xh, "batch", "act_seq", "act_ssm_heads", None)
        ssd = _ssd_on_shards if isinstance(xh, DTensor) else _ssd_chunked
        y, state = ssd(xh, dt, a, B_, C_, s.chunk, compute_dtype=s.compute_dtype)
        y = y + p["d_skip"][None, None, :, None] * xh.float()
    else:
        if S != 1:
            raise ValueError(f"mamba_forward: decode takes one token, got {S}")
        args = (cache["state"], dt[:, 0], xh[:, 0], B_[:, 0], C_[:, 0])
        if isinstance(xh, DTensor):
            # each rank steps its own rows, every head (DTensor cannot
            # place the head split through the group broadcast)
            a_w, d_w = (t.full_tensor() if isinstance(t, DTensor) else t
                        for t in (a, p["d_skip"]))
            y, state = rows_local(lambda *t: _ssd_step(*t, a_w, d_w, H // G), *args)
        else:
            y, state = _ssd_step(*args, a, p["d_skip"], H // G)
        y = y[:, None]
    if cache is not None:
        copy_into(cache["conv_x"], tail_x)
        copy_into(cache["conv_bc"], tail_bc)
        copy_into(cache["state"], state)

    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    y = shard(y, "batch", "act_seq", "act_ssm_inner")
    return shard(y @ p["w_out"], "batch", "act_seq", "act_embed")


# The cache's logical axes (the reference's): no slot axis, so
# ``kv_cache_seq`` splits nothing here.
MAMBA_CACHE_AXES = {
    "conv_x": ("batch", None, "act_ssm_inner"),
    "conv_bc": ("batch", None, None),
    "state": ("batch", "act_ssm_heads", None, None),
}


def mamba_cache_spec(cfg, batch: int) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) of one Mamba layer's
    cache, each with its logical axes (:data:`MAMBA_CACHE_AXES`): the conv
    tails in the model dtype and the f32 state.  No length axis: a decode
    cache's size does not grow with the sequence."""
    s: SSMConfig = cfg.ssm
    di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = 2 * s.n_groups * s.d_state
    dt = cfg.torch_dtype
    shapes = {"conv_x": ((batch, s.d_conv - 1, di), dt),
              "conv_bc": ((batch, s.d_conv - 1, gn), dt),
              "state": ((batch, H, s.head_dim, s.d_state), torch.float32)}
    return {k: with_axes(torch.empty(shp, dtype=d, device="meta"), MAMBA_CACHE_AXES[k])
            for k, (shp, d) in shapes.items()}
