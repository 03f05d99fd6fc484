"""Shared transformer building blocks (counterpart of
:mod:`repro.models.layers`).

Parameters are plain dicts of tensors in the JAX package's layout, so a
JAX parameter tree converts leaf for leaf (:func:`repro_torch.convert.
lm_params_from_jax`).  Initialisation draws from a ``torch.Generator`` on
the tensors' device with the JAX package's scales (fan-in ``shape[0]**-0.5``
by default, 0.02 for the embedding); the two frameworks give different
numbers from one seed, so parity tests pass weights across instead.  On the
``meta`` device the helpers return shape-and-dtype stand-ins without
drawing (the port's counterpart of the JAX package's abstract init),
each carrying its logical axes (:func:`with_axes`).

Numerics follow the JAX package's cast order exactly, since bf16 parity
depends on it: parameters and activations in ``cfg.dtype``; the norm's
statistics, SiLU and rope in f32, each rounded back to the activation
dtype at the same point as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import (
    batch_rows,
    from_global,
    local_shape_and_offset,
    rows_local,
    shard,
    sum_over_group,
)

# A parameter's logical axes: a name (or None) for each dimension.
Axes = Tuple[Optional[str], ...]


def with_axes(t: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``t`` with its logical axes (one name, or ``None``, a dimension; the
    sharding rules of :mod:`repro_torch.distributed.sharding` map them to
    mesh axes).  A rank that disagrees with the shape raises, as in JAX;
    on the ``meta`` device the axes are kept as ``t.logical_axes``, which
    :func:`repro_torch.models.transformer.abstract_model` reads."""
    if len(axes) != t.dim():
        raise ValueError(f"shape {tuple(t.shape)} and sharding axes {axes} disagree on rank")
    if t.device.type == "meta":
        t.logical_axes = tuple(axes)
    return t


def make_param(gen: Optional[torch.Generator], shape: Tuple[int, ...], dtype,
               device: torch.device, scale: Optional[float] = None, *,
               axes: Axes) -> torch.Tensor:
    """``N(0, 1) · scale`` drawn in f32 and cast to ``dtype``; fan-in
    scaling on the first dimension unless ``scale`` is given.  ``axes``:
    :func:`with_axes`."""
    if device.type == "meta":
        return with_axes(torch.empty(shape, dtype=dtype, device=device), axes)
    if scale is None:
        scale = shape[0] ** -0.5
    return with_axes((torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
                      * scale).to(dtype), axes)


def const_param(shape: Tuple[int, ...], dtype, device: torch.device,
                fill: float = 1.0, *, axes: Axes) -> torch.Tensor:
    if device.type == "meta":
        return with_axes(torch.empty(shape, dtype=dtype, device=device), axes)
    return with_axes(torch.full(shape, fill, dtype=dtype, device=device), axes)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    # rounded to x's dtype before the gamma product, as in JAX
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def init_rms_norm(dim: int, dtype, device: torch.device) -> torch.Tensor:
    return const_param((dim,), dtype, device, 1.0, axes=("norm",))


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama-style split-half layout, in f32.

    x: (..., S, H, D); positions: integer, broadcastable to (..., S).
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., :, None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": make_param(gen, (d_model, d_ff), dtype, device, axes=("embed", "mlp")),
        "w_up": make_param(gen, (d_model, d_ff), dtype, device, axes=("embed", "mlp")),
        "w_down": make_param(gen, (d_ff, d_model), dtype, device, axes=("mlp", "embed")),
    }


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    # SiLU in f32, cast back before the up product, as in JAX
    h = F.silu((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    h = shard(h, "batch", "act_seq", "act_mlp")
    # reduced over the split ``mlp`` here (a no-op off a mesh), as the
    # attention's output projection is: DTensor left alone keeps the sum
    # partial and runs the next layer's products on every rank's partial
    # copy of the whole width
    return shard(h @ p["w_down"], "batch", "act_seq", "act_embed")


def init_embedding(gen, vocab: int, d_model: int, dtype, device) -> torch.Tensor:
    return make_param(gen, (vocab, d_model), dtype, device, scale=0.02,
                      axes=("vocab", "embed"))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, through ``F.embedding``: its backward sums each
    row's gradients in a fixed order (the CPU's and the card's), where
    indexing's ``index_put_`` accumulates across threads in any order.
    A DTensor table (under a mesh) is looked up by
    :func:`_vocab_parallel_lookup`, no rank gathering the table: DTensor's
    own vocabulary-parallel lookup fails to reduce over batch-split
    tokens."""
    if isinstance(table, DTensor):
        return _vocab_parallel_lookup(table, tokens)
    return F.embedding(tokens, table)


def _vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Megatron's vocabulary-parallel embedding on a DTensor table: each
    rank looks its own rows of ``tokens`` (split over the batch axes,
    :func:`repro_torch.distributed.sharding.batch_rows`) up in its own
    shard of the vocabulary (the table's other splits, FSDP's ``embed →
    data``, gathered), a token outside the shard giving a zero row, and
    the rows are summed over the mesh dimensions that split the
    vocabulary: exact, one rank fills each row.  The table's gradient
    comes back partial over the batch axes (each rank's tokens' share)."""
    from torch.distributed.tensor import Partial, Shard

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):     # the global value every rank holds
        tokens = from_global(tokens, mesh, [Replicate()] * mesh.ndim)
    ids, rows = batch_rows(tokens)
    split = tuple(i for i, p in enumerate(table.placements)
                  if p == Shard(0) and i not in rows.dims and mesh.size(i) > 1)
    pl = tuple(Shard(0) if i in split else Replicate() for i in range(mesh.ndim))
    if tuple(table.placements) != pl:
        table = table.redistribute(mesh, pl)
    shape, off = local_shape_and_offset(table.shape, mesh, pl)
    local = table.to_local(grad_placements=tuple(
        Partial() if i in rows.dims else p for i, p in enumerate(pl)))
    if not split:
        return rows.wrap(F.embedding(ids, local))
    ids = ids - off[0]
    keep = (ids >= 0) & (ids < shape[0])
    out = torch.where(keep[..., None], F.embedding(ids.clamp(0, shape[0] - 1), local), 0)
    for d in split:
        out = sum_over_group(out, mesh.get_group(d))
    return rows.wrap(out)


def token_nll(logits: torch.Tensor, targets: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token negative log-likelihood in f32 (``logsumexp`` of the f32
    logits less the target's logit) and whether the argmax hit the
    target."""
    if isinstance(logits, DTensor):     # whole vocabulary rows on each rank
        return rows_local(token_nll, logits, targets)
    logits32 = logits.float()
    gold = logits32.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits32, dim=-1) - gold, logits32.argmax(dim=-1) == targets


def token_mean(nll: torch.Tensor, hit: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked token means of :func:`token_nll`'s outputs → ``(loss,
    {"loss", "accuracy", "tokens"})``, sums over ``max(sum(mask), 1)``
    tokens."""
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = (hit * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross entropy in f32 → ``(loss, {"loss", "accuracy",
    "tokens"})``, the JAX package's arithmetic: ``logsumexp`` of the f32
    logits less the target's logit, masked sums over ``max(sum(mask), 1)``
    tokens."""
    return token_mean(*token_nll(logits, targets), mask)
