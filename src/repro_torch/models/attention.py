"""GQA and MLA self-attention, and cross-attention (counterpart of
:mod:`repro.models.attention`).

Three execution modes per layer:

* train — full-sequence attention over positions ``0..S-1`` with no
  cache; :func:`blocked_attention` is differentiable (on the card the
  forward and backward flash kernels through
  :class:`repro_torch.kernels.flash_attention.FlashAttentionFn`);
* prefill — full-sequence attention (:func:`blocked_attention`), which on
  the card is the hand-written flash kernel
  (:func:`repro_torch.kernels.ops.flash_attention`), launched once per
  layer; on the CPU its plain tiled version;
* decode — one new token against the KV cache (:func:`decode_attention`),
  plain PyTorch as in the JAX package, where it is plain JAX outside any
  Pallas kernel.  The cache is updated in place (JAX returns an updated
  copy): at full width a copy would move the whole cache every step.

MLA (DeepSeek-V2) caches the compressed ``c_kv`` and the rope key
``k_pe``.  Its train and prefill modes decompress them to per-head keys
and values and run :func:`blocked_attention` with q and k ``qk_nope_dim +
qk_rope_dim`` wide and v ``v_head_dim`` wide (192 and 128 in deepseek-v2:
the flash kernels' (192, 128) pair on the card); its decode attends in the
``kv_lora_rank`` latent space with plain einsums (the absorbed form), as
the JAX package does outside any Pallas kernel.

Cross-attention (the ``vlm`` family's media layers, the ``audio``
decoder's attention over the encoded memory) takes its queries from x and
its keys and values from a memory, with GQA's projection geometry and no
rope; it always runs through :func:`blocked_attention`, non-causal, with
Sq ≠ Skv: in train and prefill over the projected memory, and in decode
one query row over the keys and values the prefill cached (on the card
the flash kernel in every mode, as the JAX package calls
``blocked_attention`` in every mode).  Its cache holds exactly the
memory's length: the prefill refuses a memory of another length than the
cache's slots, where the JAX package pads the cache with zero keys that
then take a share of every decode's softmax.

The JAX package's ``shard(...)`` annotations stand at its call sites
(:func:`repro_torch.distributed.sharding.shard`): the identity outside
``use_mesh``, a DTensor redistribution inside it.  Under a mesh the flash
kernels run on each rank's local shards (:func:`_local_attention`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    contiguous_stride,
    copy_into,
    local_shape_and_offset,
    shard,
    write_slots,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, const_param, make_param, rms_norm, with_axes


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Flash attention.  q: (B,Sq,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv);
    GQA via H=Hkv·G.

    Returns (B,Sq,H,Dv) in q.dtype, softmax statistics in f32.  Ragged
    lengths need no padding, and key tiles above the diagonal are always
    skipped (the JAX ``prune_causal`` walk; it changes no value).  With
    grad on it is differentiable, its backward a kernel on the card.
    DTensor inputs (under ``use_mesh``) run on each rank's local shards
    (:func:`_local_attention`).
    """
    if isinstance(q, DTensor):
        return _local_attention(q, k, v, lambda a, b, c: ops.flash_attention(a, b, c,
                                                                             causal=causal))
    return ops.flash_attention(q, k, v, causal=causal)


def _local_attention(q, k, v, fn):
    """Attention of DTensors, ``fn(q, k, v)`` (:func:`blocked_attention`'s
    kernel, or on the CPU its plain version; :func:`decode_attention`'s
    products) called on each rank's local shards.

    Each mesh dimension either splits the batch of all three (the
    ``batch`` rule), or the query heads (``heads``), or nothing; anything
    else (a sequence or head-width split, a partial sum) is redistributed
    first.  Keys and values split over a head dimension only when each
    query head meets its own (MLA, ``Hkv == H``); GQA's are replicated
    there.  The local query heads ``[h0, h0 + m)`` then take the key
    heads the *global* GQA map ``h // (H / Hkv)`` gives them: whole
    groups, or part of one group (more ranks than kv heads), are a
    narrowed view on which the kernel's own map holds; heads that
    straddle groups unevenly get their key and value heads gathered one
    a query head.  A key and value head used on several ranks gets a
    partial gradient from each (``Partial`` over that mesh dimension)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    qp, kp, gp = [], [], []
    for pl in q.placements:
        if pl == Shard(0):
            qp.append(pl), kp.append(pl), gp.append(pl)
        elif pl == Shard(2):
            qp.append(pl)
            mha = Hkv == H and k.placements == q.placements and v.placements == q.placements
            kp.append(Shard(2) if mha else Replicate())
            gp.append(Shard(2) if mha else Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate()), gp.append(Replicate())
    q, k, v = (t if tuple(t.placements) == tuple(want) else t.redistribute(mesh, want)
               for t, want in ((q, qp), (k, kp), (v, kp)))
    _, q_off = local_shape_and_offset(q.shape, mesh, q.placements)
    _, k_off = local_shape_and_offset(k.shape, mesh, k.placements)
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=gp), v.to_local(grad_placements=gp)
    m, G = ql.shape[2], H // Hkv
    idx = [(q_off[2] + i) // G - k_off[2] for i in range(m)]
    first, n_kv = idx[0], idx[-1] - idx[0] + 1
    if m % n_kv == 0 and idx == [first + i // (m // n_kv) for i in range(m)]:
        kl, vl = kl.narrow(2, first, n_kv), vl.narrow(2, first, n_kv)
    else:
        sel = torch.tensor(idx, device=kl.device)
        kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
    out = fn(ql, kl, vl).contiguous()
    shape = (*q.shape[:3], v.shape[3])
    return DTensor.from_local(out, mesh, q.placements, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int) -> torch.Tensor:
    """One-token attention over a partly filled KV cache.

    q: (B,1,H,D); caches: (B,Smax,Hkv,D); length: number of valid slots.
    Slots past ``length`` are left out rather than masked: a masked score's
    term is an exact zero, so the result is the same, and garbage in the
    unfilled tail cannot leak.  DTensors (under a mesh) attend on each
    rank's local shards: a cache whose slots are split (``kv_cache_seq``)
    through :func:`_split_slot_decode`, each rank over its own slots; any
    other through :func:`_local_attention`, each rank's query heads over
    the whole cache.
    """
    if isinstance(q, DTensor):
        split = _slot_split(k_cache)
        if split:
            return _split_slot_decode(q, k_cache, v_cache, length, split)
        return _local_attention(q, k_cache, v_cache,
                                lambda a, b, c: decode_attention(a, b, c, length))
    o, _ = _decode_scores(q, k_cache[:, :length], v_cache[:, :length])
    return o.to(q.dtype)


def _decode_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """One query row over the slots of k, v (B, L, Hkv, ·): the f32 output
    (B, 1, H, Dv) and the f32 scores (B, Hkv, G, L), G = H / Hkv."""
    B, _, H, D = q.shape
    Hkv, Dv = v.shape[2], v.shape[3]
    G = H // Hkv
    scale = k.shape[-1] ** -0.5
    q_r = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q_r, k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, Dv), s


def _slot_split(cache: torch.Tensor) -> Tuple[int, ...]:
    """The mesh dimensions that split a DTensor cache's slot dimension
    (its dimension 1); none for a plain tensor."""
    from torch.distributed.tensor import Shard

    if not isinstance(cache, DTensor):
        return ()
    return tuple(i for i, pl in enumerate(cache.placements) if pl == Shard(1))


def _split_slot_layout(q, caches, split):
    """Placements for a decode over caches whose slots ``split`` splits:
    the query replicated over those mesh dimensions (its heads gathered:
    one row), the caches' slots kept split; a batch split that query and
    caches share kept; any other split gathered.  Returns the query's
    local tensor and placements, the caches' local tensors and the first
    slot this rank holds."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = caches[0].device_mesh
    qp, cp = [], []
    for i, (a, c) in enumerate(zip(q.placements, caches[0].placements)):
        if i in split:
            qp.append(Replicate()), cp.append(c)
        elif a == Shard(0) and c == Shard(0):
            qp.append(a), cp.append(c)
        else:
            qp.append(Replicate()), cp.append(Replicate())
    place = lambda t, pl: t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
    q = place(q, qp)
    locs = [place(c, cp).to_local() for c in caches]
    _, off = local_shape_and_offset(caches[0].shape, mesh, cp)
    return q.to_local(), tuple(qp), locs, off[1]


def merge_partials(o: torch.Tensor, lse: torch.Tensor, mesh, dims: Sequence[int]
                   ) -> torch.Tensor:
    """Partial attention outputs over disjoint key sets, one a rank, merged
    over the mesh dimensions ``dims``: ``o`` (B, 1, H, W) f32, each
    normalised over its own keys, and ``lse`` (B, 1, H) their scores'
    log-sum-exp (−inf where a rank holds no key).  Per dimension the
    partials are all-gathered and ``o = Σ_r e^{lse_r − M} o_r /
    Σ_r e^{lse_r − M}``; with one partial that is ``o`` bit for bit."""
    from torch.distributed.tensor import Replicate, Shard

    whole = [Replicate()] * mesh.ndim
    for d in dims:
        if mesh.size(d) == 1:
            os_, ls = o[None], lse[None]
        else:   # an all-gather over dimension d alone
            pl = [Shard(0) if i == d else Replicate() for i in range(mesh.ndim)]
            os_, ls = (DTensor.from_local(t[None].contiguous(), mesh, pl)
                       .redistribute(mesh, whole).to_local() for t in (o, lse))
        m = ls.amax(0)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = torch.exp(ls - m)
        den = w.sum(0)
        o = (w[..., None] * os_).sum(0) / torch.clamp(den, min=1e-30)[..., None]
        lse = m + torch.log(den)
    return o


def _split_slot_decode(q, k_cache, v_cache, length: int, split: Tuple[int, ...]):
    """:func:`decode_attention` of DTensors whose cache slots ``split``
    splits: each rank attends its query heads (gathered over ``split``)
    to its own slots ``[s0, s0 + L) ∩ [0, length)``, keeping its f32
    output and log-sum-exp (a rank with no valid slot a zero output and
    −inf), and the partials are merged over ``split``
    (:func:`merge_partials`).  No rank gathers the cache."""
    mesh = k_cache.device_mesh
    ql, qp, (kl, vl), s0 = _split_slot_layout(q, (k_cache, v_cache), split)
    n = max(0, min(length - s0, kl.shape[1]))
    o, s = _decode_scores(ql, kl[:, :n], vl[:, :n])
    lse = torch.logsumexp(s, dim=-1).reshape(o.shape[:3])
    o = merge_partials(o, lse, mesh, split).to(q.dtype)
    shape = (*q.shape[:3], v_cache.shape[3])
    return DTensor.from_local(o, mesh, qp, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def init_gqa(gen, cfg, device: torch.device) -> Dict[str, torch.Tensor]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.torch_dtype
    if cfg.flat_attn_proj:
        p = {
            "wq": make_param(gen, (d, h * dh), dt, device, axes=("embed", "attn_flat")),
            "wk": make_param(gen, (d, hkv * dh), dt, device, axes=("embed", "attn_flat")),
            "wv": make_param(gen, (d, hkv * dh), dt, device, axes=("embed", "attn_flat")),
            "wo": make_param(gen, (h * dh, d), dt, device, axes=("attn_flat", "embed")),
        }
        if cfg.attn_bias:
            p["bq"] = const_param((h * dh,), dt, device, 0.0, axes=("attn_flat",))
            p["bk"] = const_param((hkv * dh,), dt, device, 0.0, axes=("attn_flat",))
            p["bv"] = const_param((hkv * dh,), dt, device, 0.0, axes=("attn_flat",))
    else:
        p = {
            "wq": make_param(gen, (d, h, dh), dt, device,
                             axes=("embed", "heads", "head_dim")),
            "wk": make_param(gen, (d, hkv, dh), dt, device,
                             axes=("embed", "kv_heads", "head_dim")),
            "wv": make_param(gen, (d, hkv, dh), dt, device,
                             axes=("embed", "kv_heads", "head_dim")),
            "wo": make_param(gen, (h, dh, d), dt, device,
                             axes=("heads", "head_dim", "embed")),
        }
        if cfg.attn_bias:
            p["bq"] = const_param((h, dh), dt, device, 0.0, axes=("heads", "head_dim"))
            p["bk"] = const_param((hkv, dh), dt, device, 0.0, axes=("kv_heads", "head_dim"))
            p["bv"] = const_param((hkv, dh), dt, device, 0.0, axes=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = const_param((dh,), dt, device, 1.0, axes=("norm",))
        p["k_norm"] = const_param((dh,), dt, device, 1.0, axes=("norm",))
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                n_heads: int, d_head: int) -> torch.Tensor:
    """x (B,S,d) → (B,S,n_heads,d_head) through a flat (d, H·Dh) or a
    per-head (d, H, Dh) projection: one matmul either way."""
    y = x @ w.reshape(w.shape[0], -1)
    if w.dim() == 2:   # flat projection: bias added before the head split
        if b is not None:
            y = y + b
        if isinstance(y, DTensor):
            y = _whole_heads(y, d_head)
        return y.reshape(*x.shape[:-1], n_heads, d_head)
    if isinstance(y, DTensor):
        y = _whole_heads(y, d_head)
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b
    return y


def _whole_heads(y, d_head: int):
    """A flat (…, H·Dh) DTensor whose split of its last dimension would
    cut a head or leave the ranks uneven shares of heads (H·Dh over the
    ranks not a multiple of Dh, as ``attn_flat``'s split of 40 or 56 heads
    over 16; or fewer heads than ranks, as 8 GQA kv heads over 16, which
    DTensor's matmul may split so) gathered whole along that dimension, so
    the reshape to heads is exact; a split at head boundaries stays."""
    from torch.distributed.tensor import Replicate, Shard

    last = Shard(y.dim() - 1)
    n = 1
    for i, pl in enumerate(y.placements):
        if pl == last:
            n *= y.device_mesh.size(i)
    if y.shape[-1] % (n * d_head) == 0:
        return y
    return y.redistribute(y.device_mesh,
                          [Replicate() if pl == last else pl for pl in y.placements])


def _qkv(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = _proj_heads(x, p["wq"], p.get("bq"), h, dh)
    k = _proj_heads(x, p["wk"], p.get("bk"), hkv, dh)
    v = _proj_heads(x, p["wv"], p.get("bv"), hkv, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if not cfg.flat_attn_proj:
        q = shard(q, "batch", "act_seq", "act_heads", None)
        k = shard(k, "batch", "act_seq", "act_kv_heads", None)
        v = shard(v, "batch", "act_seq", "act_kv_heads", None)
    return q, k, v


def gqa_forward(p: Dict, x: torch.Tensor, cfg,
                cache: Optional[Dict[str, torch.Tensor]] = None, *,
                causal: bool = True, pos: Optional[int] = None) -> torch.Tensor:
    """Self-attention over x (B, S, D), writing the keys and values into
    ``cache`` (``{"k", "v"}`` of (B, Smax, Hkv, Dh)) in place.

    Train (``cache`` None): attention over the S positions themselves, no
    cache.  Prefill (``pos`` None): the same attention
    (:func:`blocked_attention`), and the keys and values go to slots
    ``[0, S)``.  Decode (x is (B, 1, D), ``pos`` the write slot): the new
    key and value go to slot ``pos``, and the token attends to slots
    ``[0, pos]`` (:func:`decode_attention`).
    """
    B, S, _ = x.shape
    if pos is None:
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = _qkv(p, x, cfg, positions)
        out = blocked_attention(q, k, v, causal=causal)
        if cache is not None:
            write_slots(cache["k"], 0, k)
            write_slots(cache["v"], 0, v)
    else:
        positions = torch.full((1, 1), pos, dtype=torch.long, device=x.device)
        q, k, v = _qkv(p, x, cfg, positions)
        write_slots(cache["k"], pos, k)
        write_slots(cache["v"], pos, v)
        k_cache = shard(cache["k"], "batch", "kv_cache_seq", "act_kv_heads", None)
        v_cache = shard(cache["v"], "batch", "kv_cache_seq", "act_kv_heads", None)
        out = decode_attention(q, k_cache, v_cache, pos + 1)
    return _out_proj(out, p["wo"], B, S)


def _whole_head_rows(w, d_head: int):
    """A flat (H·Dh, d) DTensor weight whose split of its first dimension
    would cut a head (40 or 56 heads' rows over 16 ranks) gathered whole
    along it.  The product's gradient with respect to the attention
    output comes back split as that dimension is, and the backward's
    reshape of it to heads is refused where the split cuts a head."""
    from torch.distributed.tensor import Replicate, Shard

    if not isinstance(w, DTensor):
        return w
    n = 1
    for i, pl in enumerate(w.placements):
        if pl == Shard(0):
            n *= w.device_mesh.size(i)
    if w.shape[0] % (n * d_head) == 0:
        return w
    return w.redistribute(w.device_mesh,
                          [Replicate() if pl == Shard(0) else pl for pl in w.placements])


def _out_proj(out: torch.Tensor, wo: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(B, S, H, Dv) attention output through a flat (H·Dv, d) or a
    per-head (H, Dv, d) ``wo`` → (B, S, d)."""
    if wo.dim() == 3:
        out = shard(out, "batch", "act_seq", "act_heads", None)
    else:
        wo = _whole_head_rows(wo, out.shape[-1])
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return shard(y, "batch", "act_seq", "act_embed")


# The caches' logical axes (the reference's): the slots split over
# ``kv_cache_seq`` (``"model"`` under the dry run's ``kv_shard="seq"``),
# the kv heads over ``act_kv_heads``; a cross-attention cache's slots (the
# memory's positions) are never split.
GQA_CACHE_AXES = {
    "k": ("batch", "kv_cache_seq", "act_kv_heads", None),
    "v": ("batch", "kv_cache_seq", "act_kv_heads", None),
}
CROSS_CACHE_AXES = {
    "mk": ("batch", None, "act_kv_heads", None),
    "mv": ("batch", None, "act_kv_heads", None),
}
MLA_CACHE_AXES = {
    "c_kv": ("batch", "kv_cache_seq", None),
    "k_pe": ("batch", "kv_cache_seq", None),
}


def _spec(shape, dtype, axes) -> torch.Tensor:
    return with_axes(torch.empty(shape, dtype=dtype, device="meta"), axes)


def gqa_cache_spec(cfg, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) of one layer's cache,
    each with its logical axes (:data:`GQA_CACHE_AXES`)."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {k: _spec(shp, cfg.torch_dtype, ax) for k, ax in GQA_CACHE_AXES.items()}


# ---------------------------------------------------------------------------
# Cross-attention (vlm media layers; the enc-dec decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(gen, cfg, device: torch.device) -> Dict[str, torch.Tensor]:
    """GQA's projection geometry; the memory supplies the keys and values."""
    return init_gqa(gen, cfg, device)


def cross_attn_forward(p: Dict, x: torch.Tensor, memory: Optional[torch.Tensor], cfg,
                       cache: Optional[Dict[str, torch.Tensor]] = None, *,
                       pos: Optional[int] = None) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D), keys and values from
    ``memory`` (B, M, D), non-causal and without rope, writing the
    projected memory into ``cache`` (``{"mk", "mv"}`` of (B, M, Hkv, Dh))
    in place.

    Train (``cache`` None) and prefill (``pos`` None): k and v projected
    from ``memory`` (with ``k_norm`` under ``qk_norm``), and the prefill
    writes them to the cache, whose slots must number M exactly: a cache
    of another length raises ``ValueError`` (nothing is padded or cut).
    Decode (``pos`` given, ``memory`` None): the cached k and v, already
    normed.  Either way :func:`blocked_attention` with ``causal=False``.
    """
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B, S, _ = x.shape
    if pos is None:
        k = _proj_heads(memory, p["wk"], p.get("bk"), hkv, dh)
        v = _proj_heads(memory, p["wv"], p.get("bv"), hkv, dh)
        if "k_norm" in p:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cache is not None:
            if cache["mk"].shape[1] != memory.shape[1]:
                raise ValueError(
                    f"cross-attention: a memory of {memory.shape[1]} positions for a "
                    f"cache of {cache['mk'].shape[1]} slots; the cache must hold the "
                    f"memory's length exactly")
            copy_into(cache["mk"], k)
            copy_into(cache["mv"], v)
    else:
        k, v = cache["mk"], cache["mv"]
    q = _proj_heads(x, p["wq"], p.get("bq"), h, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if not cfg.flat_attn_proj:
        q = shard(q, "batch", "act_seq", "act_heads", None)
    out = blocked_attention(q, k, v, causal=False)
    wo = p["wo"] if p["wo"].dim() == 3 else _whole_head_rows(p["wo"], dh)
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return shard(y, "batch", "act_seq", "act_embed")


def cross_cache_spec(cfg, batch: int, mem_len: int) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) of one cross-attention
    layer's cache: the memory's keys and values, ``mem_len`` slots
    (:data:`CROSS_CACHE_AXES`)."""
    shp = (batch, mem_len, cfg.n_kv_heads, cfg.d_head)
    return {k: _spec(shp, cfg.torch_dtype, ax) for k, ax in CROSS_CACHE_AXES.items()}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, device: torch.device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.torch_dtype
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": make_param(gen, (d, h, qd), dt, device, axes=("embed", "heads", "head_dim")),
        "w_dkv": make_param(gen, (d, m.kv_lora_rank + m.qk_rope_dim), dt, device,
                            axes=("embed", "kv_lora")),
        "kv_norm": const_param((m.kv_lora_rank,), dt, device, 1.0, axes=("norm",)),
        "w_uk": make_param(gen, (m.kv_lora_rank, h, m.qk_nope_dim), dt, device,
                           axes=("kv_lora", "heads", "head_dim")),
        "w_uv": make_param(gen, (m.kv_lora_rank, h, m.v_head_dim), dt, device,
                           axes=("kv_lora", "heads", "head_dim")),
        "wo": make_param(gen, (h, m.v_head_dim, d), dt, device,
                         axes=("heads", "head_dim", "embed")),
    }


def _mla_compress(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """``w_dkv`` → (``c_kv`` after its RMS norm, ``k_pe`` after rope)."""
    m = cfg.mla
    ckv_pe = x @ p["w_dkv"]
    c_kv, k_pe = ckv_pe[..., :m.kv_lora_rank], ckv_pe[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def _mla_q(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    m = cfg.mla
    q = _proj_heads(x, p["wq"], None, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _per_head(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsr,rhk->bshk", c, w)`` as one matmul."""
    return (c @ w.reshape(w.shape[0], -1)).reshape(*c.shape[:-1], *w.shape[1:])


def mla_forward(p: Dict, x: torch.Tensor, cfg,
                cache: Optional[Dict[str, torch.Tensor]] = None, *,
                pos: Optional[int] = None) -> torch.Tensor:
    """MLA over x (B, S, D), writing ``c_kv`` and ``k_pe`` into ``cache``
    (``{"c_kv" (B, Smax, r), "k_pe" (B, Smax, rope)}``) in place.

    Train (``cache`` None) and prefill (``pos`` None): keys and values
    decompressed per head, q and k built by concatenation (contiguous),
    and :func:`blocked_attention` at q/k width ``nope + rope`` and v width
    ``v_head_dim``; the prefill writes slots ``[0, S)``.  Decode (x is
    (B, 1, D), ``pos`` the write slot): the absorbed form — q through
    ``w_uk`` into the latent space, scores against the cached ``c_kv`` and
    ``k_pe`` of slots ``[0, pos]`` in f32 (slots past ``pos`` left out, as
    in :func:`decode_attention`), the output back through ``w_uv``.
    """
    m = cfg.mla
    B, S, _ = x.shape
    if pos is None:
        positions = torch.arange(S, device=x.device)[None, :]
        q_nope, q_pe = _mla_q(p, x, cfg, positions)
        c_kv, k_pe = _mla_compress(p, x, cfg, positions)
        k_nope = _per_head(c_kv, p["w_uk"])
        v = _per_head(c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_dim)],
                      dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        q = shard(q, "batch", "act_seq", "act_heads", None)
        k = shard(k, "batch", "act_seq", "act_heads", None)
        out = blocked_attention(q, k, v, causal=True)
        if cache is not None:
            write_slots(cache["c_kv"], 0, c_kv)
            write_slots(cache["k_pe"], 0, k_pe)
    else:
        positions = torch.full((1, 1), pos, dtype=torch.long, device=x.device)
        q_nope, q_pe = _mla_q(p, x, cfg, positions)
        c_kv_new, k_pe_new = _mla_compress(p, x, cfg, positions)
        write_slots(cache["c_kv"], pos, c_kv_new)
        write_slots(cache["k_pe"], pos, k_pe_new)
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])      # absorb W_uk
        split = _slot_split(cache["c_kv"])
        if split:
            o_c = _mla_split_decode(q_c, q_pe, cache["c_kv"], cache["k_pe"], pos + 1, scale,
                                    split)
        else:
            o_c, _ = _mla_scores(q_c, q_pe, cache["c_kv"][:, :pos + 1],
                                 cache["k_pe"][:, :pos + 1], scale)
        out = torch.einsum("bshr,rhk->bshk", o_c, p["w_uv"])         # absorb W_uv
    y = out.reshape(B, S, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return shard(y, "batch", "act_seq", "act_embed")


def _mla_scores(q_c, q_pe, c_kv, k_pe, scale: float):
    """The absorbed decode over the slots of ``c_kv`` (B, L, r) and
    ``k_pe`` (B, L, rope): the latent output (B, 1, H, r) in ``c_kv``'s
    dtype and the f32 scores (B, 1, H, L)."""
    s = (torch.einsum("bshr,bkr->bshk", q_c.float(), c_kv.float())
         + torch.einsum("bshk,bmk->bshm", q_pe.float(), k_pe.float())) * scale
    pattn = torch.softmax(s, dim=-1)
    return torch.einsum("bshk,bkr->bshr", pattn.to(c_kv.dtype), c_kv), s


def _mla_split_decode(q_c, q_pe, c_kv, k_pe, length: int, scale: float,
                      split: Tuple[int, ...]):
    """The absorbed decode of DTensors whose ``c_kv`` and ``k_pe`` slots
    ``split`` splits: each rank over its own slots, the latent partials
    merged over ``split`` before ``w_uv`` (:func:`merge_partials`), as
    :func:`_split_slot_decode` does for GQA."""
    mesh = c_kv.device_mesh
    ql, qp, (cl, kl), s0 = _split_slot_layout(q_c, (c_kv, k_pe), split)
    if tuple(q_pe.placements) != qp:
        q_pe = q_pe.redistribute(mesh, qp)
    n = max(0, min(length - s0, cl.shape[1]))
    o, s = _mla_scores(ql, q_pe.to_local(), cl[:, :n], kl[:, :n], scale)
    o = merge_partials(o.float(), torch.logsumexp(s, dim=-1), mesh, split).to(c_kv.dtype)
    return DTensor.from_local(o, mesh, qp, shape=q_c.shape, stride=contiguous_stride(q_c.shape))


def mla_cache_spec(cfg, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) of one MLA layer's
    cache: the compressed ``c_kv`` and the rope key ``k_pe``
    (:data:`MLA_CACHE_AXES`)."""
    m = cfg.mla
    width = {"c_kv": m.kv_lora_rank, "k_pe": m.qk_rope_dim}
    return {k: _spec((batch, max_len, width[k]), cfg.torch_dtype, ax)
            for k, ax in MLA_CACHE_AXES.items()}
