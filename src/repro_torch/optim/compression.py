"""Gradient compression for the cross-pod data-parallel axis (counterpart
of :mod:`repro.optim.compression`).

The scheme is int8 with error feedback:

  1. add the persistent f32 residual to the local gradient;
  2. quantize to int8 with a per-tensor max-abs scale;
  3. all-gather the **int8 payload** (and one f32 scale per tensor) over
     the pod axis's process group: 1 byte an element on the wire against
     an f32 ring all-reduce's ``4 · 2(p−1)/p``;
  4. dequantize and take the mean locally; keep ``local −
     dequant(quant(local))`` as the next step's residual.

Error feedback re-injects each step's quantization error into the next,
so the time-averaged mean converges to the uncompressed one.

The arithmetic is the JAX package's, so results are bitwise where the
sums have one order: ``g / scale`` (a division, not a product with the
reciprocal), ``torch.round`` (half to even, as ``jnp.round``), a clip to
±127, a scale of 1.0 for an all-zero tensor, and the mean as
``tensordot(scales, q.float()) / n`` cast to the gradient's dtype.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.transformer import tree_map


def quantize_int8(g: torch.Tensor, scale_groups: Sequence[Any] = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns ``(q, scale)``,
    ``scale`` a 0-d f32 tensor.  The scale is ``amax / 127`` in ``g``'s
    dtype, then f32; ``g`` is divided in f32 (JAX promotes a bf16 array
    over an f32 one, where torch would keep bf16 against a 0-d tensor).
    ``g`` may be one shard of a leaf whose other shards lie on the ranks
    of ``scale_groups``: the amax is then the max over all of them, one
    scale the whole leaf."""
    amax = g.abs().max() if g.numel() else g.new_zeros(())
    for grp in scale_groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=grp)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` stacked along a new first axis."""
    out = t.new_empty((n * t.numel(),))
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.view(n, *t.shape)


def compressed_psum_mean(grads: Any, residual: Any, group=None,
                         scale_groups: Sequence[Any] = ()) -> Tuple[Any, Any]:
    """The int8 + error-feedback mean of ``grads`` over the ranks of
    ``group`` (a process group; ``None`` is the whole world).  Every rank
    of the group calls it.  Returns ``(mean grads in each gradient's
    dtype, new f32 residual)``, trees shaped like ``grads``.

    DTensor leaves (a pod's sharded gradients, their residuals placed
    alike) are compressed shard by shard: each rank quantizes its local
    shard with the leaf's one scale (the amax over ``scale_groups``, the
    groups of the pod's other mesh axes), and gathers the codes of the
    same shard from the other pods over ``group``."""
    n = dist.get_world_size(group)

    def local(g, r):
        g32 = g.float() + r
        q, scale = quantize_int8(g32, scale_groups)
        new_r = g32 - dequantize_int8(q, scale)       # error feedback
        qs = _gather(q, n, group)                     # int8 on the wire
        ss = _gather(scale, n, group)
        mean = (torch.tensordot(ss, qs.float(), dims=([0], [0])) / n).to(g.dtype)
        return mean, new_r

    def one(g, r):
        if not isinstance(g, DTensor):
            return local(g, r)
        mean, new_r = local(g.to_local(), r.to_local())
        wrap = lambda t, like: DTensor.from_local(t, like.device_mesh, like.placements,
                                                  shape=like.shape, stride=like.stride())
        return wrap(mean, g), wrap(new_r, r)

    out = tree_map(one, grads, residual)     # (mean, residual) pairs as leaves
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_residual(grads_like: Any, device: Optional[torch.device] = None) -> Any:
    """Zero f32 residuals shaped like ``grads_like``'s leaves (on their
    device unless ``device`` is given; a DTensor's placed alike)."""
    if device is not None:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=device),
                        grads_like)
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32,
                                               memory_format=torch.contiguous_format),
                    grads_like)


def wire_bytes_f32_allreduce(n_elements: int, axis_size: int) -> int:
    """Ring all-reduce traffic per device (reduce-scatter + all-gather)."""
    return int(4 * 2 * (axis_size - 1) / axis_size * n_elements)


def wire_bytes_int8_allgather(n_elements: int, axis_size: int) -> int:
    return int(1 * (axis_size - 1) * n_elements / axis_size) * axis_size
