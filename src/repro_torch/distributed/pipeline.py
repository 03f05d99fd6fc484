"""Pipeline parallelism: the GPipe schedule over a mesh axis (counterpart
of :mod:`repro.distributed.pipeline`).

Stages live on consecutive ranks of ``axis`` (the ``pod`` axis by
default).  The schedule is the (n_micro + S − 1)-tick GPipe wavefront:
every tick each rank runs its stage on the microbatch in flight and hands
the activation to the next rank, point to point (``batch_isend_irecv``:
one send and one receive a rank a tick, the counterpart of the
reference's ``ppermute``, so no order of the ranks can deadlock).  Rank 0
receives nothing and injects the microbatches; the last rank commits
microbatch ``t − (S − 1)`` once that index is valid.  At the end the last
rank's outputs are summed over the axis with every other rank's masked
to zero, so every rank returns the result.  Bubble fraction (S − 1) /
(n_micro + S − 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.transformer import tree_leaves, tree_map


def gpipe(stage_fn: Callable, stage_params: Any, x: torch.Tensor, *, mesh,
          axis: str = "pod") -> torch.Tensor:
    """Run ``x`` (n_micro, mb, ...) through every stage; returns
    (n_micro, mb, ...) on every rank of the axis.  ``stage_fn(params,
    x_mb) -> y_mb`` keeps the shape; ``stage_params``' leaves have a
    leading dimension of the axis's size, and rank ``s`` of the axis runs
    ``p[s]``."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages, s = len(ranks), ranks.index(dist.get_rank())
    n_micro = x.shape[0]
    own = tree_map(lambda p: p[s], stage_params)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (clamped; masked by validity below)
        y = stage_fn(own, x[min(t, n_micro - 1)] if s == 0 else buf)
        nxt = torch.zeros_like(buf)          # rank 0 receives zeros, as ppermute
        ops = []
        if s + 1 < n_stages:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), ranks[s + 1], group))
        if s > 0:
            ops.append(dist.P2POp(dist.irecv, nxt, ranks[s - 1], group))
        for work in (dist.batch_isend_irecv(ops) if ops else []):
            work.wait()
        buf = nxt
        m_out = t - (n_stages - 1)
        if s == n_stages - 1 and 0 <= m_out < n_micro:
            outs[m_out] = y
    outs = outs * float(s == n_stages - 1)
    dist.all_reduce(outs, group=group)
    return outs


def reference_pipeline(stage_fn: Callable, stage_params: Any, x: torch.Tensor
                       ) -> torch.Tensor:
    """Oracle: every microbatch through the stages in order, on one
    device."""
    n_stages = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for m in range(x.shape[0]):
        y = x[m]
        for i in range(n_stages):
            y = stage_fn(tree_map(lambda p: p[i], stage_params), y)
        outs.append(y)
    return torch.stack(outs)
