"""AdamW for the LM (counterpart of :mod:`repro.optim.adamw`): decoupled
weight decay, bias-corrected moments, optional global-norm clipping and a
linear warm-up then cosine decay.

The arithmetic is the JAX package's, in the same order: the clip scale
``min(1, clip / (gnorm + 1e-12))`` multiplies the f32 gradient, the
moments are f32, the update is taken in f32 and cast back to the
parameter's dtype.  Plain tensor operations, as the JAX version is plain
``jnp``.  State is ``{"mu", "nu", "step"}`` with ``mu`` and ``nu`` trees
shaped like the parameters (the port's trees keep the parameters'
nesting) and ``step`` an int32 scalar on the parameters' device.

``update`` is functional, as in JAX: it returns new parameters and a new
state and leaves its inputs as they were, so a caller (the ``Trainer``)
can drop a step whose loss is not finite.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: Optional[float] = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_ratio * lr``, in f32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt`` of the sum over leaves of each leaf's f32 sum of squares."""
    sq = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg

    def init(self, params: Any) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                           memory_format=torch.contiguous_format)
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, params: Any, grads: Any, state: Dict[str, Any]
               ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        cfg = self.cfg
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(cfg.clip / (gnorm + 1e-12), max=1.0)
                 if cfg.clip is not None else None)
        lr = schedule(cfg, step)
        c1 = 1.0 - torch.pow(cfg.beta1, step.float())
        c2 = 1.0 - torch.pow(cfg.beta2, step.float())

        def upd(p, g, m, v):
            g32 = g.float() if scale is None else g.float() * scale
            m = cfg.beta1 * m + (1 - cfg.beta1) * g32
            v = cfg.beta2 * v + (1 - cfg.beta2) * g32.square()
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        pick = lambda i: tree_map(lambda t: t[i], out)
        return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}, {
            "grad_norm": gnorm, "lr": lr}
