"""e-prop weight-update rule — the chip's online SGD with fixed-point
commit (counterpart of :mod:`repro.optim.eprop_opt`).

* float mode (``quant=None``) — plain SGD with optional momentum,
  clipping, lr decay and a separate readout learning rate;
* quantized mode — weights live on a :class:`~repro_torch.core.quant.
  QuantSpec` grid with a float residual accumulator; every ``update`` is an
  accumulate + commit (round-nearest, or stochastic from a
  ``torch.Generator`` on the weights' device), like the chip's weight-SRAM
  read-modify-write.

An END_B batch commit passes ``num_updates=K``: the lr decay counter (an
exact ``int32``) advances by K and the clip threshold scales with
``sqrt(K)``, so both commit modes keep per-sample semantics.  ``dw`` are
positive-gradient sums, applied as ``w <- w - lr * dw``.  The arithmetic
follows the JAX optimizer step for step, so nearest-round commits of the
same ``dw`` give the same grid codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class EpropSGDConfig:
    lr: float = 1e-2
    momentum: float = 0.0
    clip: Optional[float] = None          # global-norm clip over the dw set
    quant: Optional[QuantSpec] = None     # None = float weights
    stochastic_round: bool = False        # chip default for sub-LSB commits
    lr_out_scale: float = 1.0             # separate readout learning rate
    decay_tau: float = 0.0                # >0: lr/(1 + updates/tau) schedule


class EpropSGD:
    """``state = init(weights)``; ``weights, state = update(weights, dw,
    state, generator, num_updates)``.  Returns new tensors; nothing is
    updated in place."""

    def __init__(self, cfg: EpropSGDConfig):
        self.cfg = cfg

    def init(self, weights: Dict[str, torch.Tensor]) -> Dict:
        # an exact int32 sample counter: a float32 one stops at 2**24
        dev = next(iter(weights.values())).device
        state: Dict = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.cfg.momentum:
            state["mu"] = {k: torch.zeros_like(w) for k, w in weights.items()}
        if self.cfg.quant is not None:
            state["acc"] = {k: torch.zeros_like(w) for k, w in weights.items()}
        return state

    def _clip(self, dw: Dict[str, torch.Tensor], num_updates: float):
        if self.cfg.clip is None:
            return dw
        sq = 0.0
        for k in sorted(dw):
            sq = sq + torch.sum(torch.square(dw[k]))
        gn = torch.sqrt(sq + 1e-12)
        # an END_B commit sums K per-sample steps that behave like bounded
        # noisy directions: their sum grows like sqrt(K)
        lim = self.cfg.clip * torch.sqrt(
            torch.tensor(float(num_updates), dtype=gn.dtype, device=gn.device))
        scale = torch.clamp(lim / gn, max=1.0)
        return {k: g * scale for k, g in dw.items()}

    def update(
        self,
        weights: Dict[str, torch.Tensor],
        dw: Dict[str, torch.Tensor],
        state: Dict,
        generator: Optional[torch.Generator] = None,
        num_updates: float = 1.0,
    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Commit one update.  Only keys present in ``dw`` move; other
        entries (a fixed random feedback ``b_fb``) pass through.
        ``num_updates`` is how many per-sample updates the commit stands
        for (1 for END_S, the batch size for END_B); ``generator`` feeds
        the stochastic commits, drawn in sorted-key order."""
        cfg = self.cfg
        keys_w = [k for k in weights if k in dw]
        dw = self._clip({k: dw[k] for k in keys_w}, num_updates)
        count = state["count"]
        state = dict(state, count=count + int(round(float(num_updates))))
        scale = 1.0 / (1.0 + count / cfg.decay_tau) if cfg.decay_tau > 0 else 1.0
        step = {}
        for k in keys_w:
            lr = cfg.lr * scale * (cfg.lr_out_scale if k == "w_out" else 1.0)
            step[k] = lr * dw[k]

        if cfg.momentum:
            mu = dict(state["mu"])
            mu.update({k: cfg.momentum * state["mu"][k] + step[k] for k in keys_w})
            state = dict(state, mu=mu)
            step = {k: mu[k] for k in keys_w}

        new_w = dict(weights)
        if cfg.quant is None:
            new_w.update({k: weights[k] - step[k] for k in keys_w})
            return new_w, state

        # weights are grid values: accumulate the (negative) step into the
        # float residual, then commit back onto the grid
        spec: QuantSpec = cfg.quant
        if cfg.stochastic_round and generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        new_acc = dict(state["acc"])
        for k in sorted(keys_w):
            tot = weights[k] + (state["acc"][k] - step[k])
            q = (spec.round_stochastic(tot, generator) if cfg.stochastic_round
                 else spec.round_nearest(tot))
            new_w[k] = q
            new_acc[k] = tot - q
        return new_w, dict(state, acc=new_acc)

    def quantize_init(self, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Snap freshly initialised float weights onto the grid (SRAM load)."""
        if self.cfg.quant is None:
            return weights
        return {k: self.cfg.quant.round_nearest(w) for k, w in weights.items()}
