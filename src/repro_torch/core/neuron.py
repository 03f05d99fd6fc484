"""Neuron dynamics of the ReckOn RSNN: LIF hidden neurons, LI readout
(PyTorch counterpart of :mod:`repro.core.neuron`).

``reset="sub"`` subtracts the threshold on a spike (cue accumulation);
``reset="zero"`` clears the membrane (the Braille experiments).  With
``cfg.quant`` set, both steps run ReckOn's fixed-point datapath on integer
values carried in float32.  :func:`spike` is the Heaviside with the
surrogate gradient (a ``torch.autograd.Function``, the JAX
``custom_vjp``), used only by the BPTT reference path
(:func:`lif_step_surrogate`) that e-prop is checked against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantizedMode


@dataclasses.dataclass(frozen=True)
class NeuronConfig:
    alpha: float = 254.0 / 256.0   # hidden-membrane decay (SPI reg 0x0FE)
    kappa: float = 55.0 / 256.0    # readout decay        (SPI reg 0x37)
    v_th: float = 1.0              # normalised threshold (SPI reg 0x03F0)
    reset: str = "sub"             # "sub" | "zero"
    surrogate: str = "boxcar"      # "boxcar" | "triangular"
    boxcar_width: float = 0.5      # half-width of the boxcar, in units of v_th
    gamma: float = 0.3             # surrogate damping (Bellec et al.)
    quant: Optional[QuantizedMode] = None

    def effective_v_th(self) -> float:
        """The threshold the datapath compares against: the raw register
        in quantized mode, ``v_th`` otherwise."""
        return float(self.quant.threshold) if self.quant is not None else self.v_th


def pseudo_derivative(v_pre: torch.Tensor, cfg: NeuronConfig) -> torch.Tensor:
    """Surrogate dz/dv at the pre-reset membrane (boxcar or triangular)."""
    v_th = cfg.effective_v_th()
    if cfg.surrogate == "boxcar":
        return (torch.abs(v_pre - v_th) < cfg.boxcar_width * v_th).to(v_pre.dtype)
    if cfg.surrogate == "triangular":
        return cfg.gamma * torch.clamp(
            1.0 - torch.abs(v_pre - v_th) / v_th, min=0.0
        ).to(v_pre.dtype)
    raise ValueError(f"unknown surrogate {cfg.surrogate!r}")


class _Spike(torch.autograd.Function):
    """Heaviside forward, ``g * pseudo_derivative(v_pre)`` backward."""

    @staticmethod
    def forward(ctx, v_pre, v_th, cfg):
        ctx.save_for_backward(v_pre)
        ctx.cfg = cfg
        return (v_pre >= v_th).to(v_pre.dtype)

    @staticmethod
    def backward(ctx, g):
        (v_pre,) = ctx.saved_tensors
        return g * pseudo_derivative(v_pre, ctx.cfg), None, None


def spike(v_pre: torch.Tensor, v_th, cfg: NeuronConfig) -> torch.Tensor:
    """Heaviside spike with surrogate gradient (for the BPTT reference path)."""
    return _Spike.apply(v_pre, v_th, cfg)


def lif_step_surrogate(
    v: torch.Tensor, current: torch.Tensor, alpha, cfg: NeuronConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LIF step with the surrogate-gradient spike (differentiable, for
    BPTT); the reset-to-zero path stops the gradient through ``z``."""
    if cfg.quant is not None:
        raise ValueError("the BPTT reference path is float-only")
    v_pre = alpha * v + current
    z = spike(v_pre, cfg.v_th, cfg)
    if cfg.reset == "sub":
        v_new = v_pre - z * cfg.v_th
    else:
        v_new = v_pre * (1.0 - z.detach())
    return v_new, z, v_pre


def lif_step(
    v: torch.Tensor, current: torch.Tensor, alpha, cfg: NeuronConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LIF tick → ``(v_new, z_new, v_pre)``.  Quantized mode:
    ``v_pre = sat(floor(v * alpha_reg/256) + current)`` and the register
    threshold (``alpha`` is then ignored)."""
    q = cfg.quant
    if q is not None:
        v_pre = q.sat(q.leak(v, q.alpha_reg) + current)
        v_th = float(q.threshold)
    else:
        v_pre = alpha * v + current
        v_th = cfg.v_th
    z = (v_pre >= v_th).to(v.dtype)
    if cfg.reset == "sub":
        v_new = v_pre - z * v_th
    elif cfg.reset == "zero":
        v_new = v_pre * (1.0 - z)
    else:
        raise ValueError(f"unknown reset mode {cfg.reset!r}")
    return v_new, z, v_pre


def li_step(
    y: torch.Tensor, current: torch.Tensor, kappa,
    cfg: Optional[NeuronConfig] = None,
) -> torch.Tensor:
    """One leaky-integrator readout tick ``y' = kappa * y + current``
    (quantized: ``sat(floor(y * kappa_reg/256) + current)``)."""
    q = cfg.quant if cfg is not None else None
    if q is not None:
        return q.sat(q.leak(y, q.kappa_reg) + current)
    return kappa * y + current
