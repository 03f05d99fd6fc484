"""The ReckOn RSNN model — input LIF → recurrent LIF → LI readout
(counterpart of :mod:`repro.core.rsnn`).

The chip simulates up to 256 input + 256 recurrent LIF neurons and 16 LI
outputs; ``RSNNConfig`` enforces those limits unless
``strict_chip_limits=False``.  Weights are plain dictionaries of tensors
keyed as in the JAX package: ``w_in (N_in, H)``, ``w_rec (H, H)``,
``w_out (H, O)``, scalar ``alpha`` and, with random feedback, ``b_fb``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.core.eprop import EpropConfig
from repro_torch.core.neuron import NeuronConfig
from repro_torch.core.quant import QuantizedMode
from repro_torch.device import DeviceLike, resolve_device

MAX_IN = 256
MAX_HID = 256
MAX_OUT = 16


@dataclasses.dataclass(frozen=True)
class RSNNConfig:
    """Full model configuration (the "SPI parameter bank" of the system)."""

    n_in: int = 40
    n_hid: int = 100
    n_out: int = 2
    num_ticks: int = 150            # ticks per sample (12-bit on chip, <=4096)
    neuron: NeuronConfig = dataclasses.field(default_factory=NeuronConfig)
    eprop: EpropConfig = dataclasses.field(default_factory=EpropConfig)
    w_in_gain: float = 1.0
    w_rec_gain: float = 1.0
    w_out_gain: float = 1.0
    label_delay: int = 0            # SPI reg: delayed-supervision offset
    strict_chip_limits: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        if self.strict_chip_limits:
            for got, cap, what in (
                (self.n_in, MAX_IN, "input"),
                (self.n_hid, MAX_HID, "hidden"),
                (self.n_out, MAX_OUT, "output"),
            ):
                if got > cap:
                    raise ValueError(f"{got} {what} neurons > chip max {cap}")
        if self.num_ticks > 4096:
            raise ValueError("tick counter is 12-bit on the AER bus")


def init_params(
    generator: torch.Generator, cfg: RSNNConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """Gaussian fan-in initialisation of the weight SRAM (Bellec et al.
    2020), drawn from ``generator`` (a CPU generator) and moved to
    ``device`` — the card unless the caller passes ``"cpu"``.  ``alpha`` is
    a scalar tensor (the single "alphas LSBs" register)."""
    dt = getattr(torch, cfg.dtype)
    device = resolve_device(device)

    def normal(shape, fan_in, gain=1.0):
        w = torch.randn(shape, generator=generator, dtype=dt)
        return (gain * w / math.sqrt(fan_in)).to(device)

    params = {
        "w_in": normal((cfg.n_in, cfg.n_hid), cfg.n_in, cfg.w_in_gain),
        "w_rec": normal((cfg.n_hid, cfg.n_hid), cfg.n_hid, cfg.w_rec_gain),
        "w_out": normal((cfg.n_hid, cfg.n_out), cfg.n_hid, cfg.w_out_gain),
        "alpha": torch.tensor(cfg.neuron.alpha, dtype=dt, device=device),
    }
    if cfg.eprop.feedback == "random":
        params["b_fb"] = normal((cfg.n_hid, cfg.n_out), cfg.n_hid)
    return params


def trainable(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The subset of params e-prop updates (weights; not alpha / feedback)."""
    return {k: params[k] for k in ("w_in", "w_rec", "w_out")}


def merge_trainable(params: Dict[str, torch.Tensor],
                    weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(params)
    out.update(weights)
    return out


def param_count(cfg: RSNNConfig) -> int:
    return cfg.n_in * cfg.n_hid + cfg.n_hid * cfg.n_hid + cfg.n_hid * cfg.n_out


def sram_bytes(cfg: RSNNConfig, weight_bits: int = 8) -> int:
    """Weight-SRAM footprint in bytes (the BRAM columns of the paper's
    Tables 1/2)."""
    return param_count(cfg) * weight_bits // 8


@dataclasses.dataclass(frozen=True)
class Presets:
    """The two experimental networks of the paper."""

    @staticmethod
    def cue_accumulation(
        num_ticks: int = 150, quantized: bool = False, **over
    ) -> RSNNConfig:
        """§4.2: 40 input, 100 recurrent, 2 output; reset-by-subtraction;
        alpha=0xFE/256, kappa=0xC8/256, w_in gain 3."""
        kw = dict(
            n_in=40, n_hid=100, n_out=2, num_ticks=num_ticks,
            neuron=NeuronConfig(
                alpha=254.0 / 256.0, kappa=200.0 / 256.0, reset="sub",
                quant=QuantizedMode(
                    threshold=0x03F0, alpha_reg=0x0FE, kappa_reg=0xC8
                ) if quantized else None,
            ),
            eprop=EpropConfig(mode="factored", error="softmax",
                              infer_window="valid"),
            w_in_gain=3.0,
        )
        kw.update(over)
        return RSNNConfig(**kw)

    @staticmethod
    def braille(
        n_classes: int = 3, num_ticks: int = 256, quantized: bool = False, **over
    ) -> RSNNConfig:
        """§4.3: 12 input, 38 recurrent (reset-to-zero), N-class readout;
        threshold 0x03F0, alpha 0x0FE (254/256), kappa 0x37 (55/256)."""
        kw = dict(
            n_in=12, n_hid=38, n_out=n_classes, num_ticks=num_ticks,
            neuron=NeuronConfig(
                alpha=254.0 / 256.0, kappa=55.0 / 256.0, reset="zero",
                quant=QuantizedMode(
                    threshold=0x03F0, alpha_reg=0x0FE, kappa_reg=0x37
                ) if quantized else None,
            ),
            eprop=EpropConfig(mode="factored", error="softmax",
                              infer_window="valid"),
        )
        kw.update(over)
        return RSNNConfig(**kw)
