"""Fixed-point numerics matching ReckOn's on-chip representation (PyTorch).

Counterpart of :mod:`repro.core.quant`: the signed fixed-point grid
:class:`QuantSpec` (nearest, stochastic and straight-through rounding),
the bit-true datapath contract :class:`QuantizedMode` (12-bit saturating
membrane grid, ``floor(v * reg / 256)`` leaks, 8-bit ``Q(8, 4)`` weight
SRAM landing on the membrane at ``threshold >> 4`` LSBs per weight LSB),
and :class:`QuantState`, the accumulate-then-round weight storage of the
chip's e-prop commits.  Random bits come from an explicit
``torch.Generator`` on the tensors' device (they cannot match
``jax.random``; tests compare distributions).

Every datapath quantity is an exact integer below 2**24 carried in
float32, where add, multiply by ``reg / 256``, floor and clamp are exact.
``torch.round`` rounds half to even, as ``jnp.round`` does, so weight
codes match the JAX package and the NumPy golden reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Signed fixed-point grid with ``bits`` total and ``frac`` fractional
    bits: values ``k * 2**-frac`` for ``k in [-2**(bits-1), 2**(bits-1)-1]``."""

    bits: int = 8
    frac: int = 4

    @property
    def lsb(self) -> float:
        return 2.0 ** (-self.frac)

    @property
    def min_val(self) -> float:
        return -(2.0 ** (self.bits - 1)) * self.lsb

    @property
    def max_val(self) -> float:
        return (2.0 ** (self.bits - 1) - 1) * self.lsb

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, self.min_val, self.max_val)

    def round_nearest(self, x: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest-even onto the grid, saturating."""
        return self.clip(torch.round(x / self.lsb) * self.lsb)

    def round_stochastic(self, x: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
        """Stochastic rounding onto the grid (unbiased), saturating: the
        chip's mode for on-chip e-prop updates, so sub-LSB updates still
        make expected progress.  ``generator`` lives on ``x``'s device."""
        scaled = x / self.lsb
        floor = torch.floor(scaled)
        p_up = scaled - floor
        up = torch.rand(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype) < p_up
        return self.clip((floor + up.to(x.dtype)) * self.lsb)

    def ste(self, x: torch.Tensor) -> torch.Tensor:
        """Straight-through quantization: forward = grid value, gradient =
        identity."""
        return x + (self.round_nearest(x) - x).detach()


# 12-bit signed membrane grid of the taped-out chip (threshold 0x03F0 fits).
MEMBRANE_SPEC = QuantSpec(bits=12, frac=0)
WEIGHT_SPEC = QuantSpec(bits=8, frac=4)

# Deterministic END_B commit grid: the fixed-point accumulator each
# per-sample e-prop contribution is snapped onto before a batch reduction,
# so the committed dw does not depend on how the sample axis is split
# (24 bits, 12 fractional: per-sample headroom of +-2**11 at 2**-12).
DW_COMMIT_SPEC = QuantSpec(bits=24, frac=12)


@dataclasses.dataclass(frozen=True)
class QuantizedMode:
    """Bit-true configuration of ReckOn's fixed-point tick datapath — the
    contract the quantized kernels and the integer golden reference share.
    See :class:`repro.core.quant.QuantizedMode` for the derivation."""

    threshold: int = 0x03F0        # membrane-grid integer (SPI register)
    alpha_reg: int = 0x0FE         # hidden-layer leak register
    kappa_reg: int = 0x37          # readout leak register
    membrane_spec: QuantSpec = MEMBRANE_SPEC
    weight_spec: QuantSpec = WEIGHT_SPEC

    def __post_init__(self):
        if self.membrane_spec.frac != 0:
            raise ValueError("the membrane grid is a raw integer grid (frac=0)")
        if not 0 < self.threshold <= self.v_max:
            raise ValueError(
                f"threshold {self.threshold:#x} not representable on the "
                f"{self.membrane_spec.bits}-bit membrane grid (max {self.v_max})"
            )
        if self.threshold % (1 << self.weight_spec.frac) != 0:
            raise ValueError(
                f"threshold {self.threshold:#x} must be divisible by "
                f"2**frac={1 << self.weight_spec.frac} so the weight grid "
                "lands on whole membrane LSBs (the chip's 0x03F0 does)"
            )

    @property
    def v_min(self) -> int:
        return int(self.membrane_spec.min_val)

    @property
    def v_max(self) -> int:
        return int(self.membrane_spec.max_val)

    @property
    def alpha(self) -> float:
        """The float decay the register encodes (``reg / 256``)."""
        return float(self.alpha_reg & 0xFF) / 256.0

    @property
    def kappa(self) -> float:
        return float(self.kappa_reg & 0xFF) / 256.0

    def leak(self, v: torch.Tensor, reg: int) -> torch.Tensor:
        """One hardware leak step ``floor(v * reg / 256)`` (exact in f32;
        floors toward -inf like the chip's arithmetic shift)."""
        return torch.floor(v * (float(reg & 0xFF) / 256.0))

    def sat(self, v: torch.Tensor) -> torch.Tensor:
        """Saturate onto the signed membrane grid."""
        return torch.clamp(v, float(self.v_min), float(self.v_max))

    @property
    def w_gain(self) -> int:
        """Membrane LSBs one weight LSB contributes."""
        return self.threshold >> self.weight_spec.frac

    def contract(self) -> dict:
        """The register contract as plain JSON-able ints."""
        return {
            "threshold": int(self.threshold),
            "alpha_reg": int(self.alpha_reg),
            "kappa_reg": int(self.kappa_reg),
            "membrane_bits": int(self.membrane_spec.bits),
            "membrane_frac": int(self.membrane_spec.frac),
            "weight_bits": int(self.weight_spec.bits),
            "weight_frac": int(self.weight_spec.frac),
        }

    @classmethod
    def from_contract(cls, d: dict) -> "QuantizedMode":
        """Inverse of :meth:`contract`."""
        return cls(
            threshold=int(d["threshold"]),
            alpha_reg=int(d["alpha_reg"]),
            kappa_reg=int(d["kappa_reg"]),
            membrane_spec=QuantSpec(int(d["membrane_bits"]),
                                    int(d["membrane_frac"])),
            weight_spec=QuantSpec(int(d["weight_bits"]), int(d["weight_frac"])),
        )

    def weight_codes(self, w: torch.Tensor) -> torch.Tensor:
        """Float weights → signed SRAM codes (integer-valued float32)."""
        spec = self.weight_spec
        lo = -(2.0 ** (spec.bits - 1))
        hi = 2.0 ** (spec.bits - 1) - 1
        return torch.clamp(torch.round(torch.as_tensor(w) / spec.lsb), lo, hi)

    def to_membrane(self, w: torch.Tensor) -> torch.Tensor:
        """Float weights → membrane-grid integers the datapath accumulates."""
        return self.weight_codes(w) * float(self.w_gain)


@dataclasses.dataclass(frozen=True)
class ReckonRegs:
    """Decoded SPI parameter-bank values."""

    threshold: float
    alpha: float
    kappa: float


def from_reckon_regs(
    threshold: int = 0x03F0, alpha_lsb: int = 0x0FE, kappa: int = 0x37,
    membrane_scale: Optional[float] = None,
) -> ReckonRegs:
    """Interpret the raw SPI registers reported in the paper.  The
    threshold is a membrane-grid integer, mapped to float units by
    ``membrane_scale`` (default: normalised so the threshold is 1.0);
    the leakage registers are 8-bit fractions ``reg / 256``."""
    scale = membrane_scale if membrane_scale is not None else 1.0 / float(threshold)
    return ReckonRegs(
        threshold=float(threshold) * scale,
        alpha=float(alpha_lsb & 0xFF) / 256.0,
        kappa=float(kappa & 0xFF) / 256.0,
    )


class QuantState:
    """Accumulate-then-round weight storage: ``{"q": grid weights, "acc":
    float residuals}``, dictionaries keyed like the weights.  ``commit``
    folds the residual into the grid weights and carries the rounding
    residue forward, like the chip's read-modify-write of weight SRAM
    words during e-prop."""

    @staticmethod
    def init(params: Dict[str, torch.Tensor], spec: QuantSpec = WEIGHT_SPEC):
        return {"q": {k: spec.round_nearest(v) for k, v in params.items()},
                "acc": {k: torch.zeros_like(v) for k, v in params.items()}}

    @staticmethod
    def accumulate(state, updates: Dict[str, torch.Tensor]):
        return {"q": state["q"],
                "acc": {k: a + updates[k] for k, a in state["acc"].items()}}

    @staticmethod
    def commit(state, spec: QuantSpec = WEIGHT_SPEC,
               generator: Optional[torch.Generator] = None):
        """Round ``q + acc`` onto ``spec`` (nearest, or stochastic from
        ``generator``, drawn in sorted-key order) and keep the residue."""
        q, acc = {}, {}
        for k in sorted(state["q"]):
            tot = state["q"][k] + state["acc"][k]
            new = (spec.round_nearest(tot) if generator is None
                   else spec.round_stochastic(tot, generator))
            q[k], acc[k] = new, tot - new
        return {"q": q, "acc": acc}
