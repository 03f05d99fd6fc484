"""The paper's network #2 — Braille classification (§4.3): 12 input, 38
recurrent LIF (reset-to-zero), N-class LI readout; SPI registers
threshold=0x03F0, alpha=0x0FE, kappa=0x37.

``CONFIG_QUANT`` / ``config_for(..., quantized=True)`` arm the bit-true
fixed-point datapath (8-bit weight SRAM, saturating 12-bit membrane,
``reg/256`` floor leaks).  ``QUANT_OPT`` is the matching optimizer config:
weights on the SRAM grid with accumulate-then-round e-prop commits.
"""

from repro_torch.core.quant import WEIGHT_SPEC, QuantizedMode
from repro_torch.core.rsnn import Presets
from repro_torch.optim.eprop_opt import EpropSGDConfig

# The paper's SPI parameter-bank values, as the quantized datapath reads them.
SPI_REGS = QuantizedMode(threshold=0x03F0, alpha_reg=0x0FE, kappa_reg=0x37)

CONFIG = Presets.braille(n_classes=3)
CONFIG_QUANT = Presets.braille(n_classes=3, quantized=True)

# Chip-faithful weight storage: 8-bit SRAM codes + float residual
# accumulator, committed at every END_S/END_B with the chip's stochastic
# rounding (sub-LSB updates make expected progress).
QUANT_OPT = EpropSGDConfig(lr=1e-2, clip=10.0, quant=WEIGHT_SPEC,
                           stochastic_round=True)


def config_for(n_classes: int, quantized: bool = False):
    return Presets.braille(n_classes=n_classes, quantized=quantized)


def reduced():
    return Presets.braille(n_classes=3, n_hid=16, num_ticks=32)
