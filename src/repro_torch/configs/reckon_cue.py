"""The paper's network #1 — cue accumulation (§4.2): 40 input, 100
recurrent LIF, 2 LI outputs, reset-by-subtraction, delayed supervision
(counterpart of :mod:`repro.configs.reckon_cue`).

``CONFIG_QUANT`` / ``config_for(quantized=True)`` arm the bit-true
fixed-point datapath with the tuned registers (threshold 0x03F0, alpha
254/256, kappa 200/256) under reset-by-subtraction.  ``QUANT_OPT`` is the
matching optimizer config, the same as Braille's: both tasks share the
SRAM numerics.
"""

from repro_torch.core.quant import WEIGHT_SPEC, QuantizedMode
from repro_torch.core.rsnn import Presets
from repro_torch.optim.eprop_opt import EpropSGDConfig

# The tuned SPI parameter-bank values, as the quantized datapath reads them.
SPI_REGS = QuantizedMode(threshold=0x03F0, alpha_reg=0x0FE, kappa_reg=0xC8)

CONFIG = Presets.cue_accumulation()
CONFIG_QUANT = Presets.cue_accumulation(quantized=True)

QUANT_OPT = EpropSGDConfig(lr=1e-2, clip=10.0, quant=WEIGHT_SPEC,
                           stochastic_round=True)


def config_for(quantized: bool = False, **over):
    return Presets.cue_accumulation(quantized=quantized, **over)


def reduced(quantized: bool = False):
    return Presets.cue_accumulation(
        n_in=12, n_hid=20, num_ticks=40, quantized=quantized
    )
