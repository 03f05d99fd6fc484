"""Parameter conversion from the JAX package's layout to the port's.

Both packages key weights alike (``w_in (N_in, H)``, ``w_rec (H, H)``,
``w_out (H, O)``, scalar ``alpha``, optional ``b_fb (H, O)``), so the
conversion is a float32 copy of each array onto ``device`` (``None``
means ``"cuda"``, and raises without a card).  The JAX side hands its
parameters over as NumPy arrays (``{k: np.asarray(v) for k, v in
params.items()}``); this module imports nothing of it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PARAM_KEYS = ("w_in", "w_rec", "w_out", "alpha", "b_fb")


def params_from_jax(params: Dict[str, np.ndarray], device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Map the JAX package's parameters (as NumPy arrays) onto float32
    tensors on ``device`` (the card unless the caller passes ``"cpu"``);
    unknown keys raise."""
    unknown = set(params) - set(PARAM_KEYS)
    if unknown:
        raise ValueError(f"unknown parameter keys {sorted(unknown)}")
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in params.items()
    }
