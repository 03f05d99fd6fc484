"""Where the port runs: one rule for every entry point.

``None`` means ``"cuda"``: the port runs its kernels on the card, and an
entry point asked for the card on a machine without one raises instead
of dropping to the CPU.  ``"cpu"`` runs the kernels' plain PyTorch
versions and is only ever chosen by the caller.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.
    Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs its kernels on the "
                "card; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
