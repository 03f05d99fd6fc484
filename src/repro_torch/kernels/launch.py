"""What every kernel wrapper of the port shares: the registry of kernels
with their launch counters, the card's per-block limits, and the launch
plumbing (the current stream as a ctypes argument, the launcher's error
code turned into an exception).

``launches`` is counted by each wrapper right after its launch and nowhere
else (:mod:`repro_torch.kernels.ops` re-exports it): a run sets the counts
to 0, drives the main path and reads them back to show that the path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# H100 (SXM) per-block limits and SM count (NVIDIA data sheet / Hopper
# tuning guide): dynamic shared memory a block may opt into, threads a
# block may launch, threads an SM holds at once, streaming multiprocessors
# on the card.
SMEM_PER_BLOCK = 232448
THREADS_PER_BLOCK = 1024
THREADS_PER_SM = 2048
H100_SMS = 132

# Every kernel of the port: the five RSNN kernels and the LM's attention
# kernel.
KERNELS = ("rsnn_infer", "rsnn_step_sessions", "rsnn_forward", "rsnn_train",
           "eprop_update", "flash_attention")
launches: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def stream_arg(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.rsnn_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
