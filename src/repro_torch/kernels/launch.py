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

# Every kernel of the port: the five RSNN kernels, the exact-mode e-prop
# kernel and the LM's attention kernel, forward and backward.
KERNELS = ("rsnn_infer", "rsnn_step_sessions", "rsnn_forward", "rsnn_train",
           "eprop_update", "rsnn_train_exact", "flash_attention",
           "flash_attention_bwd")
launches: Dict[str, int] = {k: 0 for k in KERNELS}
# The train kernels' launches that reduced onto the integer commit grid
# (rsnn_dw_codes_reduce_kernel, in the same launch): a share of
# launches[k], counted beside it.
grid_launches: Dict[str, int] = {"rsnn_train": 0, "rsnn_train_exact": 0}


def reset_launch_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
    for k in grid_launches:
        grid_launches[k] = 0


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def stream_arg(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# CUDA runtime error codes (``cudaError_t``) after which the context is
# unusable for the rest of the process: an uncorrectable ECC error, an
# illegal address, a launch timeout, a device assert, the hardware
# exceptions (stack, instruction, alignment, address space, PC), an
# unspecified launch failure, an unknown error.  Every other code a
# launcher returns (an invalid value or configuration, too few resources)
# leaves the context usable.
STICKY_CUDA_ERRORS = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718,
                                719, 999})


class KernelLaunchError(RuntimeError):
    """A launcher's non-zero return code.  ``sticky`` says whether the
    code poisons the CUDA context (no launch in this process can succeed
    after it)."""

    def __init__(self, name: str, code: int, msg: str):
        super().__init__(f"{name} launch failed: CUDA error {code} ({msg})")
        self.kernel = name
        self.code = int(code)

    @property
    def sticky(self) -> bool:
        return self.code in STICKY_CUDA_ERRORS


def raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise KernelLaunchError(name, rc, lib.rsnn_error_string(rc).decode())
