"""Device-memory bytes one serving launch moves (counterpart of the two
serving formulas of :mod:`repro.kernels.traffic`).

Counted as the kernels read and write them on the card: the raster and
masks once, the weights once per launch (each block re-reads them, but
from L2 after the first), the carries once in and once out, no per-tick
tensor.  ``BatchedEngine`` sums these into ``hbm_bytes_streamed``.
"""

from __future__ import annotations

from repro_torch.kernels.rsnn_step import F32_BYTES, weight_elems


def infer_fused_tiled_bytes(T: int, B: int, n_in: int, n_hid: int,
                            n_out: int) -> int:
    """``rsnn_infer``: raster + valid + weights in, ``(B, O)`` logits and
    ``(B, 1)`` spike counts out."""
    reads = T * B * n_in + T * B + weight_elems(n_in, n_hid, n_out)
    writes = B * n_out + B
    return F32_BYTES * (reads + writes)


def stream_step_tiled_bytes(T: int, B: int, n_in: int, n_hid: int,
                            n_out: int) -> int:
    """``rsnn_step_sessions``: the inference streams plus the ``live`` mask
    and the ``(2H + 2O + 1)`` carry elements per session, in and out."""
    state = B * (2 * n_hid + 2 * n_out + 1)
    reads = 2 * T * B + T * B * n_in + state + weight_elems(n_in, n_hid, n_out)
    return F32_BYTES * (reads + state)
