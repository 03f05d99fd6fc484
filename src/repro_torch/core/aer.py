"""AER event codec — the paper's 32-bit packed event-word format (PyTorch).

Counterpart of :mod:`repro.core.aer`.  The word format is the FPGA BRAM
image format of the paper (§3.1)::

    [31:24] type | [23:12] address/label | [11:0] tick

with type ``0x03`` = spike, ``0x02`` = label, ``0x01`` = end of sample.
Host-side encoding is NumPy (the "BRAM image builder"); decoding to a dense
``(T, N)`` raster runs on tensors of any device.  Words are carried as
``int64`` tensors on the torch side (torch's ``uint32`` supports too few
operators to be a working dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

EVT_END = 0x01
EVT_LABEL = 0x02
EVT_SPIKE = 0x03

ADDR_BITS = 12
TICK_BITS = 12
MAX_ADDR = (1 << ADDR_BITS) - 1   # 4095
MAX_TICK = (1 << TICK_BITS) - 1   # 4095


class AEREncodingError(ValueError):
    """A value does not fit the 32-bit AER word format (12-bit address /
    12-bit tick / known type byte) or violates buffer structure.  Root of
    the serving guard hierarchy (:class:`repro_torch.serve.guard.GuardError`
    subclasses it)."""


def _as_words(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64))


def pack(kind, addr, tick) -> torch.Tensor:
    """Pack event fields into 32-bit words (held in ``int64``)."""
    kind, addr, tick = _as_words(kind), _as_words(addr), _as_words(tick)
    return ((kind & 0xFF) << 24) | ((addr & MAX_ADDR) << 12) | (tick & MAX_TICK)


def unpack(words) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpack words into ``(kind, addr, tick)``."""
    w = _as_words(words) & 0xFFFFFFFF
    return (w >> 24) & 0xFF, (w >> 12) & MAX_ADDR, w & MAX_TICK


@dataclasses.dataclass(frozen=True)
class Sample:
    """A decoded sample: dense raster + label metadata."""

    raster: torch.Tensor      # (T, N) float {0,1}
    label: torch.Tensor       # () int64
    label_tick: torch.Tensor  # () int64 — tick at which supervision becomes valid
    end_tick: torch.Tensor    # () int64 — final tick of the sample (inclusive)


def encode_sample(
    raster: np.ndarray, label: int, label_tick: int,
    end_tick: Optional[int] = None,
) -> np.ndarray:
    """Encode a dense raster into a tick-sorted uint32 event buffer: spike
    and label words sorted by tick (stable), then one end-of-sample word."""
    raster = np.asarray(raster)
    T, N = raster.shape
    if end_tick is None:
        end_tick = T - 1
    if T - 1 > MAX_TICK or N - 1 > MAX_ADDR:
        raise AEREncodingError(
            f"raster ({T}, {N}) exceeds the 12-bit tick/address fields "
            f"(max {MAX_TICK + 1} ticks x {MAX_ADDR + 1} neurons)"
        )
    label, label_tick, end_tick = int(label), int(label_tick), int(end_tick)
    if not 0 <= label <= MAX_ADDR:
        raise AEREncodingError(f"label {label} exceeds the 12-bit field")
    if not 0 <= label_tick <= MAX_TICK:
        raise AEREncodingError(f"label_tick {label_tick} exceeds 12 bits")
    if not 0 <= end_tick <= MAX_TICK:
        raise AEREncodingError(f"end_tick {end_tick} exceeds 12 bits")
    t_idx, n_idx = np.nonzero(raster)
    words = (
        (np.uint32(EVT_SPIKE) << 24) | (n_idx.astype(np.uint32) << 12)
        | t_idx.astype(np.uint32)
    )
    label_word = np.uint32((EVT_LABEL << 24) | (label << 12) | label_tick)
    end_word = np.uint32((EVT_END << 24) | end_tick)
    all_words = np.concatenate([words, np.array([label_word], np.uint32)])
    order = np.argsort(all_words & MAX_TICK, kind="stable")
    return np.concatenate([all_words[order], np.array([end_word], np.uint32)])


def decode_sample(words, num_in: int, num_ticks: int) -> Sample:
    """Decode one (possibly 0x0-padded) event buffer into a dense raster.
    Spikes outside ``[0, num_ticks)`` are dropped; repeated spikes clamp
    to 1 (AER delivers unary spikes)."""
    kind, addr, tick = unpack(words)
    is_spike = (kind == EVT_SPIKE) & (tick < num_ticks) & (addr < num_in)
    raster = torch.zeros((num_ticks, num_in), dtype=torch.float32,
                         device=kind.device)
    raster[tick[is_spike], addr[is_spike]] = 1.0
    zero = torch.zeros((), dtype=torch.int64, device=kind.device)

    def masked_max(mask, x):
        return torch.where(mask, x, zero).max() if x.numel() else zero

    return Sample(
        raster=raster,
        label=masked_max(kind == EVT_LABEL, addr),
        label_tick=masked_max(kind == EVT_LABEL, tick),
        end_tick=masked_max(kind == EVT_END, tick),
    )


def decode_batch(words, num_in: int, num_ticks: int) -> Sample:
    """:func:`decode_sample` over a batch of fixed-size ``(S, L)`` event
    buffers, on the words' device → a :class:`Sample` of ``(S, T, N)``
    rasters and ``(S,)`` label fields."""
    kind, addr, tick = unpack(words)
    S = kind.shape[0]
    is_spike = (kind == EVT_SPIKE) & (tick < num_ticks) & (addr < num_in)
    raster = torch.zeros((S, num_ticks, num_in), dtype=torch.float32,
                         device=kind.device)
    rows = torch.arange(S, device=kind.device)[:, None].expand_as(kind)
    raster[rows[is_spike], tick[is_spike], addr[is_spike]] = 1.0
    zero = torch.zeros((), dtype=torch.int64, device=kind.device)

    def masked_max(mask, x):
        if x.shape[1] == 0:
            return torch.zeros((S,), dtype=torch.int64, device=kind.device)
        return torch.where(mask, x, zero).max(dim=1).values

    is_label = kind == EVT_LABEL
    return Sample(
        raster=raster,
        label=masked_max(is_label, addr),
        label_tick=masked_max(is_label, tick),
        end_tick=masked_max(kind == EVT_END, tick),
    )


def pad_events(buffers: list, length: Optional[int] = None) -> np.ndarray:
    """Right-pad a list of event buffers with 0x0 words into a dense matrix."""
    length = length or max(len(b) for b in buffers)
    out = np.zeros((len(buffers), length), np.uint32)
    for i, b in enumerate(buffers):
        if len(b) > length:
            raise AEREncodingError(
                f"buffer {i} has {len(b)} words, pad length is {length}"
            )
        out[i, : len(b)] = b
    return out


def supervision_mask(
    label_tick, end_tick, num_ticks: int, label_delay: int = 0
) -> torch.Tensor:
    """Per-tick TARGET_VALID mask: ticks in ``[label_tick + delay,
    end_tick]``; ``(T,)`` for one sample, ``(S, T)`` for ``(S,)`` fields."""
    label_tick = torch.as_tensor(label_tick)
    end_tick = torch.as_tensor(end_tick)
    t = torch.arange(num_ticks, device=label_tick.device)
    if label_tick.ndim:
        label_tick, end_tick = label_tick[:, None], end_tick[:, None]
    return ((t >= label_tick + label_delay) & (t <= end_tick)).to(torch.float32)
