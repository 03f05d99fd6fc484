"""Padding / masking / sizing utilities for the serving runtime
(counterpart of :mod:`repro.serve.batching`; NumPy only).

Ragged AER sample streams become rectangular ``(T, B, N_in)`` tiles.
Padding is inert by two invariants: padded ticks carry zero input spikes,
and the readout accumulates under the per-sample TARGET_VALID mask, which
is zero on padded ticks — so ``acc_y`` equals the native-length run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.aer import EVT_END, EVT_LABEL, EVT_SPIKE, MAX_ADDR, MAX_TICK
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.kernels.rsnn_step import max_batch_for_dims, session_state_bytes

# Default device-byte budget for the streaming session pool: 4 MiB holds
# ~12k Braille-sized sessions (332 B each).  The pool is the capacity unit
# of streaming serving; scale this up for larger fleets.
DEFAULT_SESSION_STATE_BUDGET = 4 * 1024 * 1024


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def max_batch_for(cfg: RSNNConfig, num_devices: int = 1) -> int:
    """Serving admission size per launch: the largest power of two whose
    rows all run at once on one card — one full kernel block on each SM
    (:func:`repro_torch.kernels.rsnn_step.max_batch_for_dims`) — times the
    data-parallel rank count (one full launch a rank)."""
    return max_batch_for_dims(cfg.n_in, cfg.n_hid, cfg.n_out) * max(1, int(num_devices))


def max_sessions_for(
    cfg: RSNNConfig,
    state_budget: int = DEFAULT_SESSION_STATE_BUDGET,
) -> int:
    """Streaming capacity ``S_cap``: how many resident sessions a device
    byte budget admits.  One session's carry ``(v, z, y, acc_y, n_spk)``
    costs :func:`repro_torch.kernels.rsnn_step.session_state_bytes` =
    ``4·(2H + 2O + 1)`` bytes, independent of stream length — the pool, not
    the batch, is the capacity unit of streaming serving."""
    per = session_state_bytes(cfg.n_hid, cfg.n_out)
    return max(1, int(state_budget) // per)


def request_ticks(events: np.ndarray) -> int:
    """Native tick count of an AER request = end-of-sample tick + 1.

    Falls back to the largest event tick when the END word is missing
    (a stream cut mid-sample).
    """
    words = np.asarray(events, np.uint32)
    kind = words >> 24
    ticks = words & MAX_TICK
    is_end = kind == EVT_END
    if is_end.any():
        return int(ticks[is_end].max()) + 1
    live = kind != 0
    return int(ticks[live].max()) + 1 if live.any() else 1


def bucket_ticks(native_ticks: int, granularity: int, cap: int = MAX_TICK + 1) -> int:
    """Padded tick length of the bucket a request lands in."""
    return min(round_up(max(1, native_ticks), granularity), cap)


def decode_events_host(
    events_list: Sequence[np.ndarray],
    n_in: int,
    num_ticks: int,
    label_delay: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side AER decode of one bucket → ``(raster, valid, labels)``.

    The serving analog of the SoC's ARM-side AER handling: one flat NumPy
    pass over the bucket, :func:`repro_torch.core.aer.decode_sample` +
    :func:`repro_torch.core.aer.supervision_mask` semantics.

    Returns ``raster (T, B, n_in) f32``, ``valid (T, B) f32``,
    ``labels (B,) i32``.
    """
    B = len(events_list)
    raster = np.zeros((num_ticks, B, n_in), np.float32)
    labels = np.zeros((B,), np.int32)

    # One flat pass over the whole bucket: concatenate every buffer and carry
    # a per-word sample index — no per-sample Python loop on the hot path.
    bufs = [np.asarray(w, np.uint32).ravel() for w in events_list]
    words = np.concatenate(bufs) if bufs else np.zeros(0, np.uint32)
    b_idx = np.repeat(np.arange(B, dtype=np.int64), [len(w) for w in bufs])
    kind = words >> 24
    addr = ((words >> 12) & MAX_ADDR).astype(np.int64)
    tick = (words & MAX_TICK).astype(np.int64)

    sp = (kind == EVT_SPIKE) & (tick < num_ticks) & (addr < n_in)
    raster[tick[sp], b_idx[sp], addr[sp]] = 1.0

    # END-less buffers decode with end_tick = 0, exactly like the device path
    # (aer.decode_sample's masked max) — never the padded bucket length, which
    # would make the valid mask depend on which bucket the request landed in.
    label_tick = np.zeros((B,), np.int64)
    end_tick = np.zeros((B,), np.int64)
    lab = kind == EVT_LABEL
    np.maximum.at(labels, b_idx[lab], addr[lab].astype(np.int32))
    np.maximum.at(label_tick, b_idx[lab], tick[lab])
    end = kind == EVT_END
    np.maximum.at(end_tick, b_idx[end], tick[end])

    t_range = np.arange(num_ticks)[:, None]
    valid = (
        (t_range >= label_tick[None, :] + label_delay)
        & (t_range <= end_tick[None, :])
    ).astype(np.float32)
    return raster, valid, labels


def decode_session_chunks(
    chunks: Sequence,
    n_in: int,
    num_ticks: int,
    label_delay: int = 0,
    b_pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side decode of one streaming tick-tile → ``(raster, live,
    valid)``, each lane one session's next stream ticks.

    ``chunks`` are :class:`repro_torch.serve.session.SessionChunkRef` slices in
    absolute stream coordinates; lane ``i``'s tile tick ``t`` is stream tick
    ``chunks[i].base + t``.  Two masks come back:

    * ``live`` — dynamics mask: 1 for ``t < n_live``.  A dead tick freezes
      the session's carry *exactly* (the kernel selects, it does not decay),
      which is how ragged per-session chunk lengths pack into one
      rectangular tile; padded lanes (``b_pad > len(chunks)``) are dead for
      the whole tile.
    * ``valid`` — readout-accumulation mask (⊆ live), the streaming
      continuation of :func:`decode_events_host`'s TARGET_VALID window:
      ``label_tick + label_delay ≤ t_abs``, and ``t_abs ≤ end_tick`` once
      END has been seen.  Because feeds are tick-ordered, the incremental
      mask equals the whole-sample one.
    """
    B = len(chunks)
    b_pad = B if b_pad is None else b_pad
    raster = np.zeros((num_ticks, b_pad, n_in), np.float32)
    if B:
        bufs_t = [c.sp_tick - c.base for c in chunks]
        t = np.concatenate(bufs_t) if bufs_t else np.zeros(0, np.int64)
        a = np.concatenate([c.sp_addr for c in chunks]) if B else t
        b_idx = np.repeat(
            np.arange(B, dtype=np.int64), [len(x) for x in bufs_t]
        )
        ok = (t >= 0) & (t < num_ticks) & (a < n_in)
        raster[t[ok], b_idx[ok], a[ok]] = 1.0

    n_live = np.zeros((b_pad,), np.int64)
    lab0 = np.zeros((b_pad,), np.int64)
    end_rel = np.full((b_pad,), -1, np.int64)
    for i, c in enumerate(chunks):
        n_live[i] = c.n_live
        lab0[i] = c.label_tick + label_delay - c.base
        end_rel[i] = (
            num_ticks - 1 if c.end_tick is None else c.end_tick - c.base
        )
    t_range = np.arange(num_ticks)[:, None]
    live = (t_range < n_live[None, :]).astype(np.float32)
    valid = (
        (t_range >= lab0[None, :]) & (t_range <= end_rel[None, :])
    ).astype(np.float32) * live
    return raster, live, valid


def pad_batch(
    raster: np.ndarray,
    valid: np.ndarray,
    target_b: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad the batch axis with dead samples (zero input, zero valid).

    Batch sizes are padded to a small set of capacities (powers of two, see
    :func:`padded_batch_size`) so partial buckets launch a few tile shapes.
    """
    T, B, N = raster.shape
    if B == target_b:
        return raster, valid
    if B > target_b:
        raise ValueError(
            f"batch of {B} rows cannot pad down to target_b={target_b}"
        )
    pad_r = np.zeros((T, target_b - B, N), raster.dtype)
    pad_v = np.zeros((T, target_b - B), valid.dtype)
    return np.concatenate([raster, pad_r], axis=1), np.concatenate([valid, pad_v], axis=1)


def padded_batch_size(b: int, max_batch: int) -> int:
    """Next power of two ≥ b, clipped to max_batch."""
    p = 1
    while p < b:
        p <<= 1
    return min(p, max_batch)


def trim_padding(events_row: np.ndarray) -> np.ndarray:
    """Strip the trailing 0x0 pad words a dense event matrix row carries."""
    words = np.asarray(events_row, np.uint32)
    live = np.nonzero(words >> 24)[0]
    return words[: live[-1] + 1] if live.size else words[:0]


def split_into_tiles(
    items: List, max_batch: int
) -> List[List]:
    """FIFO-stable chop of a bucket's queue into ≤ max_batch tiles."""
    return [items[i : i + max_batch] for i in range(0, len(items), max_batch)]
