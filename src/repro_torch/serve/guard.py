"""Input guards and the serving error model (counterpart of
:mod:`repro.serve.guard`; NumPy only).

* typed exceptions rooted at :class:`ServeError` /
  :class:`~repro_torch.core.aer.AEREncodingError`;
* vectorized AER validation (:func:`validate_events`): known type bytes,
  clean pad words, in-range spike addresses, tick monotonicity within a
  buffer and across feeds, per-feed quotas;
* the result status model (:class:`ServeStatus`);
* per-sample numeric health of a harvested logits tile (:func:`bad_rows`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.aer import (
    AEREncodingError,
    EVT_END,
    EVT_LABEL,
    EVT_SPIKE,
    MAX_ADDR,
    MAX_TICK,
)

__all__ = [
    "ServeError",
    "GuardError",
    "MalformedEventError",
    "StreamContractError",
    "QuotaExceededError",
    "OverloadError",
    "LaneFaultError",
    "ServeStatus",
    "GuardConfig",
    "validate_events",
    "bad_rows",
]


# --------------------------------------------------------------------------
# exception taxonomy
# --------------------------------------------------------------------------


class ServeError(Exception):
    """Base of every typed serving-layer error."""


class GuardError(ServeError, AEREncodingError):
    """An input buffer was rejected at the guard boundary.

    Subclasses :class:`~repro_torch.core.aer.AEREncodingError` so codec-level
    validation (``aer.encode_sample``) and serve-level validation share one
    catchable root — a caller guarding a feed loop catches
    ``AEREncodingError`` and gets both.
    """


class MalformedEventError(GuardError):
    """Bad word format: wrong dtype/shape, unknown type byte, out-of-range
    address/tick field, or a non-zero payload on a type-0 pad word."""


class StreamContractError(GuardError):
    """A structurally valid buffer that violates the stream contract:
    ticks decreasing within a buffer, a feed regressing behind an earlier
    feed, or feeding a closed session."""


class QuotaExceededError(GuardError):
    """A feed or session exceeded its configured event quota."""


class OverloadError(ServeError):
    """Admission rejected: the bounded queue is full under the
    ``"reject"`` policy.  Back off and retry, or switch the scheduler to
    ``admission="shed"`` to drop the oldest queued work instead."""


class LaneFaultError(ServeError):
    """A model lane could not contain a launch fault."""


# --------------------------------------------------------------------------
# result status model
# --------------------------------------------------------------------------


class ServeStatus(str, enum.Enum):
    """Terminal status of one unit of serving work.

    ``str``-valued so statuses JSON-serialise and compare against plain
    strings in stats pipelines.
    """

    OK = "ok"             # served; logits/pred are live
    REJECTED = "rejected"  # dropped at admission (guard or overload/shed)
    EXPIRED = "expired"    # deadline passed before launch; never paid for
    FAULT = "fault"        # numeric-health quarantine or unrecoverable lane fault

    def __str__(self) -> str:  # "ok", not "ServeStatus.OK", in messages
        return self.value


# --------------------------------------------------------------------------
# guard configuration + vectorized validation
# --------------------------------------------------------------------------

_KNOWN_KINDS = (0, EVT_END, EVT_LABEL, EVT_SPIKE)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Validation policy for one engine (per-lane ``n_in`` filled by the
    engine from each model's config when left ``None``).

    The quotas bound *memory*, which is what an overload or a hostile
    caller actually attacks: ``max_words_per_feed`` caps one buffer,
    ``max_pending_events`` caps a session's buffered-but-unprocessed spike
    backlog (the per-session half of the bounded-queue guarantee — the
    per-engine half is the scheduler/packer ``max_pending``).
    """

    n_in: Optional[int] = None          # spike addresses must be < n_in
    max_words_per_feed: int = 1 << 20   # 4 MiB of words per buffer
    max_pending_events: int = 1 << 20   # buffered spikes per session
    monotone: bool = True               # ticks non-decreasing within a buffer
    check_addresses: bool = True        # enforce the n_in bound

    def for_model(self, n_in: int) -> "GuardConfig":
        """The per-lane guard: ``n_in`` resolved from the model config."""
        if self.n_in is not None:
            return self
        return dataclasses.replace(self, n_in=int(n_in))


def validate_events(
    events,
    guard: GuardConfig,
    *,
    min_tick: int = 0,
    what: str = "event buffer",
) -> np.ndarray:
    """Validate one AER word buffer; returns it as a canonical 1-D uint32
    array or raises a :class:`GuardError` subclass naming the first
    violation.

    Checks (all vectorized):

    * coercible to uint32 without value loss (integer dtype, in
      ``[0, 2**32)``), at most ``max_words_per_feed`` words;
    * every non-pad word carries a known type byte
      (``EVT_SPIKE | EVT_LABEL | EVT_END``) — and pad words are *exactly*
      ``0x0`` (a zero type byte over a non-zero payload is a corrupted
      word, not padding);
    * spike addresses below ``n_in`` (the model's input width — an
      out-of-range address would silently scatter into another neuron's
      row or be dropped, depending on the path; both corrupt);
    * ticks non-decreasing within the buffer and ``>= min_tick`` (the
    cross-feed stream contract; pass the session's high-water mark).
    """
    arr = np.asarray(events)
    if arr.dtype == object or not (
        np.issubdtype(arr.dtype, np.integer)
        or np.issubdtype(arr.dtype, np.unsignedinteger)
    ):
        raise MalformedEventError(
            f"{what}: expected an integer array of AER words, got dtype "
            f"{arr.dtype}"
        )
    words = arr.ravel()
    if words.size > guard.max_words_per_feed:
        raise QuotaExceededError(
            f"{what}: {words.size} words exceeds the per-feed quota "
            f"({guard.max_words_per_feed})"
        )
    if words.size == 0:
        return words.astype(np.uint32)
    w64 = words.astype(np.int64)
    if (w64 < 0).any() or (w64 > 0xFFFFFFFF).any():
        bad = w64[(w64 < 0) | (w64 > 0xFFFFFFFF)][0]
        raise MalformedEventError(
            f"{what}: word value {bad} outside the 32-bit AER word range"
        )
    words = words.astype(np.uint32)
    kind = words >> 24
    known = np.isin(kind, _KNOWN_KINDS)
    if not known.all():
        i = int(np.nonzero(~known)[0][0])
        raise MalformedEventError(
            f"{what}: word {i} (0x{int(words[i]):08x}) carries unknown "
            f"type byte 0x{int(kind[i]):02x}"
        )
    pad_payload = (kind == 0) & (words != 0)
    if pad_payload.any():
        i = int(np.nonzero(pad_payload)[0][0])
        raise MalformedEventError(
            f"{what}: word {i} (0x{int(words[i]):08x}) has type byte 0 but "
            "a non-zero payload — corrupted word, not padding"
        )
    live = kind != 0
    if guard.check_addresses and guard.n_in is not None:
        addr = (words >> 12) & MAX_ADDR
        bad_addr = (kind == EVT_SPIKE) & (addr >= guard.n_in)
        if bad_addr.any():
            i = int(np.nonzero(bad_addr)[0][0])
            raise MalformedEventError(
                f"{what}: spike word {i} targets neuron {int(addr[i])}, "
                f"model has n_in={guard.n_in}"
            )
    if guard.monotone and live.any():
        tick = (words & MAX_TICK).astype(np.int64)[live]
        if int(tick[0]) < min_tick:
            raise StreamContractError(
                f"{what}: first tick {int(tick[0])} regresses behind the "
                f"stream's high-water mark {min_tick} (feeds must be "
                "tick-ordered and non-decreasing across buffers)"
            )
        steps = np.diff(tick)
        if (steps < 0).any():
            i = int(np.nonzero(steps < 0)[0][0])
            raise StreamContractError(
                f"{what}: ticks decrease within the buffer "
                f"({int(tick[i])} -> {int(tick[i + 1])} at live word {i + 1})"
            )
    return words


# --------------------------------------------------------------------------
# per-sample numeric health on harvest
# --------------------------------------------------------------------------


def bad_rows(
    acc: np.ndarray,
    quant=None,
    ticks=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample numeric health of one harvested logits tile.

    ``acc`` is ``(B, n_out)`` accumulated readout; ``ticks`` is the ticks
    each row has accumulated over — a scalar or a length-``B`` vector (the
    streaming path passes each session's cumulative tick count).  Returns
    ``(bad, saturated)`` boolean masks over the batch axis:

    * **float mode** (``quant is None``): a row is bad iff it contains a
      non-finite value — NaN poisons the argmax and, for a streaming
      session, the carry chain.
    * **quantized mode**: carries are integers on the 12-bit membrane grid
      held in float32; NaN/inf still marks a row bad, and a row whose
      magnitude exceeds the grid's reachable accumulation bound
      (``|acc_y| > mem_max * ticks`` — the LI readout adds at most one
      full-scale membrane value per valid tick) is a *saturation storm*:
      arithmetic escaped the saturating datapath, which on the chip means a
      stuck-at fault or an SEU, and here means corrupted state.  Saturated
      rows are reported in both masks so stats can count storms
      specifically.
    """
    acc = np.asarray(acc)
    bad = ~np.isfinite(acc).all(axis=-1)
    saturated = np.zeros(acc.shape[:-1], bool)
    if quant is not None:
        mem_max = float(quant.membrane_spec.max_val)
        if ticks is None:
            t = np.float64(MAX_TICK + 1)
        else:
            t = np.maximum(np.asarray(ticks, np.float64), 1.0)
        bound = np.broadcast_to(mem_max * t, acc.shape[:-1])
        with np.errstate(invalid="ignore"):
            saturated = (
                np.abs(acc) > bound[..., None]
            ).any(axis=-1) & ~bad
        bad = bad | saturated
    return bad, saturated
