"""Schedulers of the serving runtime: whole-sample bucketing and continuous
session batching (counterpart of :mod:`repro.serve.scheduler`).

* :class:`BucketingScheduler` — requests are queued FIFO per padded tick
  length ("bucket") and released as rectangular tiles of at most
  ``max_batch`` requests.
* :class:`StreamPacker` — open sessions with processable ticks queue FIFO;
  each call packs up to ``max_batch`` of them into the next tick-tile.

Both queues are bounded (``max_pending``).  The bucketing scheduler's
admission policy is ``"reject"`` (raise
:class:`~repro_torch.serve.guard.OverloadError`) or ``"shed"`` (drop the
oldest queued request), and it drops deadline-expired requests at pack
time, before a launch is paid for them.

Determinism: admission order is FIFO within a bucket, buckets drain in
ascending tick length, and the same request sequence always yields the
same tiles (the clock stamps latency and deadlines only).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serve import batching
from repro_torch.serve.guard import OverloadError

ADMISSION_POLICIES = ("reject", "shed")


def _check_admission(admission: str) -> str:
    if admission not in ADMISSION_POLICIES:
        raise ValueError(
            f"admission must be one of {ADMISSION_POLICIES}, got {admission!r}"
        )
    return admission


@dataclasses.dataclass
class ServeRequest:
    """One admitted AER sample stream."""

    rid: int                      # admission index, unique per engine
    events: np.ndarray            # ragged uint32 AER buffer
    native_ticks: int             # end-of-sample tick + 1
    bucket: int                   # padded tick length this request serves at
    t_submit: float               # admission timestamp (latency accounting)
    meta: Optional[dict] = None
    deadline: Optional[float] = None  # absolute clock time; None = none


@dataclasses.dataclass
class BatchTile:
    """A rectangular unit of work: ≤ max_batch requests, one tick length."""

    num_ticks: int
    requests: List[ServeRequest]

    def __len__(self) -> int:
        return len(self.requests)


class BucketingScheduler:
    """FIFO admission → per-tick-length buckets → ≤ ``max_batch`` tiles.

    ``rid_alloc`` injects the request-id counter, so several schedulers
    (one per model lane) draw unique, admission-ordered ids.

    ``max_pending`` bounds the queue (``None`` = unbounded).  On overflow
    ``admission="reject"`` refuses the new request with
    :class:`OverloadError`; ``"shed"`` moves the oldest queued request
    into :attr:`shed`.  :meth:`take_expired` removes deadline-passed
    requests before tiles are packed.
    """

    def __init__(
        self,
        max_batch: int,
        tick_granularity: int = 32,
        clock: Callable[[], float] = time.monotonic,
        rid_alloc: Optional[Callable[[], int]] = None,
        max_pending: Optional[int] = None,
        admission: str = "reject",
    ):
        if max_batch < 1 or tick_granularity < 1:
            raise ValueError(
                f"max_batch and tick_granularity must be >= 1, got "
                f"({max_batch}, {tick_granularity})"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_batch = max_batch
        self.tick_granularity = tick_granularity
        self.max_pending = max_pending
        self.admission = _check_admission(admission)
        self._clock = clock
        self._buckets: Dict[int, List[ServeRequest]] = OrderedDict()
        self._next_rid = 0
        self._rid_alloc = rid_alloc or self._alloc_rid
        self.shed: List[ServeRequest] = []   # evicted under admission="shed"
        self._any_deadline = False   # no deadline ever queued: nothing expires

    def _alloc_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(self, events: np.ndarray, meta: Optional[dict] = None,
               deadline: Optional[float] = None) -> int:
        """Admit one AER sample stream; returns its request id.
        ``deadline`` is an absolute time on the scheduler's clock.  Raises
        :class:`OverloadError` when the queue is full under ``"reject"``."""
        if self.max_pending is not None and self.pending >= self.max_pending:
            if self.admission == "reject":
                raise OverloadError(
                    f"scheduler queue full ({self.pending} pending, "
                    f"max_pending={self.max_pending}); retry later or use "
                    'admission="shed"'
                )
            self.shed.append(self._pop_oldest())
        events = batching.trim_padding(events)
        native = batching.request_ticks(events)
        bucket = batching.bucket_ticks(native, self.tick_granularity)
        req = ServeRequest(
            rid=self._rid_alloc(), events=events, native_ticks=native,
            bucket=bucket, t_submit=self._clock(), meta=meta,
            deadline=deadline,
        )
        self._any_deadline |= deadline is not None
        self._buckets.setdefault(bucket, []).append(req)
        return req.rid

    def _pop_oldest(self) -> ServeRequest:
        """Remove and return the queued request with the lowest rid (each
        bucket is FIFO, so only the bucket heads compete)."""
        key = min((k for k, q in self._buckets.items() if q),
                  key=lambda k: self._buckets[k][0].rid)
        queue = self._buckets[key]
        victim = queue.pop(0)
        if not queue:
            del self._buckets[key]
        return victim

    def take_expired(self, now: Optional[float] = None,
                     agree: Optional[Callable[[List[int], List[int]], List[int]]] = None
                     ) -> List[ServeRequest]:
        """Remove and return every queued request whose deadline has
        passed (a scan of the queue, skipped while no request has ever
        carried a deadline).  ``agree(rids, queued_rids)`` replaces this
        scheduler's expired rids with the ones that decide (over a data
        mesh, rank 0's: :meth:`repro_torch.core.backend.ControlGroup.
        decide`)."""
        if not self._any_deadline:
            return []
        now = self._clock() if now is None else now
        queued = [req for ticks in self._buckets for req in self._buckets[ticks]]
        drop = {req.rid for req in queued if req.deadline is not None and now > req.deadline}
        if agree is not None:
            drop = set(agree(sorted(drop), [req.rid for req in queued]))
        expired: List[ServeRequest] = []
        for ticks in list(self._buckets):
            keep = []
            for req in self._buckets[ticks]:
                if req.rid in drop:
                    expired.append(req)
                else:
                    keep.append(req)
            if keep:
                self._buckets[ticks] = keep
            else:
                del self._buckets[ticks]
        return expired

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    def ready_tiles(self) -> Iterator[BatchTile]:
        """Release only *full* tiles."""
        yield from self._drain(full_only=True)

    def drain(self) -> Iterator[BatchTile]:
        """Release everything (end-of-stream flush)."""
        yield from self._drain(full_only=False)

    def _drain(self, full_only: bool) -> Iterator[BatchTile]:
        for ticks in sorted(self._buckets):
            queue = self._buckets[ticks]
            keep: List[ServeRequest] = []
            for tile in batching.split_into_tiles(queue, self.max_batch):
                if full_only and len(tile) < self.max_batch:
                    keep.extend(tile)
                else:
                    yield BatchTile(num_ticks=ticks, requests=tile)
            self._buckets[ticks] = keep
        self._buckets = OrderedDict(
            (k, v) for k, v in self._buckets.items() if v
        )


class StreamPacker:
    """Continuous batching over open sessions.

    :meth:`next_tile` pops up to ``max_batch`` ready sessions and picks the
    tile's tick length: ``tick_tile`` when set (latency-bounded
    streaming), else the bucketed maximum of the chosen sessions' pending
    ticks (throughput mode).  A session whose chunk did not drain it is
    re-queued by the engine, preserving FIFO fairness.

    ``max_pending`` bounds the queue's length in sessions; the packer sheds
    nothing itself (a session is stateful): :meth:`enqueue` reports the
    overflow and the engine pumps inline to make room.
    """

    def __init__(self, max_batch: int, tick_tile: Optional[int] = None,
                 tick_granularity: int = 32,
                 max_pending: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if tick_tile is not None and tick_tile < 1:
            raise ValueError(f"tick_tile must be >= 1, got {tick_tile}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_batch = max_batch
        self.tick_tile = tick_tile
        self.tick_granularity = tick_granularity
        self.max_pending = max_pending
        self._queue: deque = deque()

    @property
    def full(self) -> bool:
        return (self.max_pending is not None
                and len(self._queue) >= self.max_pending)

    def enqueue(self, sess) -> bool:
        """Add a session with pending work (idempotent while queued).
        False when the bounded queue is full and the session was not
        added."""
        if sess.queued:
            return True
        if self.full:
            return False
        sess.queued = True
        self._queue.append(sess)
        return True

    @property
    def pending(self) -> int:
        return len(self._queue)

    def next_tile(self) -> Optional[Tuple[List, int]]:
        """Pop the next ``(sessions, num_ticks)`` tile, or ``None``."""
        chosen: List = []
        while self._queue and len(chosen) < self.max_batch:
            sess = self._queue.popleft()
            sess.queued = False
            if sess.processable() > 0:
                chosen.append(sess)
        if not chosen:
            return None
        if self.tick_tile is not None:
            ticks = self.tick_tile
        else:
            ticks = batching.bucket_ticks(
                max(s.processable() for s in chosen), self.tick_granularity
            )
        return chosen, ticks
