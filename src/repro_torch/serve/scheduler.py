"""Schedulers of the serving runtime: whole-sample bucketing and continuous
session batching (counterpart of :mod:`repro.serve.scheduler`).

* :class:`BucketingScheduler` — requests are queued FIFO per padded tick
  length ("bucket") and released as rectangular tiles of at most
  ``max_batch`` requests.
* :class:`StreamPacker` — open sessions with processable ticks queue FIFO;
  each call packs up to ``max_batch`` of them into the next tick-tile.

Determinism: admission order is FIFO within a bucket, buckets drain in
ascending tick length, and the same request sequence always yields the
same tiles.  Bounded queues, shedding and deadlines (the JAX package's
admission control) are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serve import batching


@dataclasses.dataclass
class ServeRequest:
    """One admitted AER sample stream."""

    rid: int                      # admission index, unique per engine
    events: np.ndarray            # ragged uint32 AER buffer
    native_ticks: int             # end-of-sample tick + 1
    bucket: int                   # padded tick length this request serves at
    t_submit: float               # admission timestamp (latency accounting)
    meta: Optional[dict] = None


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
    """

    def __init__(
        self,
        max_batch: int,
        tick_granularity: int = 32,
        clock: Callable[[], float] = time.monotonic,
        rid_alloc: Optional[Callable[[], int]] = None,
    ):
        if max_batch < 1 or tick_granularity < 1:
            raise ValueError(
                f"max_batch and tick_granularity must be >= 1, got "
                f"({max_batch}, {tick_granularity})"
            )
        self.max_batch = max_batch
        self.tick_granularity = tick_granularity
        self._clock = clock
        self._buckets: Dict[int, List[ServeRequest]] = OrderedDict()
        self._next_rid = 0
        self._rid_alloc = rid_alloc or self._alloc_rid

    def _alloc_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(self, events: np.ndarray, meta: Optional[dict] = None) -> int:
        """Admit one AER sample stream; returns its request id."""
        events = batching.trim_padding(events)
        native = batching.request_ticks(events)
        bucket = batching.bucket_ticks(native, self.tick_granularity)
        req = ServeRequest(
            rid=self._rid_alloc(), events=events, native_ticks=native,
            bucket=bucket, t_submit=self._clock(), meta=meta,
        )
        self._buckets.setdefault(bucket, []).append(req)
        return req.rid

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
    """

    def __init__(self, max_batch: int, tick_tile: Optional[int] = None,
                 tick_granularity: int = 32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if tick_tile is not None and tick_tile < 1:
            raise ValueError(f"tick_tile must be >= 1, got {tick_tile}")
        self.max_batch = max_batch
        self.tick_tile = tick_tile
        self.tick_granularity = tick_granularity
        self._queue: deque = deque()

    def enqueue(self, sess) -> None:
        """Add a session with pending work (idempotent while queued)."""
        if not sess.queued:
            sess.queued = True
            self._queue.append(sess)

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
