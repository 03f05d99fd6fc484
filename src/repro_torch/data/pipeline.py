"""The two SoC dataflow modes as host-to-device pipelines (counterpart of
:mod:`repro.data.pipeline`).

* :class:`ResidentPipeline` — **X-HEEP mode**.  The whole encoded dataset
  is copied to the device once, decoded once, and every epoch replays the
  resident tensors: no host-to-device traffic after start-up.
* :class:`BatchedOffloadPipeline` — **ARM mode**.  The dataset stays on the
  host; batches of ``samples_per_batch`` are offloaded and decoded on the
  device, the transfer of batch k+1 started before batch k is handed out
  (the BATCH_DONE/NEW_BATCH handshake as a prefetch).

Both yield identical decoded batches — ``{"raster": (S, T, N) f32,
"label": (S,) int64, "valid": (S, T) f32}`` — so the controller is
mode-agnostic.  Batch order is a pure function of ``(seed, epoch)``, and
``batches(split, epoch, start_batch=k)`` skips the first ``k`` batches
without offloading them.  Pipelines run on ``device="cuda"`` unless the
caller passes ``"cpu"``.

The serving side: :class:`EventStream` replays a split as ragged
per-sample AER buffers (the requests a deployed SoC receives), and
:func:`interleave_train_serve` interleaves a training pipeline's batches
with those requests, the paper's learning-while-serving feed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import aer
from repro_torch.core.controller import DeviceBatch, decode_events_to_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.batching import trim_padding
from repro_torch.serve.guard import GuardError, validate_events


def event_density(events, n_in: Optional[int] = None,
                  num_ticks: Optional[int] = None) -> float:
    """Measured per-channel event density of AER word buffers: spike words
    per ``(tick, channel)`` slot.  ``events`` is a padded ``(S, L)`` word
    matrix with ``n_in`` / ``num_ticks``, or a split dict
    ``{"events", "n_in", "num_ticks"}``.  Only spike words count."""
    if isinstance(events, dict):
        n_in = int(events["n_in"])
        num_ticks = int(events["num_ticks"])
        events = events["events"]
    if not (n_in and num_ticks):
        raise ValueError("need n_in and num_ticks (or a split dict)")
    words = np.asarray(events, np.uint32)
    n_samples = words.shape[0] if words.ndim > 1 else 1
    n_spike = int((((words >> 24) & 0xFF) == aer.EVT_SPIKE).sum())
    return n_spike / float(n_samples * num_ticks * n_in)


@dataclasses.dataclass
class PipelineStats:
    """Telemetry of the two modes (the paper's Tables 1/2)."""

    h2d_bytes: int = 0        # host-to-device bytes copied
    resident_bytes: int = 0   # device-resident dataset footprint
    transfers: int = 0        # number of host-to-device copies


class _Base:
    def __init__(self, dataset: Dict[str, Dict[str, np.ndarray]],
                 label_delay: int = 0, device: DeviceLike = None):
        self.dataset = dataset
        self.label_delay = label_delay
        self.device = resolve_device(device)
        self.stats = PipelineStats()

    def _offload(self, words: np.ndarray, meta: Dict) -> DeviceBatch:
        """Copy ``(S, L)`` words to the device and decode them there."""
        host = torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64))
        dev_words = host.to(self.device)
        self.stats.h2d_bytes += words.nbytes
        self.stats.transfers += 1
        return decode_events_to_batch(dev_words, meta["n_in"],
                                      meta["num_ticks"], self.label_delay)


class ResidentPipeline(_Base):
    """X-HEEP mode: one copy per split at construction, epochs replay it."""

    def __init__(self, dataset, label_delay: int = 0,
                 device: DeviceLike = None):
        super().__init__(dataset, label_delay, device)
        self._resident: Dict[str, DeviceBatch] = {}
        for split, d in dataset.items():
            batch = self._offload(d["events"], d)
            self._resident[split] = batch
            self.stats.resident_bytes += d["events"].nbytes + sum(
                x.numel() * x.element_size() for x in batch.values())

    def batches(self, split: str, epoch: int,
                start_batch: int = 0) -> Iterator[DeviceBatch]:
        if split in self._resident and start_batch == 0:
            yield self._resident[split]


class BatchedOffloadPipeline(_Base):
    """ARM mode: host-resident dataset, BRAM-sized chunks, prefetch."""

    def __init__(self, dataset, samples_per_batch: int, label_delay: int = 0,
                 prefetch: int = 2, shuffle_train: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(dataset, label_delay, device)
        self.samples_per_batch = samples_per_batch
        self.prefetch = max(1, prefetch)
        self.shuffle_train = shuffle_train
        self.seed = seed

    def _order(self, split: str, n: int, epoch: int) -> np.ndarray:
        # a pure function of (seed, epoch): a replayed epoch shuffles alike
        if split == "train" and self.shuffle_train:
            return np.random.default_rng([self.seed, epoch]).permutation(n)
        return np.arange(n)

    def batches(self, split: str, epoch: int,
                start_batch: int = 0) -> Iterator[DeviceBatch]:
        """Yield the epoch's decoded device batches; ``start_batch`` skips
        the first ``k`` without offloading them."""
        if split not in self.dataset:
            return
        d = self.dataset[split]
        events = d["events"]
        order = self._order(split, events.shape[0], epoch)
        spb = self.samples_per_batch
        chunks = [order[i: i + spb] for i in range(0, len(order), spb)]
        chunks = chunks[start_batch:]
        inflight = [self._offload(events[idx], d) for idx in chunks[: self.prefetch]]
        ptr = self.prefetch
        while inflight:
            batch = inflight.pop(0)
            if ptr < len(chunks):
                inflight.append(self._offload(events[chunks[ptr]], d))
                ptr += 1
            yield batch


class EventStream:
    """A dataset split replayed as trimmed uint32 AER buffers, one request
    at a time, on the host.

    ``repeat`` loops the split; ``shuffle`` permutes each pass with
    ``np.random.default_rng([seed, pass])``, so the order is a pure
    function of ``(seed, pass)``.  The cursor ``(pass, offset)`` is the
    next request: :meth:`state` snapshots it, :meth:`seek` restores it, and
    iteration advances it in place (one consumer; a drained stream yields
    nothing until :meth:`reset`).

    ``guard`` (a :class:`~repro_torch.serve.guard.GuardConfig`) validates
    every buffer before it is yielded.  ``on_invalid="raise"`` propagates
    the :class:`~repro_torch.serve.guard.GuardError` with the cursor past
    the bad sample; ``"skip"`` drops it and counts it in :attr:`invalid`.
    """

    def __init__(self, dataset: Dict[str, Dict[str, np.ndarray]],
                 split: str = "test", *, repeat: int = 1,
                 shuffle: bool = False, seed: int = 0, guard=None,
                 on_invalid: str = "raise"):
        if split not in dataset:
            raise KeyError(f"split {split!r} not in dataset (have {list(dataset)})")
        if on_invalid not in ("raise", "skip"):
            raise ValueError(
                f"on_invalid must be 'raise' or 'skip', got {on_invalid!r}")
        self.meta = dataset[split]
        self.events = np.asarray(self.meta["events"], np.uint32)
        self.repeat = repeat
        self.shuffle = shuffle
        self.seed = seed
        self.guard = guard
        self.on_invalid = on_invalid
        self.invalid = 0     # buffers the guard rejected
        self.pass_idx = 0    # cursor: current pass through the split
        self.offset = 0      # cursor: next index into that pass's order

    def __len__(self) -> int:
        return self.events.shape[0] * self.repeat

    def state(self) -> Dict[str, int]:
        return {"pass": int(self.pass_idx), "offset": int(self.offset),
                "seed": int(self.seed)}

    def seek(self, state: Dict[str, int]) -> None:
        """Restore a :meth:`state` snapshot (taken under the same seed)."""
        if int(state.get("seed", self.seed)) != int(self.seed):
            raise ValueError(
                f"EventStream cursor was recorded under seed {state['seed']}, "
                f"this stream uses {self.seed}")
        self.pass_idx = int(state["pass"])
        self.offset = int(state["offset"])

    def reset(self) -> None:
        self.pass_idx = 0
        self.offset = 0

    def _order(self, pass_idx: int) -> np.ndarray:
        n = self.events.shape[0]
        if self.shuffle:
            return np.random.default_rng([self.seed, pass_idx]).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = self.events.shape[0]
        while self.pass_idx < self.repeat:
            order = self._order(self.pass_idx)
            while self.offset < n:
                i = int(order[self.offset])
                self.offset += 1
                buf = trim_padding(self.events[i])
                if self.guard is not None:
                    try:
                        buf = validate_events(buf, self.guard,
                                              what=f"stream sample {i}")
                    except GuardError:
                        self.invalid += 1
                        if self.on_invalid == "raise":
                            raise
                        continue
                yield buf
            self.pass_idx += 1
            self.offset = 0


def interleave_train_serve(pipeline, stream, epoch: int = 0,
                           split: str = "train",
                           serve_per_batch: int = 8) -> Iterator[tuple]:
    """Learning-while-serving feed: ``("train", device_batch)`` items from
    a training pipeline, each followed by up to ``serve_per_batch``
    ``("serve", events)`` requests from an :class:`EventStream`; leftover
    requests drain after the epoch."""
    requests = iter(stream)
    for batch in pipeline.batches(split, epoch):
        yield ("train", batch)
        for _ in range(serve_per_batch):
            try:
                yield ("serve", next(requests))
            except StopIteration:
                break
    for ev in requests:
        yield ("serve", ev)


def make_pipeline(mode: str, dataset, samples_per_batch: Optional[int] = None,
                  label_delay: int = 0, **kw):
    """Factory keyed on the paper's two controller modes."""
    if mode in ("xheep", "resident"):
        return ResidentPipeline(dataset, label_delay, **kw)
    if mode in ("arm", "offload"):
        if not samples_per_batch:
            raise ValueError("ARM mode needs samples_per_batch (BRAM depth)")
        return BatchedOffloadPipeline(dataset, samples_per_batch, label_delay, **kw)
    raise ValueError(f"unknown pipeline mode {mode!r}")
