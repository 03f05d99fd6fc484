"""Session-first serving engine over the shared execution backend
(counterpart of :mod:`repro.serve.engine`).

The primary model is the **session**: ``engine.open_session()`` returns a
:class:`SessionHandle`; ``feed(events)`` appends AER words; the pump packs
sessions with processable ticks into fixed-shape tick-tiles
(:class:`~repro_torch.serve.scheduler.StreamPacker`), gathers their
device-resident carries from the :class:`~repro_torch.serve.session.
SessionPool`, launches the backend's ``step_sessions`` op and scatters the
carries back; ``poll()`` returns incremental snapshots and ``result()`` the
final classification.  The whole-sample path (``submit`` / ``serve``,
bucketed by :class:`~repro_torch.serve.scheduler.BucketingScheduler`) runs
each tile through the same op with zero carries in; ``run_tile`` and
``warmup`` also drive the ``inference`` op.

Every registered model gets a lane (scheduler, packer, pool); tiles never
mix models.  ``BatchedEngine(cfg, params)`` is the one-lane case over a
private :class:`~repro_torch.serve.registry.ModelRegistry`.

The engine runs where its backend runs: ``device="cuda"`` (the default;
raises without a card) launches the hand-written kernels, ``"cpu"`` the
plain versions.  Launches are asynchronous; results are harvested when a
tile's CUDA event reports done, and ``serve`` synchronises once at the
end-of-stream drain.  In quantized mode logits are the chip's membrane-grid
readout accumulators (argmax unchanged) and ``update_weights`` snaps the
image onto the 8-bit SRAM grid.

Dropped work is a typed result, never a hole: a buffer the guard refuses,
a submit a full bounded queue refuses or sheds (REJECTED), a request or
session whose deadline passes before its tile is packed (EXPIRED), and a
row that fails the numeric health check at harvest (FAULT, one session
quarantined, its tile-mates untouched).  A launch fault restarts the lane
(a fresh backend on the same device, sessions re-seated from bit-exact
host copies) and relaunches the work.  Only two kinds of fault are
recovered: an exception raised by ``fault_hook`` and a launcher error code
that leaves the CUDA context usable
(:class:`~repro_torch.kernels.launch.KernelLaunchError` with ``sticky``
false).  Anything else, a sticky CUDA error above all, reaches the caller:
no in-process restart can recover a poisoned context.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.backend import BackendLike, ExecutionBackend, RuntimeConfig
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.kernels import traffic
from repro_torch.kernels.launch import KernelLaunchError
from repro_torch.serve import batching
from repro_torch.serve.guard import (
    GuardConfig,
    GuardError,
    OverloadError,
    QuotaExceededError,
    ServeStatus,
    bad_rows,
    validate_events,
)
from repro_torch.serve.registry import DEFAULT_MODEL, ModelRegistry, ModelSpec
from repro_torch.serve.scheduler import (
    BatchTile,
    BucketingScheduler,
    ServeRequest,
    StreamPacker,
)
from repro_torch.serve.session import (
    SessionPool,
    SessionSnapshot,
    _Session,
    host_copy,
)

# Engine options whose decisions each rank would take alone: deadlines and
# idle offload read the rank's own clock, the fault hook its own faults.
# A lane over a data mesh refuses them (BatchedEngine).
PER_RANK_OPTIONS = ("default_deadline_s", "session_deadline_s", "idle_timeout",
                    "fault_hook")


@dataclasses.dataclass
class ServeResult:
    """Per-request classification + accounting (``pred == -1`` and zero
    logits when ``status`` is not OK; ``latency_s`` is then admission →
    drop decision)."""

    rid: int
    pred: int
    logits: np.ndarray        # accumulated LI readout acc_y, shape (n_out,)
    label: int                # label carried by the AER stream (0 if absent)
    latency_s: float          # admission → result delivery (harvest)
    bucket_ticks: int         # padded tick length served at
    batch_size: int           # live samples in the tile
    model_id: str = DEFAULT_MODEL
    status: ServeStatus = ServeStatus.OK


@dataclasses.dataclass
class ServeStats:
    requests: int
    batches: int
    wall_s: float
    samples_per_sec: float
    p50_latency_s: float
    p99_latency_s: float
    mean_batch: float
    rebuilds: int                 # datapath-weight derivations (see backend)
    hbm_bytes_streamed: int = 0   # device-memory bytes the kernels moved
    # How many of `requests` ended non-OK (shed is the subset of rejected
    # that admission="shed" evicted) and the lane restarts of the window.
    rejected: int = 0
    expired: int = 0
    quarantined: int = 0
    shed: int = 0
    lane_restarts: int = 0
    per_model: Optional[Dict[str, "ServeStats"]] = None

    @classmethod
    def collect(cls, results: List[ServeResult], wall_s: float, batches: int,
                rebuilds: int, hbm_bytes: int = 0, shed: int = 0,
                lane_restarts: int = 0) -> "ServeStats":
        # throughput and latency over the served (OK) results only
        ok = [r for r in results if r.status is ServeStatus.OK]
        lat = np.array([r.latency_s for r in ok]) if ok else np.zeros(1)
        by = {s: sum(1 for r in results if r.status is s) for s in ServeStatus}
        return cls(
            requests=len(results), batches=batches, wall_s=wall_s,
            samples_per_sec=len(ok) / wall_s if wall_s > 0 else float("inf"),
            p50_latency_s=float(np.percentile(lat, 50)),
            p99_latency_s=float(np.percentile(lat, 99)),
            mean_batch=(len(ok) / batches) if batches else 0.0,
            rebuilds=rebuilds, hbm_bytes_streamed=hbm_bytes,
            rejected=by[ServeStatus.REJECTED], expired=by[ServeStatus.EXPIRED],
            quarantined=by[ServeStatus.FAULT], shed=shed,
            lane_restarts=lane_restarts,
        )


def _record_done(device: torch.device) -> Optional[torch.cuda.Event]:
    """A CUDA event behind the launches enqueued so far (None on the CPU,
    where a launch has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


@dataclasses.dataclass
class _PendingTile:
    """A launched, not yet harvested whole-sample tile."""

    acc_y: torch.Tensor       # (b_pad, n_out), possibly still in flight
    labels: np.ndarray
    tile: BatchTile
    b_live: int
    lane: "_ModelLane"
    done: Optional[torch.cuda.Event] = None

    def ready(self) -> bool:
        return self.done is None or self.done.query()


@dataclasses.dataclass
class _PendingStreamTile:
    """A launched, not yet harvested streaming tick-tile."""

    acc_y: torch.Tensor
    lanes: List[Tuple[_Session, int, int]]   # (session, ticks, events) at launch
    t_launch: float
    num_ticks: int
    lane: "_ModelLane"
    done: Optional[torch.cuda.Event] = None

    def ready(self) -> bool:
        return self.done is None or self.done.query()


@dataclasses.dataclass
class StreamStats:
    """Streaming throughput/latency accounting (one pump window)."""

    sessions: int
    tiles: int
    events: int
    ticks: int
    wall_s: float
    events_per_sec: float         # over wall_s - admission_wait_s
    ticks_per_sec: float
    p50_tile_latency_s: float     # launch → harvest per tick-tile
    p99_tile_latency_s: float
    mean_lanes: float
    evictions: int
    readmissions: int
    rebuilds: int
    hbm_bytes_streamed: int = 0
    rejected: int = 0             # feeds refused by the guard
    expired: int = 0              # sessions dropped at pack time (deadline)
    shed: int = 0                 # requests evicted by admission="shed"
    quarantined: int = 0          # sessions and requests FAULTed
    lane_restarts: int = 0        # backend rebuilds after launch faults
    saturation_storms: int = 0    # quantized rows off the 12-bit grid
    # Caller time blocked on a full bounded ready-queue (the engine pumps
    # inline to make room): excluded from the throughputs above.
    admission_wait_s: float = 0.0
    per_model: Optional[Dict[str, "StreamStats"]] = None


class _ModelLane:
    """Per-model serving state: scheduler, packer, session pool, counters."""

    def __init__(self, engine: "BatchedEngine", spec: ModelSpec):
        self.spec = spec
        cfg = spec.cfg
        if spec.backend.num_devices > 1:
            engine._refuse_per_rank_options(spec.model_id)
        self.max_batch = engine._max_batch or batching.max_batch_for(
            cfg, num_devices=spec.backend.num_devices)
        self.scheduler = BucketingScheduler(
            self.max_batch, engine.tick_granularity, clock=engine._clock,
            rid_alloc=engine._alloc_rid, max_pending=engine._max_pending,
            admission=engine._admission,
        )
        capacity = max(engine._max_sessions or batching.max_sessions_for(cfg),
                       self.max_batch)
        self.pool = SessionPool(spec.backend, capacity,
                                idle_timeout=engine._idle_timeout,
                                clock=engine._clock)
        self.packer = StreamPacker(self.max_batch, tick_tile=engine._tick_tile,
                                   tick_granularity=engine.tick_granularity,
                                   max_pending=engine._max_pending_sessions)
        self.guard: Optional[GuardConfig] = (
            engine._guard.for_model(cfg.n_in) if engine._guard is not None else None
        )
        self.zero_states: Dict[int, Dict[str, torch.Tensor]] = {}
        self.tile_lat: List[float] = []
        # REJECTED / EXPIRED results dropped outside a serve() window,
        # drained by BatchedEngine.take_dead_results()
        self.dead: List[ServeResult] = []
        self.reset_counters()

    @property
    def model_id(self) -> str:
        return self.spec.model_id

    @property
    def cfg(self) -> RSNNConfig:
        return self.spec.cfg

    @property
    def backend(self) -> ExecutionBackend:
        return self.spec.backend

    @property
    def weights(self) -> Dict[str, torch.Tensor]:
        """The live SRAM image, read per launch (a hot-swap applies to the
        very next tile)."""
        return self.spec.weights

    def reset_counters(self) -> None:
        self.tile_lat.clear()
        self.bytes_streamed = 0
        self.tiles = 0
        self.events = 0
        self.ticks = 0
        self.lanes = 0
        self.rejected = 0
        self.expired = 0
        self.shed = 0
        self.quarantined = 0
        self.lane_restarts = 0
        self.saturation_storms = 0
        self.admission_wait_s = 0.0

    def zero_state(self, b_pad: int) -> Dict[str, torch.Tensor]:
        """Cached zero carries per tile width (read-only kernel inputs)."""
        st = self.zero_states.get(b_pad)
        if st is None:
            st = self.zero_states[b_pad] = self.backend.init_session_state(b_pad)
        return st

    def account_tile_bytes(self, num_ticks: int, b_pad: int, fn) -> None:
        """One launch's bytes, per rank of a data mesh: each rank moves its
        own ``ceil(b_pad / ranks)`` rows and its own copy of the weights."""
        c = self.cfg
        ndev = self.backend.num_devices
        self.bytes_streamed += ndev * fn(num_ticks, -(-b_pad // ndev), c.n_in,
                                         c.n_hid, c.n_out)

    def to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        dev = self.backend.device
        return [torch.from_numpy(a).to(dev) for a in arrays]


class SessionHandle:
    """The public face of one open stream (from ``engine.open_session()``)."""

    def __init__(self, engine: "BatchedEngine", sess: _Session):
        self._engine = engine
        self._sess = sess

    @property
    def sid(self) -> int:
        return self._sess.sid

    @property
    def model_id(self) -> str:
        return self._sess.model_id

    @property
    def closed(self) -> bool:
        return self._sess.closed

    @property
    def status(self) -> ServeStatus:
        """OK while the stream is healthy; FAULT once quarantined, EXPIRED
        once its deadline dropped it (both terminal)."""
        return self._sess.status

    def feed(self, events: np.ndarray) -> int:
        """Append one AER word buffer; returns spike events admitted.  Raises
        a :class:`~repro_torch.serve.guard.GuardError` subclass for a
        malformed, over-quota or out-of-order buffer, or a closed session
        (session untouched).  A full bounded ready-queue is drained inline
        first."""
        return self._engine._feed(self._sess, events)

    def poll(self) -> Optional[SessionSnapshot]:
        """Latest harvested snapshot, non-blocking."""
        self._engine._harvest_stream(block=False)
        return self._sess.snapshot

    def result(self) -> SessionSnapshot:
        """Close the stream, process every fed tick, return the final
        classification (synchronises)."""
        return self._engine._finish_session(self._sess)

    def close(self) -> None:
        """Abandon the stream and free its pool slot."""
        self._engine._abandon_session(self._sess)


class BatchedEngine:
    """Batched AER classification service over one or many models.

    ``cfg``/``params`` register one model under ``model_id`` (or pass a
    ``registry``).  ``device`` (default ``"cuda"``) or an existing
    :class:`~repro_torch.core.backend.ExecutionBackend` as ``backend``
    decides where tiles run; ``runtime=RuntimeConfig(mesh=...)`` serves
    over a data mesh (every rank runs the same engine on the same requests
    in the same order, and each tile's rows are split over the ranks, so
    every rank must pack the same tiles: a lane over a mesh refuses the
    options whose decisions read one rank's clock or faults —
    :data:`PER_RANK_OPTIONS` and a per-call ``deadline_s`` — and raises
    every launch fault instead of restarting on one rank).  ``max_batch``
    is the admission size per tile (default
    :func:`repro_torch.serve.batching.max_batch_for`, times the ranks);
    ``max_sessions`` the resident-session capacity per model;
    ``idle_timeout`` offloads idle sessions; ``tick_tile`` fixes the
    streaming tile length (else each tile drains what its sessions have
    pending); ``guard`` is a :class:`GuardConfig`, ``None`` (default
    policy) or ``False`` (no validation).

    Hardening (the JAX engine's error model): ``max_pending`` bounds each
    lane's whole-sample queue, full under ``admission="reject"`` (submit
    raises :class:`~repro_torch.serve.guard.OverloadError`) or ``"shed"``
    (the oldest queued request becomes a REJECTED result);
    ``default_deadline_s`` / ``session_deadline_s`` stamp relative
    deadlines checked at pack time (EXPIRED); ``max_pending_sessions``
    bounds each lane's streaming ready-queue (a feed that overflows it
    pumps inline, counted as admission wait); ``max_tile_retries`` is the
    launch-fault budget before the work is FAULTed; ``fault_hook(model_id,
    kind)`` (``kind`` is ``"tile"`` or ``"stream"``) runs at the top of
    every launch, before any state changes, and an exception it raises is
    handled as a launch fault.
    """

    def __init__(
        self,
        cfg: Optional[RSNNConfig] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        registry: Optional[ModelRegistry] = None,
        model_id: str = DEFAULT_MODEL,
        device: Union[str, torch.device, None] = "cuda",
        backend: Optional[BackendLike] = None,
        max_batch: Optional[int] = None,
        tick_granularity: int = 32,
        max_inflight_tiles: int = 8,
        clock: Callable[[], float] = time.monotonic,
        max_sessions: Optional[int] = None,
        idle_timeout: Optional[float] = None,
        tick_tile: Optional[int] = None,
        runtime: Optional[RuntimeConfig] = None,
        guard: Union[GuardConfig, None, bool] = None,
        max_pending: Optional[int] = None,
        admission: str = "reject",
        default_deadline_s: Optional[float] = None,
        max_pending_sessions: Optional[int] = None,
        session_deadline_s: Optional[float] = None,
        max_tile_retries: int = 3,
        fault_hook: Optional[Callable[[str, str], None]] = None,
    ):
        self.tick_granularity = tick_granularity
        self.max_inflight_tiles = max(1, int(max_inflight_tiles))
        self._clock = clock
        self._max_batch = max_batch
        self._max_sessions = max_sessions
        self._idle_timeout = idle_timeout
        self._tick_tile = tick_tile
        if guard is False:
            self._guard: Optional[GuardConfig] = None
        elif guard is None or guard is True:
            self._guard = GuardConfig()
        else:
            self._guard = guard
        self._max_pending = max_pending
        self._admission = admission
        self._default_deadline_s = default_deadline_s
        self._max_pending_sessions = max_pending_sessions
        self._session_deadline_s = session_deadline_s
        self._max_tile_retries = max(0, int(max_tile_retries))
        self._fault_hook = fault_hook
        self._hook_fault: Optional[BaseException] = None
        self._next_rid = 0
        if registry is None:
            if cfg is None or params is None:
                raise ValueError("BatchedEngine needs either (cfg, params) or registry=")
            registry = ModelRegistry()
            registry.register(model_id, cfg, params, backend=backend,
                              runtime=runtime,
                              device=None if backend is not None else device)
        else:
            if cfg is not None or params is not None:
                raise ValueError("pass either (cfg, params) or registry=, not both")
            if len(registry) == 0:
                raise ValueError("registry has no registered models")
        self.registry = registry
        if model_id in registry:
            self.default_model = model_id
        elif model_id == DEFAULT_MODEL:
            self.default_model = registry.ids()[0]
        else:
            registry.get(model_id)   # raises KeyError naming the options
        self._lanes: Dict[str, _ModelLane] = {}
        self._sessions: Dict[int, _Session] = {}
        self._next_sid = 0
        self._stream_pending: List[_PendingStreamTile] = []
        self._lane(self.default_model)

    # --------------------------------------------------------------- routing

    def _alloc_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def _lane(self, model_id: Optional[str] = None) -> _ModelLane:
        mid = self.default_model if model_id is None else model_id
        lane = self._lanes.get(mid)
        if lane is None:
            lane = self._lanes[mid] = _ModelLane(self, self.registry.get(mid))
        return lane

    def model_ids(self) -> Tuple[str, ...]:
        return self.registry.ids()

    @property
    def cfg(self) -> RSNNConfig:
        return self._lane().cfg

    @property
    def engine(self) -> ExecutionBackend:
        return self._lane().backend

    @property
    def device(self) -> torch.device:
        return self._lane().backend.device

    @property
    def max_batch(self) -> int:
        return self._lane().max_batch

    @property
    def scheduler(self) -> BucketingScheduler:
        return self._lane().scheduler

    @property
    def packer(self) -> StreamPacker:
        return self._lane().packer

    @property
    def pool(self) -> SessionPool:
        return self._lane().pool

    @property
    def _weights(self) -> Dict[str, torch.Tensor]:
        return self._lane().weights

    @property
    def quantized(self) -> bool:
        return self._lane().backend.quant is not None

    @classmethod
    def from_learner(cls, learner, **kw) -> "BatchedEngine":
        """Serve an :class:`~repro_torch.core.controller.OnlineLearner`'s
        network through the learner's own execution backend, so
        ``update_weights(learner.weights)`` mid-training swaps the image
        and builds nothing new."""
        kw.setdefault("backend", learner.backend)
        return cls(learner.cfg, learner.inference_params(), **kw)

    def update_weights(self, weights: Dict[str, torch.Tensor],
                       model_id: Optional[str] = None) -> None:
        """Swap in new weights for one model (the SRAM load: snapped onto
        the 8-bit grid in quantized mode)."""
        self.registry.update_weights(
            self.default_model if model_id is None else model_id, weights)

    def _rebuilds(self) -> int:
        uniq = {id(l.backend): l.backend for l in self._lanes.values()}
        return sum(be.rebuilds for be in uniq.values())

    # ------------------------------------------------------ whole-sample tiles

    def _launch_tile(self, lane: _ModelLane, tile: BatchTile) -> _PendingTile:
        """Decode, pad and launch one tile through the ``inference`` op."""
        self._inject_fault(lane, "tile")
        cfg = lane.cfg
        events = [r.events for r in tile.requests]
        raster, valid, labels = batching.decode_events_host(
            events, cfg.n_in, tile.num_ticks, cfg.label_delay)
        b_pad = batching.padded_batch_size(len(events), lane.max_batch)
        raster, valid = batching.pad_batch(raster, valid, b_pad)
        lane.account_tile_bytes(tile.num_ticks, b_pad,
                                traffic.infer_fused_tiled_bytes)
        out = lane.backend.inference(lane.weights, *lane.to_device(raster, valid))
        return _PendingTile(acc_y=out["acc_y"], labels=labels, tile=tile,
                            b_live=len(events), lane=lane,
                            done=_record_done(lane.backend.device))

    def _launch_session_tile(self, lane: _ModelLane, tile: BatchTile) -> _PendingTile:
        """One whole-sample tile through ``step_sessions`` as a single
        stateless chunk: zero carries in, every request live for the whole
        bucket (``decode_events_host`` semantics), carries out unobserved."""
        self._inject_fault(lane, "tile")
        cfg = lane.cfg
        T = tile.num_ticks
        bufs = [req.events for req in tile.requests]
        b_pad = batching.padded_batch_size(len(bufs), lane.max_batch)
        raster, valid, labels = batching.decode_events_host(
            bufs, cfg.n_in, T, cfg.label_delay)
        raster, valid = batching.pad_batch(raster, valid, b_pad)
        live = np.zeros((T, b_pad), np.float32)
        live[:, : len(bufs)] = 1.0
        out = lane.backend.step_sessions(
            lane.weights, *lane.to_device(raster, live, valid),
            lane.zero_state(b_pad))
        lane.account_tile_bytes(T, b_pad, traffic.stream_step_tiled_bytes)
        lane.tiles += 1
        lane.lanes += len(bufs)
        lane.ticks += T * len(bufs)
        return _PendingTile(acc_y=out["acc_y"], labels=labels, tile=tile,
                            b_live=len(bufs), lane=lane,
                            done=_record_done(lane.backend.device))

    def _finalize(self, pending: _PendingTile) -> List[ServeResult]:
        """Materialise one launched tile's results (synchronises on it).
        The health check reads the tile's one host copy: a row with a
        non-finite value (or, quantized, off the 12-bit grid) becomes a
        FAULT result and its tile-mates are delivered unchanged."""
        lane = pending.lane
        acc_y = host_copy(pending.acc_y)[: pending.b_live]
        t_done = self._clock()
        bad, sat = bad_rows(acc_y, quant=lane.backend.quant,
                            ticks=pending.tile.num_ticks)
        lane.saturation_storms += int(sat.sum())
        lane.quarantined += int(bad.sum())
        zeros = np.zeros((lane.cfg.n_out,), np.float32)
        return [
            ServeResult(
                rid=req.rid, pred=-1 if bad[i] else int(np.argmax(acc_y[i])),
                logits=zeros if bad[i] else acc_y[i],
                label=int(pending.labels[i]), latency_s=t_done - req.t_submit,
                bucket_ticks=pending.tile.num_ticks, batch_size=pending.b_live,
                model_id=lane.model_id,
                status=ServeStatus.FAULT if bad[i] else ServeStatus.OK,
            )
            for i, req in enumerate(pending.tile.requests)
        ]

    def run_tile(self, tile: BatchTile,
                 model_id: Optional[str] = None) -> List[ServeResult]:
        """Decode, pad and classify one tile through the ``inference`` op."""
        return self._finalize(self._launch_tile(self._lane(model_id), tile))

    def _validate_for(self, lane: _ModelLane, events) -> np.ndarray:
        if lane.guard is None:
            return np.asarray(events)
        return validate_events(events, lane.guard,
                               what=f"model {lane.model_id!r} buffer")

    def submit(self, events: np.ndarray, meta: Optional[dict] = None,
               model_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit one AER sample (after the lane's guard); returns its
        engine-unique request id.  A full bounded queue raises
        :class:`~repro_torch.serve.guard.OverloadError` under
        ``admission="reject"`` or sheds the oldest queued request under
        ``"shed"`` (a REJECTED result from :meth:`take_dead_results`).
        ``deadline_s`` is relative (default ``default_deadline_s``)."""
        lane = self._lane(model_id)
        events = self._validate_for(lane, events)
        rid = lane.scheduler.submit(
            events, meta, deadline=self._deadline(lane, deadline_s, self._default_deadline_s))
        self._collect_dropped(lane)
        return rid

    # ------------------------------------------------------- error model

    def _refuse_per_rank_options(self, model_id: str) -> None:
        """Over a data mesh every rank must launch the same tiles with the
        same rows (the backend's SPMD contract): refuse the options whose
        decisions each rank would take alone, on its own clock (deadlines,
        idle offload) or its own faults (the fault hook)."""
        set_ = [name for name in PER_RANK_OPTIONS
                if getattr(self, f"_{name}") is not None]
        if set_:
            raise ValueError(
                f"model {model_id!r} runs on a data mesh: {', '.join(set_)} would let "
                "each rank pack different tiles and split the ranks' collectives")

    def _deadline(self, lane: _ModelLane, deadline_s: Optional[float],
                  default_s: Optional[float]) -> Optional[float]:
        """The absolute deadline of a call's relative ``deadline_s`` (else
        ``default_s``); refused on a data mesh, where it would read each
        rank's own clock."""
        if deadline_s is not None and lane.backend.num_devices > 1:
            raise ValueError(f"model {lane.model_id!r} runs on a data mesh: a deadline "
                             "reads each rank's own clock")
        rel = deadline_s if deadline_s is not None else default_s
        return None if rel is None else self._clock() + rel

    def _dead_result(self, lane: _ModelLane, req: ServeRequest,
                     status: ServeStatus) -> ServeResult:
        """The typed tombstone of one dropped request."""
        return ServeResult(
            rid=req.rid, pred=-1,
            logits=np.zeros((lane.cfg.n_out,), np.float32), label=0,
            latency_s=self._clock() - req.t_submit, bucket_ticks=req.bucket,
            batch_size=0, model_id=lane.model_id, status=status,
        )

    def _collect_dropped(self, lane: _ModelLane) -> None:
        """Turn the lane's shed and deadline-expired requests into dead
        results (REJECTED / EXPIRED), before tiles are packed."""
        for req in lane.scheduler.shed:
            lane.shed += 1
            lane.rejected += 1
            lane.dead.append(self._dead_result(lane, req, ServeStatus.REJECTED))
        lane.scheduler.shed.clear()
        for req in lane.scheduler.take_expired():
            lane.expired += 1
            lane.dead.append(self._dead_result(lane, req, ServeStatus.EXPIRED))

    def take_dead_results(self, model_id: Optional[str] = None
                          ) -> List[ServeResult]:
        """Drain the dropped-work results of one model (or every lane):
        the ``submit`` / ``run_tile`` caller's view of the error model
        (``serve()`` drains them into its results itself)."""
        lanes = ([self._lane(model_id)] if model_id is not None
                 else list(self._lanes.values()))
        out: List[ServeResult] = []
        for lane in lanes:
            self._collect_dropped(lane)
            out.extend(lane.dead)
            lane.dead.clear()
        return out

    # -------------------------------------------------- lane supervision

    def _inject_fault(self, lane: _ModelLane, kind: str) -> None:
        if self._fault_hook is not None:
            try:
                self._fault_hook(lane.model_id, kind)
            except Exception as exc:
                self._hook_fault = exc
                raise

    def _recoverable(self, lane: _ModelLane, exc: BaseException) -> bool:
        """A launch fault a lane restart can contain: one the fault hook
        raised, or a launcher error that leaves the CUDA context usable.
        Never on a data mesh: the fault is one rank's, and a restart there
        alone would split the ranks' collectives."""
        hook_fault, self._hook_fault = self._hook_fault, None
        if lane.backend.num_devices > 1:
            return False
        if isinstance(exc, KernelLaunchError):
            return not exc.sticky
        return exc is hook_fault

    def _restart_lane(self, lane: _ModelLane) -> None:
        """Restart a lane after a recoverable launch fault: harvest every
        launched tile, offload each resident session to a bit-exact host
        copy, swap the lane's backend for a fresh one on the same device
        (:meth:`ModelRegistry.rebuild_backend`) and give the lane a new
        pool; sessions re-seat from their copies on their next tile.  A
        recoverable fault launched nothing, so every row is readable here,
        and the closing synchronisation raises if the context is gone."""
        self._harvest_stream(block=True)
        for sess in list(lane.pool._resident.values()):
            lane.pool.evict(sess)
        old_pool = lane.pool
        lane.spec = self.registry.rebuild_backend(lane.model_id)
        lane.pool = SessionPool(lane.backend, old_pool.capacity,
                                idle_timeout=old_pool.idle_timeout,
                                clock=self._clock)
        lane.pool.evictions = old_pool.evictions
        lane.pool.readmissions = old_pool.readmissions
        lane.zero_states.clear()
        lane.lane_restarts += 1
        if lane.backend.device.type == "cuda":
            torch.cuda.synchronize(lane.backend.device)

    def _drop_session(self, lane: _ModelLane, sess: _Session,
                      status: ServeStatus) -> None:
        """Close one session with a terminal dead snapshot."""
        sess.status = status
        sess.closed = True
        sess.snapshot = SessionSnapshot(
            sid=sess.sid, pred=-1,
            logits=np.zeros((lane.cfg.n_out,), np.float32),
            label=sess.label, ticks=sess.cursor, events=sess.n_events,
            final=True, status=status,
        )
        lane.pool.release(sess)

    def _quarantine(self, lane: _ModelLane, sess: _Session) -> None:
        """FAULT one session whose state is not trustworthy; the rest of
        its tile and lane keep serving."""
        if sess.status is ServeStatus.FAULT:
            return
        self._drop_session(lane, sess, ServeStatus.FAULT)
        lane.quarantined += 1

    def _expire_session(self, lane: _ModelLane, sess: _Session) -> None:
        """EXPIRED drop at pack time: the deadline passed before launch."""
        self._drop_session(lane, sess, ServeStatus.EXPIRED)
        lane.expired += 1

    def serve(
        self,
        stream: Iterable[Union[np.ndarray, Tuple[np.ndarray, str]]],
        flush: bool = True,
        model_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> Tuple[List[ServeResult], ServeStats]:
        """Run a stream of AER sample buffers (or ``(events, model_id)``
        pairs); results in admission (rid) order plus stats.

        Tiles launch as soon as a bucket fills and are harvested as their
        device work completes; the one mandatory synchronisation is the
        end-of-stream drain.  No item aborts the stream: a buffer the guard
        or a full queue refuses, a shed or expired request and a tile whose
        launch-fault budget ran out each surface as a non-OK result, and
        the neighbours serve unaffected.  ``deadline_s`` stamps each item's
        relative deadline (default ``default_deadline_s``).
        """
        t0 = self._clock()
        bytes0 = {mid: l.bytes_streamed for mid, l in self._lanes.items()}
        restarts0 = {mid: l.lane_restarts for mid, l in self._lanes.items()}
        shed0 = {mid: l.shed for mid, l in self._lanes.items()}
        results: List[ServeResult] = []
        pending: List[_PendingTile] = []
        batches_by: Dict[str, int] = {}
        touched: Dict[str, _ModelLane] = {}

        def launch(lane: _ModelLane, tile: BatchTile) -> None:
            """Launch within the fault budget: a recoverable fault restarts
            the lane and retries; an exhausted budget FAULTs the tile."""
            for _ in range(self._max_tile_retries + 1):
                try:
                    pending.append(self._launch_session_tile(lane, tile))
                except Exception as exc:
                    if not self._recoverable(lane, exc):
                        raise
                    self._restart_lane(lane)
                    continue
                batches_by[lane.model_id] = batches_by.get(lane.model_id, 0) + 1
                return
            lane.quarantined += len(tile.requests)
            results.extend(self._dead_result(lane, req, ServeStatus.FAULT)
                           for req in tile.requests)

        def harvest(block: bool) -> None:
            while pending and (block or pending[0].ready()):
                results.extend(self._finalize(pending.pop(0)))

        def reap(lane: _ModelLane) -> None:
            self._collect_dropped(lane)
            results.extend(lane.dead)
            lane.dead.clear()

        for item in stream:
            events, mid = item if isinstance(item, tuple) else (item, model_id)
            lane = self._lane(mid)
            touched[lane.model_id] = lane
            try:
                lane.scheduler.submit(self._validate_for(lane, events), deadline=self._deadline(
                    lane, deadline_s, self._default_deadline_s))
            except (GuardError, OverloadError):
                lane.rejected += 1
                results.append(self._dead_result(lane, ServeRequest(
                    rid=self._alloc_rid(), events=np.zeros(0, np.uint32),
                    native_ticks=0, bucket=0, t_submit=self._clock()),
                    ServeStatus.REJECTED))
            reap(lane)
            for tile in lane.scheduler.ready_tiles():
                launch(lane, tile)
            harvest(block=False)
            while len(pending) > self.max_inflight_tiles:
                results.extend(self._finalize(pending.pop(0)))
        if flush:
            for lane in touched.values():
                reap(lane)
                for tile in lane.scheduler.drain():
                    launch(lane, tile)
        harvest(block=True)
        wall = self._clock() - t0
        results.sort(key=lambda r: r.rid)

        def lane_bytes(lane: _ModelLane) -> int:
            return lane.bytes_streamed - bytes0.get(lane.model_id, 0)

        def lane_restarts(lane: _ModelLane) -> int:
            return lane.lane_restarts - restarts0.get(lane.model_id, 0)

        def lane_shed(lane: _ModelLane) -> int:
            return lane.shed - shed0.get(lane.model_id, 0)

        stats = ServeStats.collect(
            results, wall, sum(batches_by.values()), self._rebuilds(),
            hbm_bytes=sum(lane_bytes(l) for l in self._lanes.values()),
            shed=sum(lane_shed(l) for l in touched.values()),
            lane_restarts=sum(lane_restarts(l) for l in touched.values()),
        )
        if len(touched) > 1:
            stats.per_model = {
                mid: ServeStats.collect(
                    [r for r in results if r.model_id == mid], wall,
                    batches_by.get(mid, 0), lane.backend.rebuilds,
                    hbm_bytes=lane_bytes(lane), shed=lane_shed(lane),
                    lane_restarts=lane_restarts(lane),
                )
                for mid, lane in touched.items()
            }
        return results, stats

    # ---------------------------------------------------- session streaming

    def open_session(self, meta: Optional[dict] = None,
                     model_id: Optional[str] = None,
                     deadline_s: Optional[float] = None) -> SessionHandle:
        """Open one AER event stream with persistent recurrent state; feed
        it in any increments — chunking never changes the result.  A
        session whose ``deadline_s`` (relative; default
        ``session_deadline_s``) passes before its pending ticks are packed
        is dropped with a terminal EXPIRED snapshot."""
        lane = self._lane(model_id)
        sess = _Session(self._next_sid, self._clock(), meta,
                        model_id=lane.model_id)
        sess.gate_label = lane.cfg.eprop.infer_window == "valid"
        sess.deadline = self._deadline(lane, deadline_s, self._session_deadline_s)
        self._next_sid += 1
        self._sessions[sess.sid] = sess
        return SessionHandle(self, sess)

    def _feed(self, sess: _Session, events: np.ndarray) -> int:
        lane = self._lanes[sess.model_id]
        if lane.guard is not None:
            try:
                events = validate_events(
                    events, lane.guard, min_tick=max(sess.max_fed_tick, 0),
                    what=f"session {sess.sid} feed")
                backlog = len(sess.sp_tick) - sess.sp_ptr
                incoming = int(np.count_nonzero(events >> 24 == 0x03))
                if backlog + incoming > lane.guard.max_pending_events:
                    raise QuotaExceededError(
                        f"session {sess.sid}: {backlog} buffered + {incoming} "
                        f"incoming spikes exceeds max_pending_events="
                        f"{lane.guard.max_pending_events}")
            except GuardError:
                lane.rejected += 1
                raise
        n = sess.feed(events)
        if sess.processable() > 0:
            t0 = self._clock()
            stalled = False
            while not lane.packer.enqueue(sess):
                # a full bounded ready-queue: launch a tile inline to make
                # room (admission wait, not device time)
                stalled = True
                if not self._pump_lane_once(lane):
                    break
            if stalled:
                lane.admission_wait_s += self._clock() - t0
        return n

    def _launch_chunks(self, lane: _ModelLane, sessions, chunks, num_ticks):
        """Seat sessions in the pool, decode their chunks into one tick-tile,
        gather carries → ``step_sessions`` → scatter carries."""
        self._inject_fault(lane, "stream")
        cfg = lane.cfg
        b_pad = batching.padded_batch_size(len(sessions), lane.max_batch)
        raster, live, valid = batching.decode_session_chunks(
            chunks, cfg.n_in, num_ticks, cfg.label_delay, b_pad=b_pad)
        slots, admit = lane.pool.place(sessions)
        if admit is not None:
            lane.pool.admit(admit)
        idx = lane.pool.padded_slots(slots, b_pad)
        state = lane.pool.gather(idx)
        out = lane.backend.step_sessions(
            lane.weights, *lane.to_device(raster, live, valid), state)
        lane.pool.scatter(idx, out)
        lane.account_tile_bytes(num_ticks, b_pad, traffic.stream_step_tiled_bytes)
        lane.tiles += 1
        lane.lanes += len(sessions)
        lane.ticks += sum(c.n_live for c in chunks)
        lane.events += sum(len(c.sp_tick) for c in chunks)
        return out

    def _pump_lane_once(self, lane: _ModelLane) -> bool:
        """Pack and launch one tick-tile from one lane; False when none of
        its sessions has processable ticks.  Sessions past their deadline
        are dropped here, before the launch; a recoverable launch fault
        rewinds the chunks and restarts the lane."""
        nxt = lane.packer.next_tile()
        if nxt is None:
            return False
        sessions, num_ticks = nxt
        now = self._clock()
        live = []
        for s in sessions:
            if s.deadline is not None and now > s.deadline:
                self._expire_session(lane, s)
            else:
                live.append(s)
        if not live:
            return True   # dropped work is progress
        sessions = live
        chunks = [s.take_chunk(num_ticks) for s in sessions]
        try:
            out = self._launch_chunks(lane, sessions, chunks, num_ticks)
        except Exception as exc:
            if not self._recoverable(lane, exc):
                raise
            self._on_stream_launch_fault(lane, sessions, chunks)
            return True
        self._stream_pending.append(_PendingStreamTile(
            acc_y=out["acc_y"],
            lanes=[(s, s.cursor, s.n_events) for s in sessions],
            t_launch=self._clock(), num_ticks=num_ticks, lane=lane,
            done=_record_done(lane.backend.device),
        ))
        for s in sessions:
            if s.processable() > 0:
                lane.packer.enqueue(s)
        self._harvest_stream(block=False)
        while len(self._stream_pending) > self.max_inflight_tiles:
            self._harvest_one()
        return True

    def _on_stream_launch_fault(self, lane: _ModelLane, sessions, chunks) -> None:
        """Contain one failed streaming launch: rewind every chunk
        (bit-exact: the pool was never scattered into), restart the lane,
        re-queue the sessions within their retry budget and quarantine the
        rest."""
        for s, ref in zip(sessions, chunks):
            s.restore_chunk(ref)
            s.retries += 1
        survivors = [s for s in sessions if s.retries <= self._max_tile_retries]
        for s in sessions:
            if s.retries > self._max_tile_retries:
                self._quarantine(lane, s)
        self._restart_lane(lane)
        for s in survivors:
            if s.processable() > 0:
                lane.packer.enqueue(s)

    def _pump_once(self) -> bool:
        """Launch at most one tick-tile per lane (fair share across models)."""
        launched = False
        for lane in list(self._lanes.values()):
            launched |= self._pump_lane_once(lane)
        return launched

    def pump(self, drain: bool = False) -> int:
        """Advance every open session through its pending ticks; ``drain``
        also blocks until every launched tile is harvested.  Returns the
        number of rounds that launched work."""
        n = 0
        while self._pump_once():
            n += 1
        for lane in self._lanes.values():
            lane.pool.sweep()
        if drain:
            self._harvest_stream(block=True)
        return n

    def _harvest_one(self) -> None:
        """Harvest the oldest streaming tile: one host copy (it synchronises
        on this tile), the health check on that copy, then the snapshots.
        A bad row quarantines its session; its tile-mates' rows are
        independent carries and are delivered unchanged."""
        p = self._stream_pending.pop(0)
        lane = p.lane
        acc = host_copy(p.acc_y)
        lane.tile_lat.append(self._clock() - p.t_launch)
        n = len(p.lanes)
        bad, sat = bad_rows(acc[:n], quant=lane.backend.quant,
                            ticks=np.array([t for _, t, _ in p.lanes], np.int64))
        lane.saturation_storms += int(sat.sum())
        for i, (sess, ticks, events) in enumerate(p.lanes):
            if sess.status is not ServeStatus.OK:
                continue   # terminal snapshot already written
            if bad[i]:
                self._quarantine(lane, sess)
                continue
            sess.retries = 0
            sess.snapshot = SessionSnapshot(
                sid=sess.sid, pred=int(np.argmax(acc[i])), logits=acc[i],
                label=sess.label, ticks=ticks, events=events)

    def _harvest_stream(self, block: bool) -> None:
        while self._stream_pending and (block or self._stream_pending[0].ready()):
            self._harvest_one()

    def _session_acc(self, sess: _Session) -> np.ndarray:
        """A session's accumulated readout wherever it lives (the pool
        reflects every launched tile, in stream order)."""
        lane = self._lanes[sess.model_id]
        if sess.slot is not None:
            return host_copy(lane.pool.state["acc_y"][sess.slot])
        if sess.offloaded is not None:
            return np.asarray(sess.offloaded["acc_y"], np.float32)
        return np.zeros((lane.cfg.n_out,), np.float32)

    def _finish_session(self, sess: _Session) -> SessionSnapshot:
        lane = self._lanes[sess.model_id]
        if sess.status is not ServeStatus.OK:
            # dropped mid-stream: hand over the terminal snapshot
            self._sessions.pop(sess.sid, None)
            return sess.snapshot
        sess.closed = True   # extends the horizon to the last fed tick
        if sess.processable() > 0:
            while not lane.packer.enqueue(sess):
                if not self._pump_lane_once(lane):
                    break
        while (sess.status is ServeStatus.OK and sess.processable() > 0
               and self._pump_once()):
            pass
        self._harvest_stream(block=True)
        if sess.status is not ServeStatus.OK:
            self._sessions.pop(sess.sid, None)
            return sess.snapshot
        acc = self._session_acc(sess)
        snap = SessionSnapshot(
            sid=sess.sid, pred=int(np.argmax(acc)), logits=acc,
            label=sess.label, ticks=sess.cursor, events=sess.n_events,
            final=True)
        sess.snapshot = snap
        lane.pool.release(sess)
        self._sessions.pop(sess.sid, None)
        return snap

    def _abandon_session(self, sess: _Session) -> None:
        sess.closed = True
        self._lanes[sess.model_id].pool.release(sess)
        self._sessions.pop(sess.sid, None)

    def reset_stream_stats(self) -> None:
        for lane in self._lanes.values():
            lane.reset_counters()

    def _lane_stream_stats(self, lane: _ModelLane, wall_s: float) -> StreamStats:
        lat = np.array(lane.tile_lat) if lane.tile_lat else np.zeros(1)
        busy = max(wall_s - lane.admission_wait_s, 1e-9)
        return StreamStats(
            sessions=sum(1 for s in self._sessions.values()
                         if s.model_id == lane.model_id),
            tiles=lane.tiles, events=lane.events, ticks=lane.ticks,
            wall_s=wall_s, events_per_sec=lane.events / busy,
            ticks_per_sec=lane.ticks / busy,
            p50_tile_latency_s=float(np.percentile(lat, 50)),
            p99_tile_latency_s=float(np.percentile(lat, 99)),
            mean_lanes=(lane.lanes / lane.tiles) if lane.tiles else 0.0,
            evictions=lane.pool.evictions, readmissions=lane.pool.readmissions,
            rebuilds=lane.backend.rebuilds,
            hbm_bytes_streamed=lane.bytes_streamed, rejected=lane.rejected,
            expired=lane.expired, shed=lane.shed, quarantined=lane.quarantined,
            lane_restarts=lane.lane_restarts,
            saturation_storms=lane.saturation_storms,
            admission_wait_s=lane.admission_wait_s,
        )

    def stream_stats(self, wall_s: float,
                     model_id: Optional[str] = None) -> StreamStats:
        """Streaming counters since :meth:`reset_stream_stats`, over the
        caller-measured wall window (one lane, or all with ``per_model``)."""
        if model_id is not None:
            return self._lane_stream_stats(self._lane(model_id), wall_s)
        lanes = list(self._lanes.values())
        per = {l.model_id: self._lane_stream_stats(l, wall_s) for l in lanes}
        lat = [t for l in lanes for t in l.tile_lat]
        arr = np.array(lat) if lat else np.zeros(1)
        tiles = sum(l.tiles for l in lanes)
        wait = sum(l.admission_wait_s for l in lanes)
        busy = max(wall_s - wait, 1e-9)
        return StreamStats(
            sessions=len(self._sessions), tiles=tiles,
            events=sum(l.events for l in lanes),
            ticks=sum(l.ticks for l in lanes), wall_s=wall_s,
            events_per_sec=sum(l.events for l in lanes) / busy,
            ticks_per_sec=sum(l.ticks for l in lanes) / busy,
            p50_tile_latency_s=float(np.percentile(arr, 50)),
            p99_tile_latency_s=float(np.percentile(arr, 99)),
            mean_lanes=(sum(l.lanes for l in lanes) / tiles) if tiles else 0.0,
            evictions=sum(l.pool.evictions for l in lanes),
            readmissions=sum(l.pool.readmissions for l in lanes),
            rebuilds=self._rebuilds(),
            hbm_bytes_streamed=sum(l.bytes_streamed for l in lanes),
            rejected=sum(l.rejected for l in lanes),
            expired=sum(l.expired for l in lanes),
            shed=sum(l.shed for l in lanes),
            quarantined=sum(l.quarantined for l in lanes),
            lane_restarts=sum(l.lane_restarts for l in lanes),
            saturation_storms=sum(l.saturation_storms for l in lanes),
            admission_wait_s=wait,
            per_model=per if len(lanes) > 1 else None,
        )

    def warmup(self, num_ticks: int, batch: Optional[int] = None,
               model_id: Optional[str] = None) -> None:
        """Run one tile of each op at a serving shape (builds the kernels on
        first use; synchronises)."""
        lane = self._lane(model_id)
        b = batching.padded_batch_size(batch or lane.max_batch, lane.max_batch)
        t = batching.bucket_ticks(num_ticks, self.tick_granularity)
        be = lane.backend
        raster = torch.zeros((t, b, lane.cfg.n_in), device=be.device)
        valid = torch.ones((t, b), device=be.device)
        be.inference(lane.weights, raster, valid)["acc_y"].cpu()
        be.step_sessions(lane.weights, raster, valid, valid,
                         be.init_session_state(b))["acc_y"].cpu()
