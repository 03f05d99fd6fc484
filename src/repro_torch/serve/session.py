"""Device-resident session state for streaming serving (counterpart of
:mod:`repro.serve.session`).

A :class:`SessionPool` owns ``(S_cap + 1, ·)`` tensors on the backend's
device holding every resident session's carry ``(v, z, y, acc_y, n_spk)``;
row ``S_cap`` is the trash row that padded tile lanes read and write, so
gather and scatter shapes never change with occupancy.  A tile gathers its
rows with ``index_select`` and scatters them back with ``index_copy_``, in
place, on the device's stream — so the pool always reflects every
launched tile without a host synchronisation.  LRU and idle-timeout
eviction offload cold rows to host memory verbatim; in quantized mode the
carries are integers on the 12-bit grid, so evict → readmit → continue is
bit-exact.

Host bookkeeping for one stream lives in :class:`_Session`; its public face
is :class:`repro_torch.serve.engine.SessionHandle`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aer import EVT_END, EVT_LABEL, EVT_SPIKE, MAX_ADDR, MAX_TICK
from repro_torch.core.backend import STATE_KEYS
from repro_torch.serve.guard import ServeStatus, StreamContractError


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that owns its data (``Tensor.cpu()`` of a CPU tensor
    would share memory with the pool row)."""
    return t.detach().to("cpu", copy=True).numpy()


@dataclasses.dataclass
class SessionSnapshot:
    """One incremental (or final) per-session readout observation."""

    sid: int
    pred: int                 # argmax over the accumulated readout so far
    logits: np.ndarray        # acc_y snapshot, shape (n_out,)
    label: int                # max label address seen in the stream so far
    ticks: int                # stream ticks processed when this was taken
    events: int               # spike events consumed when this was taken
    final: bool = False       # True only for SessionHandle.result()
    status: ServeStatus = ServeStatus.OK


class _Session:
    """Host bookkeeping for one open session (internal to the engine)."""

    __slots__ = (
        "sid", "slot", "meta", "sp_tick", "sp_addr", "sp_ptr", "cursor",
        "max_fed_tick", "label", "label_tick", "label_seen", "end_seen",
        "end_tick", "closed", "n_events", "t_open", "t_last", "snapshot",
        "offloaded", "queued", "gate_label", "model_id", "status",
        "deadline", "retries",
    )

    def __init__(self, sid: int, now: float, meta: Optional[dict] = None,
                 model_id: str = "default"):
        self.sid = sid
        self.model_id = model_id
        self.slot: Optional[int] = None    # pool row; None ⇒ offloaded/new
        self.meta = meta
        self.sp_tick = np.zeros(0, np.int64)   # pending spikes, tick-ordered
        self.sp_addr = np.zeros(0, np.int64)
        self.sp_ptr = 0
        self.cursor = 0            # next stream tick to process
        self.max_fed_tick = -1
        self.label = 0             # running max of label addresses
        self.label_tick = 0
        self.label_seen = False
        self.end_seen = False
        self.end_tick = 0
        self.closed = False
        self.n_events = 0
        self.t_open = now
        self.t_last = now
        self.snapshot: Optional[SessionSnapshot] = None
        self.offloaded: Optional[Dict[str, np.ndarray]] = None
        self.queued = False
        self.status = ServeStatus.OK   # FAULT / EXPIRED once dropped (terminal)
        self.deadline: Optional[float] = None  # absolute; None = no deadline
        self.retries = 0           # launch-fault rewinds since the last success
        # With infer_window == "valid" a tick fed before the label word
        # cannot know its valid bit yet: the stream is held back until the
        # label (or END / close) arrives.
        self.gate_label = False

    def feed(self, events: np.ndarray) -> int:
        """Append one AER word buffer (tick-ordered, non-decreasing across
        feeds); returns the spike events admitted."""
        if self.closed:
            raise StreamContractError(
                f"session {self.sid}: feed() on a closed session")
        words = np.asarray(events, np.uint32).ravel()
        kind = words >> 24
        live = kind != 0
        words, kind = words[live], kind[live]
        if words.size == 0:
            return 0
        addr = ((words >> 12) & MAX_ADDR).astype(np.int64)
        tick = (words & MAX_TICK).astype(np.int64)
        sp = kind == EVT_SPIKE
        if sp.any():
            keep = sp & (tick >= self.cursor)
            self.sp_tick = np.concatenate([self.sp_tick[self.sp_ptr:], tick[keep]])
            self.sp_addr = np.concatenate([self.sp_addr[self.sp_ptr:], addr[keep]])
            self.sp_ptr = 0
            self.n_events += int(keep.sum())
        lab = kind == EVT_LABEL
        if lab.any():
            self.label = max(self.label, int(addr[lab].max()))
            self.label_tick = max(self.label_tick, int(tick[lab].max()))
            self.label_seen = True
        end = kind == EVT_END
        if end.any():
            self.end_seen = True
            self.end_tick = max(self.end_tick, int(tick[end].max()))
        self.max_fed_tick = max(self.max_fed_tick, int(tick.max()))
        return int(sp.sum())

    def horizon(self) -> int:
        """First tick not yet processable: END pins the stream length; a
        closed END-less stream runs to the last fed tick; an open stream
        holds back its newest tick (a later feed may add words at it)."""
        if self.end_seen:
            return self.end_tick + 1
        if self.closed:
            return self.max_fed_tick + 1
        if self.gate_label and not self.label_seen:
            return 0
        return max(self.max_fed_tick, 0)

    def processable(self) -> int:
        return max(0, self.horizon() - self.cursor)

    def take_chunk(self, num_ticks: int) -> "SessionChunkRef":
        """Consume up to ``num_ticks`` processable ticks from the cursor."""
        n = min(self.processable(), num_ticks)
        base = self.cursor
        hi = int(np.searchsorted(self.sp_tick[self.sp_ptr:], base + n)) + self.sp_ptr
        ref = SessionChunkRef(
            sp_tick=self.sp_tick[self.sp_ptr:hi],
            sp_addr=self.sp_addr[self.sp_ptr:hi],
            base=base, n_live=n, label_tick=self.label_tick,
            end_tick=self.end_tick if self.end_seen else None,
        )
        self.sp_ptr = hi
        self.cursor = base + n
        return ref

    def restore_chunk(self, ref: "SessionChunkRef") -> None:
        """Undo a :meth:`take_chunk` whose launch failed: re-prepend the
        chunk's spikes and rewind the cursor.  Anything fed after the take
        carries ticks ``>= ref.base + n_live``, so the order holds."""
        self.sp_tick = np.concatenate([ref.sp_tick, self.sp_tick[self.sp_ptr:]])
        self.sp_addr = np.concatenate([ref.sp_addr, self.sp_addr[self.sp_ptr:]])
        self.sp_ptr = 0
        self.cursor = ref.base


@dataclasses.dataclass
class SessionChunkRef:
    """One session's slice of a tick-tile: stream ticks
    ``[base, base + n_live)`` in absolute coordinates."""

    sp_tick: np.ndarray
    sp_addr: np.ndarray
    base: int
    n_live: int
    label_tick: int
    end_tick: Optional[int]


class SessionPool:
    """``S_cap`` device-resident carry rows + LRU / idle admission control.

    :meth:`place` seats a tile's sessions, evicting the least recently
    packed residents when full; :meth:`sweep` offloads residents idle
    longer than ``idle_timeout`` (both read the injected ``clock``).
    """

    def __init__(self, backend, capacity: int,
                 idle_timeout: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"pool capacity must be >= 1, got {capacity}")
        self.backend = backend
        self.device = backend.device
        self.capacity = int(capacity)
        self.trash = self.capacity
        self.idle_timeout = idle_timeout
        self._clock = clock
        self.state = backend.init_session_state(self.capacity + 1)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._resident: "OrderedDict[int, _Session]" = OrderedDict()
        self.evictions = 0
        self.readmissions = 0

    def __len__(self) -> int:
        return len(self._resident)

    def touch(self, sess: _Session) -> None:
        if sess.sid in self._resident:
            self._resident.move_to_end(sess.sid)
        sess.t_last = self._clock()

    def place(self, sessions: List[_Session]
              ) -> Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]:
        """Seat every session → ``(slots, admit_rows)``; ``admit_rows`` are
        the host rows (zeros or offloaded carries) to scatter for newly
        seated sessions, or ``None`` when all were resident."""
        seating = {s.sid for s in sessions}
        admits: List[_Session] = []
        for sess in sessions:
            if sess.slot is None:
                sess.slot = self._alloc(exclude=seating)
                admits.append(sess)
                if sess.offloaded is not None:
                    self.readmissions += 1
                self._resident[sess.sid] = sess
            self.touch(sess)
        slots = np.array([s.slot for s in sessions], np.int64)
        if not admits:
            return slots, None
        zeros = {k: np.zeros(v.shape[1:], np.float32) for k, v in self.state.items()}
        rows = {k: np.stack([(s.offloaded or zeros)[k] for s in admits])
                for k in STATE_KEYS}
        rows["idx"] = np.array([s.slot for s in admits], np.int64)
        for s in admits:
            s.offloaded = None
        return slots, rows

    def _alloc(self, exclude=()) -> int:
        if self._free:
            return self._free.pop()
        for sid, cand in self._resident.items():   # LRU order: oldest first
            if sid not in exclude:
                self.evict(cand)
                return self._free.pop()
        raise RuntimeError(
            f"session pool over capacity ({self.capacity}): every resident "
            "session is in the tile being placed"
        )

    def evict(self, sess: _Session) -> None:
        """Offload one resident row to host memory (verbatim) and free it."""
        if sess.slot is None:
            raise RuntimeError(f"evict() on non-resident session {sess.sid}")
        sess.offloaded = {k: host_copy(v[sess.slot]) for k, v in self.state.items()}
        self._free.append(sess.slot)
        sess.slot = None
        self._resident.pop(sess.sid, None)
        self.evictions += 1

    def release(self, sess: _Session) -> None:
        """Close-path slot return: the session is done."""
        if sess.slot is not None:
            self._free.append(sess.slot)
            sess.slot = None
            self._resident.pop(sess.sid, None)
        sess.offloaded = None

    def sweep(self, now: Optional[float] = None) -> int:
        """Evict residents idle longer than ``idle_timeout``.  Over a data
        mesh (the backend's control group) rank 0's clock and stamps decide
        which, and every rank evicts those."""
        if self.idle_timeout is None:
            return 0
        now = self._clock() if now is None else now
        stale = [s.sid for s in self._resident.values()
                 if now - s.t_last > self.idle_timeout]
        ctl = self.backend.control
        if ctl is not None:
            stale = ctl.decide(stale, list(self._resident))
        for sid in stale:
            self.evict(self._resident[sid])
        return len(stale)

    def padded_slots(self, slots: np.ndarray, b_pad: int) -> torch.Tensor:
        """Slot vector padded to the tile's lane count with the trash row."""
        idx = np.full((b_pad,), self.trash, np.int64)
        idx[: len(slots)] = slots
        return torch.from_numpy(idx).to(self.device)

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Carry rows for one tile's lanes (trash lanes read rows whose
        ``live`` / ``valid`` masks are zero, so nothing propagates)."""
        return {k: v.index_select(0, idx) for k, v in self.state.items()}

    def scatter(self, idx: torch.Tensor, new_state: Dict[str, torch.Tensor]) -> None:
        """Write one tile's final carries back in place.  Duplicate trash
        indices are harmless: nothing reads the trash row as signal."""
        for k, v in self.state.items():
            v.index_copy_(0, idx, new_state[k])

    def admit(self, rows: Dict[str, np.ndarray]) -> None:
        """One scatter seating a tile's newly placed sessions."""
        idx = torch.from_numpy(rows["idx"]).to(self.device)
        self.scatter(idx, {k: torch.from_numpy(rows[k]).to(self.device)
                           for k in STATE_KEYS})

    def state_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.state.values())
