"""Execution backend (counterpart of :mod:`repro.core.backend`).

One :class:`ExecutionBackend` per network config owns the device, the
datapath constants and the weights as the kernels consume them.  Its ops:

* :meth:`ExecutionBackend.inference` — classify a padded/masked
  ``(T, B)`` tile (``rsnn_infer``);
* :meth:`ExecutionBackend.step_sessions` — advance ``B`` resident
  sessions through one tick-tile, carries in and out
  (``rsnn_step_sessions``);
* :meth:`ExecutionBackend.train_tile` — fused forward + e-prop update of
  one training tile, ``dw`` summed over the batch: what an END_S (B=1) or
  END_B (B=K) commit applies (``rsnn_train``);
* :meth:`ExecutionBackend.forward_traces` / :meth:`~ExecutionBackend.
  eprop_update` — the split pipeline, traces through device memory
  (``rsnn_forward``, ``eprop_update``);
* :meth:`ExecutionBackend.dynamics` — the full state trajectories, the
  bit-true probe (``rsnn_forward``).

The device decides the path: a backend on ``"cuda"`` launches the
hand-written kernels, a backend on ``"cpu"`` runs their plain PyTorch
versions (:mod:`repro_torch.kernels.ops`).  The default is ``"cuda"``,
and constructing a backend there without a card raises — nothing drops
to the CPU unless the caller asks for it.

Weights are arguments to every op.  The backend derives the datapath
weights (snapped onto the membrane grid in quantized mode, self-recurrence
masked) once per weight image and counts each derivation in
:attr:`ExecutionBackend.rebuilds`; launching a new tile shape rebuilds
nothing (PyTorch runs eagerly and the kernels take any shape).

**Data parallelism** (``RuntimeConfig(mesh=...)``, a ``("data",)``
:class:`~torch.distributed.device_mesh.DeviceMesh` from
:func:`repro_torch.launch.mesh.make_data_mesh`).  The SPMD contract of the
reference's global arrays: every rank of the mesh calls an op with the
same global, replicated inputs; the backend pads the sample axis to a
multiple of the rank count (zero rows, inert), each rank runs the kernel
on its own slice, and every rank gets the same global outputs back —
``train_tile`` sums the three ``dw`` over the ranks (``all_reduce``),
per-sample outputs and session carries are gathered (``all_gather``), and
the spike rate sums the ranks' integer spike and valid counts, so it is
bitwise the unsharded rate.  So the learner, the engine and the pipelines
run unchanged on every rank.  A one-rank mesh runs unsharded, as in the
reference.  A rank's collectives run on its device: NCCL on the card,
gloo on the CPU; a mesh of another device type than the backend's raises.

**The control group.**  A backend over a mesh also holds the mesh's
:class:`ControlGroup`: a gloo group of the same ranks, on the host even
when the data group is NCCL, formed once per mesh when the first backend
over it is built (a lane restart's fresh backend reuses it).  It carries
the serving engine's decisions (:mod:`repro_torch.serve.engine`: rank 0's
deadlines and idle offload, every rank's fault hook) and each serving
launch's outcome: :meth:`inference` and :meth:`step_sessions` exchange
whether each rank's kernel launched before their ``all_gather``, so a
rank whose launch failed never leaves the others waiting in a collective
(:class:`RankFaultError` on the others; a one-rank mesh exchanges with
itself).

**The integer commit grid** (``RuntimeConfig(commit_grid=DW_COMMIT_SPEC)``):
``train_tile`` sums each sample's ``dw`` as int32 codes on the grid
(``rsnn_train(..., commit_grid=)``: ``rsnn_dw_codes_reduce_kernel`` on the
card), ``all_reduce``-s the codes across ranks and converts to float
once, so an END_B commit is bitwise the same on 1, 4 or 8 ranks — what the
elastic 8 -> 4 restart relies on.
"""

from __future__ import annotations

import dataclasses
import datetime
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import eprop
from repro_torch.core.quant import QuantizedMode, QuantSpec
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.launch import KernelLaunchError, cdiv
from repro_torch.kernels.rsnn_step import forward_plan, max_batch_for_dims, serve_plan
from repro_torch.launch.mesh import DATA_AXIS, world_timeout_s

STATE_KEYS = ("v", "z", "y", "acc_y", "n_spk")
MAX_TICKS = 4096   # the AER bus's 12-bit tick counter


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime knobs, resolved in one place (:func:`as_backend`).  ``None``
    means unset: defaults come from the config (``alpha``, ``quant``) or
    the module (``device="cuda"``)."""

    device: Optional[str] = None
    alpha: Optional[float] = None
    quant: Optional[QuantizedMode] = None
    # Data parallelism: a ("data",) DeviceMesh of the current world (see
    # the module docstring); the sample axis is sharded over it.
    mesh: object = None
    # Deterministic END_B: sum each sample's dw as int32 codes on this grid
    # (core.quant.DW_COMMIT_SPEC), so a commit does not depend on how the
    # sample axis is split.  None keeps the float sum: bitwise on a fixed
    # mesh, to float tolerance across mesh sizes.
    commit_grid: Optional[QuantSpec] = None
    # Which registered model a request acts for — identity only, never part
    # of the execution bucket.
    model_id: Optional[str] = None


def _merge_runtime(runtime: Optional[RuntimeConfig], **loose) -> RuntimeConfig:
    """An explicit config wins wherever it sets a field; loose kwargs fill
    the fields it left unset."""
    rt = runtime or RuntimeConfig()
    fill = {k: v for k, v in loose.items()
            if v is not None and getattr(rt, k) is None}
    return dataclasses.replace(rt, **fill) if fill else rt


def _same_mesh(a, b) -> bool:
    return a is b or (a is not None and b is not None and a == b)


# A rank's outcome in a control exchange, ordered by severity: nothing to
# report, a fault a lane restart contains (the fault hook's, a launcher
# error that leaves the CUDA context usable), and any other error.
LAUNCHED, RESTART, RAISE = 0, 1, 2


class RankFaultError(RuntimeError):
    """Another rank of the data mesh faulted at this launch.  Every rank
    but the faulted one raises this; the faulted one raises its own error.
    ``rank`` is the faulted rank (its world rank); ``sticky`` is true when
    no lane restart can contain its fault, so every rank raises to the
    caller."""

    def __init__(self, rank: int, sticky: bool):
        what = "a fault no lane restart contains" if sticky else "a recoverable launch fault"
        super().__init__(f"rank {rank} of the data mesh had {what}")
        self.rank = int(rank)
        self.sticky = bool(sticky)


class ControlGroup:
    """The host-side group that carries a data mesh's decisions: a gloo
    group over the mesh's ranks, usable when a rank's CUDA context is not.

    One :meth:`exchange` carries every rank's outcome code and rank 0's
    ids (an ``all_reduce`` of the codes and the id count, then a
    ``broadcast`` of the ids when there are any).  Every rank must make
    the same exchanges in the same order: each sits on a path all ranks
    take.  ``exchanges`` counts them."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks: List[int] = [int(r) for r in ranks]
        self.group = dist.new_group(
            ranks=self.ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=world_timeout_s()))
        self.rank = dist.get_rank(self.group)
        self.exchanges = 0

    def exchange(self, code: int = LAUNCHED, ids: Sequence[int] = ()
                 ) -> Tuple[List[int], List[int]]:
        """Every rank's ``code`` (in group rank order) and group rank 0's
        ``ids`` (the other ranks' ``ids`` are not read)."""
        n = len(self.ranks)
        head = torch.zeros(n + 1, dtype=torch.int64)
        head[self.rank] = int(code)
        if self.rank == 0:
            head[n] = len(ids)
        dist.all_reduce(head, group=self.group)
        count = int(head[n])
        out = [int(i) for i in ids] if self.rank == 0 else []
        if count:
            buf = (torch.tensor(out, dtype=torch.int64) if self.rank == 0
                   else torch.empty(count, dtype=torch.int64))
            dist.broadcast(buf, src=self.ranks[0], group=self.group)
            out = buf.tolist()
        self.exchanges += 1
        return head[:n].tolist(), out

    def decide(self, ids: Sequence[int], among: Sequence[int]) -> List[int]:
        """Rank 0's decision: its ``ids``, which every rank must hold
        among its own candidates ``among`` (else the ranks' states have
        parted and no decision can apply)."""
        _, out = self.exchange(LAUNCHED, ids)
        missing = set(out) - set(among)
        if missing:
            raise RuntimeError(
                f"rank {self.ranks[self.rank]} holds no {sorted(missing)} that rank "
                f"{self.ranks[0]} decided on: the ranks' serving states have parted")
        return out

    def settle(self, exc: Optional[BaseException] = None,
               recoverable: bool = False) -> None:
        """The launch-outcome exchange: report this rank's outcome (``exc``,
        or none) and raise the agreed one.  A rank raises its own error
        when it is the worst fault of the launch, else :class:`RankFaultError`
        naming the first rank with the worst; nothing when no rank faulted.
        ``recoverable`` marks ``exc`` as one a lane restart contains (the
        fault hook's); a :class:`~repro_torch.kernels.launch.
        KernelLaunchError` is recoverable when its code is not sticky."""
        if exc is None:
            code = LAUNCHED
        elif recoverable or (isinstance(exc, KernelLaunchError) and not exc.sticky):
            code = RESTART
        else:
            code = RAISE
        codes, _ = self.exchange(code)
        worst = max(codes)
        if worst == LAUNCHED:
            return
        if exc is not None and code == worst:
            raise exc
        raise RankFaultError(self.ranks[codes.index(worst)], sticky=worst == RAISE) from exc


# one control group per data group (so per mesh), formed by the first
# backend over the mesh; the data group lives as long as its world
_CONTROL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _control_group(mesh, group) -> ControlGroup:
    ctl = _CONTROL.get(group)
    if ctl is None:
        ctl = _CONTROL[group] = ControlGroup(mesh.mesh.flatten().tolist())
    return ctl


class ExecutionBackend:
    """The ops for one :class:`RSNNConfig` on one device, or on one rank of
    a data mesh.

    ``device`` defaults to ``"cuda"`` (raises without a card); ``quant``
    overlays a fixed-point mode on a float config (defaults to
    ``cfg.neuron.quant``); ``alpha`` defaults to the config's and is pinned
    to ``alpha_reg / 256`` in quantized mode; ``runtime`` may carry a
    ``mesh`` and a ``commit_grid`` (module docstring).
    """

    def __init__(
        self,
        cfg: RSNNConfig,
        device: Union[str, torch.device, None] = "cuda",
        alpha: Optional[float] = None,
        quant: Optional[QuantizedMode] = None,
        runtime: Optional[RuntimeConfig] = None,
    ):
        rt = _merge_runtime(runtime, device=None if device is None else str(device),
                            alpha=alpha, quant=quant)
        self.cfg = cfg
        self.device = resolve_device(rt.device)
        self.quant = rt.quant if rt.quant is not None else cfg.neuron.quant
        self._ncfg = (cfg.neuron if self.quant == cfg.neuron.quant
                      else dataclasses.replace(cfg.neuron, quant=self.quant))
        self.alpha = float(cfg.neuron.alpha if rt.alpha is None else rt.alpha)
        if self.quant is not None:
            if rt.alpha is not None and abs(float(rt.alpha) - self.quant.alpha) >= 1e-9:
                raise ValueError(
                    "quantized mode: alpha is driven by alpha_reg "
                    f"({self.quant.alpha}), caller passed {rt.alpha}"
                )
            self.alpha = self.quant.alpha
        self.mesh, self.commit_grid = rt.mesh, rt.commit_grid
        # the data axis's process group (also on a one-rank mesh, which the
        # public ops run unsharded)
        self._group = self._data_group() if self.mesh is not None else None
        # the mesh's decisions and launch outcomes (module docstring)
        self.control: Optional[ControlGroup] = (
            _control_group(self.mesh, self._group) if self.mesh is not None else None)
        # ranks the sample axis is sharded over; a learner records it in
        # its checkpoint manifests
        self.num_devices = self.mesh.size() if self.mesh is not None else 1
        self._sharded = self.num_devices > 1
        self.runtime = RuntimeConfig(device=str(self.device), alpha=self.alpha,
                                     quant=self.quant, mesh=self.mesh,
                                     commit_grid=self.commit_grid)
        H = cfg.n_hid
        if cfg.eprop.mask_self_recurrence:
            self._mask = 1.0 - torch.eye(H, dtype=torch.float32, device=self.device)
        else:
            self._mask = torch.ones((H, H), dtype=torch.float32, device=self.device)
        self._mask_codes = self._mask.to(torch.int32)
        self.rebuilds = 0
        self._dp_key: Optional[Tuple] = None
        self._dp: Optional[Tuple[torch.Tensor, ...]] = None
        self._dp_src: Tuple = ()

    def _data_group(self):
        """The process group of the mesh's ``"data"`` axis, which the sample
        axis is sharded over."""
        mesh = self.mesh
        if tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS,):
            raise ValueError(
                f"the RSNN backend shards over a one-axis ({DATA_AXIS!r},) mesh, got "
                f"axes {mesh.mesh_dim_names} (the LM's (data, model) meshes are for its "
                "train steps, launch/mesh.py:make_debug_mesh)")
        if mesh.device_type != self.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh cannot carry a backend on {self.device}: "
                "the collectives run on the backend's device (NCCL on the card, "
                "gloo on the CPU)")
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
        return mesh.get_group(DATA_AXIS)

    # -------------------------------------------------------- compatibility

    def check_compatible(self, rt: RuntimeConfig) -> None:
        """Raise when a caller's requested knobs conflict with this shared
        backend (``None`` fields mean "don't care")."""
        def need(ok: bool, msg: str) -> None:
            if not ok:
                raise ValueError(msg)

        need(rt.device is None or resolve_device(rt.device) == self.device,
             f"shared backend runs on {self.device}, caller asked for {rt.device}")
        need(rt.alpha is None or self.alpha == float(rt.alpha) or (
            self.quant is not None and abs(self.quant.alpha - float(rt.alpha)) < 1e-9),
             "shared backend uses a different alpha than the caller's params")
        need(rt.quant is None or self.quant == rt.quant,
             "shared backend runs a different quantized mode than the caller's")
        need(rt.mesh is None or _same_mesh(self.mesh, rt.mesh),
             "shared backend was built over a different mesh than the caller's")
        need(rt.commit_grid is None or self.commit_grid == rt.commit_grid,
             "shared backend accumulates END_B on a different commit grid "
             f"({self.commit_grid}) than the caller's ({rt.commit_grid})")

    def resize(self, mesh) -> "ExecutionBackend":
        """This backend rebuilt over another (or no) data mesh, everything
        else the same: the elastic-restore primitive
        (:func:`repro_torch.distributed.elastic.survive_data_failure`).
        With a ``commit_grid`` the resized backend's END_B commits are
        bitwise the original's; without one they agree to the float sum's
        order.  Returns ``self`` when the mesh is unchanged."""
        if _same_mesh(mesh, self.mesh):
            return self
        return ExecutionBackend(self.cfg, device=None,
                                runtime=dataclasses.replace(self.runtime, mesh=mesh))

    # ------------------------------------------------------------- plumbing

    def tile_rows(self, op: str = "inference", T: Optional[int] = None,
                  B: Optional[int] = None) -> int:
        """Batch rows per kernel block for ``op``.  The serving ops
        (``"inference"``, ``"step_sessions"``) run one row a warp, as many
        a block as :func:`~repro_torch.kernels.rsnn_step.serve_plan` gives
        a launch of ``B`` rows (default: the serving admission); the
        trace-streaming ops (``"forward_traces"``, ``"dynamics"``) the rows
        a block, a loop warp each, that
        :func:`~repro_torch.kernels.rsnn_step.forward_plan` gives such a
        launch.  ``"train"`` takes the launch's tick count as the TPU
        sizing does; its kernel, like ``"eprop_update"``'s, runs one row a
        block, at any ``T`` up to the 12-bit tick counter."""
        c = self.cfg
        if op == "train" and not (T is not None and 0 < T <= MAX_TICKS):
            raise ValueError(f"train tile rows need 0 < T <= {MAX_TICKS}, got {T}")
        if op in ("train", "eprop_update"):
            return 1
        if op not in ("inference", "step_sessions", "forward_traces", "dynamics"):
            raise ValueError(f"unknown op {op!r}")
        b = max_batch_for_dims(c.n_in, c.n_hid, c.n_out) if B is None else B
        plan = serve_plan if op in ("inference", "step_sessions") else forward_plan
        return plan(T or 1, b, c.n_in, c.n_hid, c.n_out).rows

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()

    def datapath_weights(self, weights: Dict[str, torch.Tensor]):
        """``(w_in, w_rec, w_out)`` as the kernels consume them, derived once
        per weight image: membrane-grid integers in quantized mode,
        self-recurrence masked, contiguous f32 on this device."""
        src = tuple(weights[k] for k in ("w_in", "w_rec", "w_out"))
        key = tuple((id(t), getattr(t, "_version", 0)) for t in src)
        if key != self._dp_key:
            w_in, w_rec, w_out = (self._as_input(t) for t in src)
            q = self.quant
            if q is not None:
                w_in, w_rec, w_out = (q.to_membrane(w_in), q.to_membrane(w_rec),
                                      q.to_membrane(w_out))
            self._dp = (w_in.contiguous(), (w_rec * self._mask).contiguous(),
                        w_out.contiguous())
            self._dp_key, self._dp_src = key, src   # src pins the ids
            self.rebuilds += 1
        return self._dp

    def _kw(self):
        ncfg = self._ncfg
        return dict(alpha=self.alpha, kappa=ncfg.kappa, v_th=ncfg.v_th,
                    reset=ncfg.reset, quant=self.quant,
                    infer_window=self.cfg.eprop.infer_window)

    # ------------------------------------------------------------------ ops

    @staticmethod
    def _metrics(acc_y: torch.Tensor, spike_rate: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"acc_y": acc_y, "pred": torch.argmax(acc_y, dim=-1),
                "spike_rate": spike_rate}

    # ------------------------------------------------- data-parallel helpers

    def _shards(self) -> Tuple[int, int]:
        """(ranks of the data axis, this rank's index on it)."""
        return dist.get_world_size(self._group), dist.get_rank(self._group)

    def _pad_to_shards(self, arrs, batch_axis):
        """This rank's slice of each array's sample axis (axis
        ``batch_axis[i]`` of ``arrs[i]``), the axis zero-padded up to a
        multiple of the rank count first: padding rows carry zero input and
        zero ``valid``, so they add nothing.  Returns the slices and the
        global ``B``."""
        n, r = self._shards()
        B = arrs[0].shape[batch_axis[0]]
        per = cdiv(B, n)
        out = []
        for x, ax in zip(arrs, batch_axis):
            if per * n != B:
                pad = list(x.shape)
                pad[ax] = per * n - B
                x = torch.cat([x, x.new_zeros(pad)], dim=ax)
            out.append(x.narrow(ax, r * per, per).contiguous())
        return out, B

    def _all_gather_rows(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """The ranks' ``(B / n, ...)`` row blocks, in rank order, cut to the
        global ``B`` rows."""
        n, _ = self._shards()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group)
        return torch.cat(parts)[:B]

    def _all_reduce(self, parts):
        """Each tensor of ``parts`` summed over the ranks, in one
        ``all_reduce`` of them side by side."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self._group)
        return [t.view_as(p) for t, p in zip(flat.split([p.numel() for p in parts]), parts)]

    def _psum_spike_rate(self, n_spk: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The global valid-weighted spike rate from the shards: the ranks'
        spike and valid counts summed, then divided once.  The counts are
        integers (exact in f32), so this is bitwise the unsharded rate
        (:func:`repro_torch.core.eprop._spike_rate`); the reference sums
        each shard's rate weighted by its valid count instead."""
        spikes, n_valid = self._all_reduce([n_spk.sum(), valid.sum()])
        return spikes / (torch.clamp(n_valid, min=1.0) * self.cfg.n_hid)

    def _launched(self, launch):
        """``launch()``, then, over a mesh, the launch-outcome exchange
        (:meth:`ControlGroup.settle`): before any collective of the op, so a
        rank whose launch raised tells the others instead of leaving them
        in the ``all_gather``."""
        if self.control is None:
            return launch()
        try:
            out = launch()
        except Exception as exc:
            self.control.settle(exc)
            raise
        self.control.settle()
        return out

    def _inference(self, weights, raster, valid, sharded: bool):
        """:meth:`inference`'s launch; ``sharded``: each rank classifies its
        slice of the sample axis and ``acc_y`` is gathered."""
        if sharded:
            (raster, valid), B = self._pad_to_shards((raster, valid), (1, 1))
        acc_y, n_spk = self._launched(lambda: ops.rsnn_infer(
            raster, valid, *self.datapath_weights(weights), **self._kw()))
        if not sharded:
            return self._metrics(acc_y, eprop._spike_rate(n_spk, valid, self.cfg.n_hid))
        return self._metrics(self._all_gather_rows(acc_y, B),
                             self._psum_spike_rate(n_spk, valid))

    def inference(self, weights: Dict[str, torch.Tensor], raster, valid
                  ) -> Dict[str, torch.Tensor]:
        """Classify one ``(T, B)`` tile → ``{"acc_y", "pred", "spike_rate"}``."""
        raster, valid = self._as_input(raster), self._as_input(valid)
        return self._inference(weights, raster, valid, self._sharded)

    def init_session_state(self, n: int) -> Dict[str, torch.Tensor]:
        """Zero carry rows for ``n`` sessions (exact on the quantized grid)."""
        c = self.cfg
        shapes = {"v": c.n_hid, "z": c.n_hid, "y": c.n_out, "acc_y": c.n_out,
                  "n_spk": 1}
        return {k: torch.zeros((n, w), dtype=torch.float32, device=self.device)
                for k, w in shapes.items()}

    def step_sessions(self, weights: Dict[str, torch.Tensor], raster, live,
                      valid, state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Advance ``B`` sessions through one ``(T, B)`` tick-tile; ``state``
        and the result are ``{"v", "z", "y", "acc_y", "n_spk"}`` rows.
        ``live == 0`` freezes a session exactly; ``valid`` (⊆ live) gates
        the readout accumulation."""
        raster, live, valid = (self._as_input(x) for x in (raster, live, valid))
        carries = [self._as_input(state[k]) for k in STATE_KEYS]
        return self._step_sessions(weights, raster, live, valid, carries, self._sharded)

    def _step_sessions(self, weights, raster, live, valid, carries, sharded: bool):
        """:meth:`step_sessions`'s launch; ``sharded``: each rank advances
        its slice of the session rows and the carries out are gathered (one
        ``all_gather`` of the five side by side), so the engine's pool
        scatters global rows.  The reference needs no collective here:
        ``shard_map`` reassembles its global array."""
        if sharded:
            (raster, live, valid, *carries), B = self._pad_to_shards(
                (raster, live, valid, *carries), (1, 1, 1) + (0,) * len(STATE_KEYS))
        out = self._launched(lambda: ops.rsnn_step_sessions(
            raster, live, valid, *carries, *self.datapath_weights(weights), **self._kw()))
        if not sharded:
            return dict(zip(STATE_KEYS, out))
        widths = [x.shape[1] for x in out]
        rows = self._all_gather_rows(torch.cat(out, dim=1), B)
        return dict(zip(STATE_KEYS, (t.contiguous() for t in rows.split(widths, dim=1))))

    # ------------------------------------------------------------- training

    def _feedback(self, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The feedback matrix in normalised weight units: the raw
        ``w_out`` (symmetric) or the fixed random ``b_fb`` — never the
        membrane-grid image."""
        key = "b_fb" if self.cfg.eprop.feedback == "random" else "w_out"
        return self._as_input(weights[key])

    def _y_err(self, y: torch.Tensor) -> torch.Tensor:
        """Readout values as the error path sees them: ``y / threshold``
        in quantized mode, identity otherwise."""
        if self.quant is None:
            return y
        return y * (1.0 / float(self.quant.threshold))

    def _trace_kw(self):
        ncfg = self._ncfg
        return dict(alpha=self.alpha, kappa=ncfg.kappa, v_th=ncfg.v_th,
                    reset=ncfg.reset, boxcar_width=ncfg.boxcar_width,
                    quant=self.quant)

    def train_tile(self, weights: Dict[str, torch.Tensor], raster, y_star,
                   valid) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One fused forward + e-prop update over a ``(T, B)`` training
        tile → ``(dw, metrics)``: ``dw`` (positive-gradient sums, applied
        as ``w -= lr * dw``) summed over the batch (and over the ranks of a
        mesh; on the commit grid when one is set), ``dw["w_rec"]``
        self-recurrence masked; ``metrics`` ``{"acc_y", "pred",
        "spike_rate"}``."""
        raster, y_star, valid = (self._as_input(x) for x in (raster, y_star, valid))
        return self._train(weights, raster, y_star, valid, self._sharded)

    def _train(self, weights, raster, y_star, valid, sharded: bool):
        """:meth:`train_tile`'s launch.  ``sharded``: each rank trains its
        slice of the sample axis, the three ``dw`` are summed over the
        ranks (one ``all_reduce`` of the three side by side) and ``acc_y``
        is gathered.  With a ``commit_grid`` the launch returns each
        sample's ``dw`` snapped to int32 codes and summed over its rows
        (``rsnn_train(..., commit_grid=)``: the reference's
        ``_dw_to_codes`` over a ``lax.map`` of B=1 tiles); the ranks sum
        the codes (int32: order-free, so 1-, 4- and 8-rank layouts sum the
        same codes), which convert to float once.  Padding rows carry zero
        input and zero ``valid``, so they add nothing."""
        if sharded:
            (raster, y_star, valid), B = self._pad_to_shards((raster, y_star, valid),
                                                             (1, 0, 1))
        ecfg = self.cfg.eprop
        *dw, acc_y, n_spk = ops.rsnn_train(
            raster, y_star, valid, *self.datapath_weights(weights),
            self._feedback(weights), error=ecfg.error,
            target_amplitude=ecfg.target_amplitude, infer_window=ecfg.infer_window,
            commit_grid=self.commit_grid, **self._trace_kw())
        if sharded:
            dw = self._all_reduce(dw)
            metrics = self._metrics(self._all_gather_rows(acc_y, B),
                                    self._psum_spike_rate(n_spk, valid))
        else:
            metrics = self._metrics(acc_y, eprop._spike_rate(n_spk, valid, self.cfg.n_hid))
        dw_in, dw_rec, dw_out = dw
        if self.commit_grid is None:
            return {"w_in": dw_in, "w_rec": dw_rec * self._mask, "w_out": dw_out}, metrics
        # self-recurrence codes zeroed before the conversion (the reference
        # masks each sample's dw before its snap, and a zero snaps to 0)
        lsb = self.commit_grid.lsb
        return {k: c.to(torch.float32) * lsb for k, c in
                (("w_in", dw_in), ("w_rec", dw_rec * self._mask_codes),
                 ("w_out", dw_out))}, metrics

    def forward_traces(self, weights: Dict[str, torch.Tensor], raster, y_star,
                       valid) -> Dict[str, torch.Tensor]:
        """Forward one ``(T, B)`` tile through ``rsnn_forward``, emitting the
        factored-update traces ``{"h", "xbar", "pbar", "zbar", "err",
        "y_inf", "n_spk"}`` (``err`` masked by ``valid``, ``n_spk (T,)``)."""
        raster, y_star, valid = (self._as_input(x) for x in (raster, y_star, valid))
        w_in, w_rec, w_out = self.datapath_weights(weights)
        out = ops.rsnn_forward(raster, w_in, w_rec, w_out, **self._trace_kw())
        vt = valid[..., None]
        err = eprop.readout_error(self._y_err(out["y"]), y_star, self.cfg.eprop) * vt
        w_inf = vt if self.cfg.eprop.infer_window == "valid" else 1.0
        return {
            "h": out["h"], "xbar": out["xbar"], "pbar": out["pbar"],
            "zbar": out["zbar"], "err": err.contiguous(),
            "y_inf": out["y"] * w_inf,
            "n_spk": (out["z"] * vt).sum(dim=(1, 2)),
        }

    def eprop_update(self, weights: Dict[str, torch.Tensor],
                     traces: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Traces → batch-summed positive-gradient ``dw`` (``eprop_update``)."""
        tr = [self._as_input(traces[k]) for k in ("h", "xbar", "pbar", "zbar", "err")]
        dw_in, dw_rec, dw_out = ops.eprop_update(
            *tr, self._feedback(weights), kappa=self._ncfg.kappa)
        return {"w_in": dw_in, "w_rec": dw_rec * self._mask, "w_out": dw_out}

    def dynamics(self, weights: Dict[str, torch.Tensor], raster
                 ) -> Dict[str, torch.Tensor]:
        """Full state trajectories of one ``(T, B)`` tile: post-reset
        membrane ``v`` (T, B, H), spikes ``z``, readout ``y`` (T, B, O) —
        integers on the membrane grid in quantized mode, where they match
        the integer golden reference bit for bit."""
        w_in, w_rec, w_out = self.datapath_weights(weights)
        out = ops.rsnn_forward(self._as_input(raster), w_in, w_rec, w_out,
                               **self._trace_kw())
        return {k: out[k] for k in ("v", "z", "y")}


BackendLike = Union[str, torch.device, ExecutionBackend, RuntimeConfig]


def bucket_key(cfg: RSNNConfig, rt: RuntimeConfig) -> Tuple:
    """The execution bucket of a ``(cfg, runtime)`` request: equal keys can
    share one backend.  The mesh (by value) and the commit grid are part
    of it, so a lane restart rebuilds on the same mesh;
    ``rt.model_id`` is excluded."""
    quant = rt.quant if rt.quant is not None else cfg.neuron.quant
    if quant is not None:
        alpha = quant.alpha
    else:
        alpha = float(cfg.neuron.alpha if rt.alpha is None else rt.alpha)
    return (cfg, str(resolve_device(rt.device)), alpha, quant, rt.mesh,
            rt.commit_grid)


class BackendPool:
    """One backend per execution bucket: registering a second model with an
    equal config builds nothing new."""

    def __init__(self):
        self._by_key: Dict[Tuple, ExecutionBackend] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def backends(self) -> Tuple[ExecutionBackend, ...]:
        return tuple(self._by_key.values())

    def get(self, cfg: RSNNConfig, rt: RuntimeConfig) -> ExecutionBackend:
        key = bucket_key(cfg, rt)
        hit = self._by_key.get(key)
        if hit is not None:
            hit.check_compatible(rt)
            return hit
        be = ExecutionBackend(cfg, device=None,
                              runtime=dataclasses.replace(rt, model_id=None))
        self._by_key[key] = be
        return be

    def adopt(self, backend: ExecutionBackend) -> ExecutionBackend:
        """Seed the pool with an existing backend; an occupied bucket wins."""
        return self._by_key.setdefault(bucket_key(backend.cfg, backend.runtime),
                                       backend)

    def discard(self, backend: ExecutionBackend) -> bool:
        """Drop a pooled backend so the next :meth:`get` for its bucket
        builds a fresh one (the lane-restart primitive).  The bucket keys
        on the device, so the fresh backend runs where the old one did.
        Returns whether the backend was pooled."""
        key = bucket_key(backend.cfg, backend.runtime)
        if self._by_key.get(key) is backend:
            del self._by_key[key]
            return True
        return False


def as_backend(
    cfg: RSNNConfig,
    backend: Optional[BackendLike] = None,
    *,
    device: Union[str, torch.device, None] = None,
    alpha: Optional[float] = None,
    quant: Optional[QuantizedMode] = None,
    runtime: Optional[RuntimeConfig] = None,
    model_id: Optional[str] = None,
    pool: Optional[BackendPool] = None,
) -> ExecutionBackend:
    """Coerce a device, a :class:`RuntimeConfig` or an existing backend into
    a constructed backend (through ``pool`` when given).  An existing
    instance is validated against the caller's knobs and shared as-is."""
    if isinstance(backend, RuntimeConfig):
        if runtime is not None:
            raise ValueError("runtime passed twice")
        backend, runtime = None, backend
    if isinstance(backend, (str, torch.device)):
        backend, device = None, backend if device is None else device
    rt = _merge_runtime(runtime, device=None if device is None else str(device),
                        alpha=alpha, quant=quant, model_id=model_id)
    if isinstance(backend, ExecutionBackend):
        if backend.cfg != cfg:
            raise ValueError(
                "shared backend built for a different config"
                + (f" (model {rt.model_id!r})" if rt.model_id else "")
            )
        backend.check_compatible(rt)
        return pool.adopt(backend) if pool is not None else backend
    if pool is not None:
        return pool.get(cfg, rt)
    return ExecutionBackend(cfg, device=None, runtime=rt)
