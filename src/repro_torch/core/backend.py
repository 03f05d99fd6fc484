"""Execution backend (counterpart of :mod:`repro.core.backend`,
single-device ops).

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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import eprop
from repro_torch.core.quant import QuantizedMode
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.rsnn_step import forward_plan, max_batch_for_dims, serve_plan

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


class ExecutionBackend:
    """Serving ops for one :class:`RSNNConfig` on one device.

    ``device`` defaults to ``"cuda"`` (raises without a card); ``quant``
    overlays a fixed-point mode on a float config (defaults to
    ``cfg.neuron.quant``); ``alpha`` defaults to the config's and is pinned
    to ``alpha_reg / 256`` in quantized mode.
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
        self.runtime = RuntimeConfig(device=str(self.device), alpha=self.alpha,
                                     quant=self.quant)
        H = cfg.n_hid
        if cfg.eprop.mask_self_recurrence:
            self._mask = 1.0 - torch.eye(H, dtype=torch.float32, device=self.device)
        else:
            self._mask = torch.ones((H, H), dtype=torch.float32, device=self.device)
        self.rebuilds = 0
        self._dp_key: Optional[Tuple] = None
        self._dp: Optional[Tuple[torch.Tensor, ...]] = None
        self._dp_src: Tuple = ()

    @property
    def num_devices(self) -> int:
        """Devices the backend runs on (one: the port has no mesh yet);
        a learner records it in its checkpoint manifests."""
        return 1

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

    def inference(self, weights: Dict[str, torch.Tensor], raster, valid
                  ) -> Dict[str, torch.Tensor]:
        """Classify one ``(T, B)`` tile → ``{"acc_y", "pred", "spike_rate"}``."""
        raster, valid = self._as_input(raster), self._as_input(valid)
        w_in, w_rec, w_out = self.datapath_weights(weights)
        acc_y, n_spk = ops.rsnn_infer(raster, valid, w_in, w_rec, w_out,
                                      **self._kw())
        return {
            "acc_y": acc_y,
            "pred": torch.argmax(acc_y, dim=-1),
            "spike_rate": eprop._spike_rate(n_spk, valid, self.cfg.n_hid),
        }

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
        w_in, w_rec, w_out = self.datapath_weights(weights)
        out = ops.rsnn_step_sessions(raster, live, valid, *carries, w_in, w_rec,
                                     w_out, **self._kw())
        return dict(zip(STATE_KEYS, out))

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
        as ``w -= lr * dw``) summed over the batch, ``dw["w_rec"]``
        self-recurrence masked; ``metrics`` ``{"acc_y", "pred",
        "spike_rate"}``."""
        raster, y_star, valid = (self._as_input(x) for x in (raster, y_star, valid))
        w_in, w_rec, w_out = self.datapath_weights(weights)
        ecfg = self.cfg.eprop
        dw_in, dw_rec, dw_out, acc_y, n_spk = ops.rsnn_train(
            raster, y_star, valid, w_in, w_rec, w_out, self._feedback(weights),
            error=ecfg.error, target_amplitude=ecfg.target_amplitude,
            infer_window=ecfg.infer_window, **self._trace_kw())
        dw = {"w_in": dw_in, "w_rec": dw_rec * self._mask, "w_out": dw_out}
        return dw, {
            "acc_y": acc_y,
            "pred": torch.argmax(acc_y, dim=-1),
            "spike_rate": eprop._spike_rate(n_spk, valid, self.cfg.n_hid),
        }

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
    share one backend.  ``rt.model_id`` is excluded."""
    quant = rt.quant if rt.quant is not None else cfg.neuron.quant
    if quant is not None:
        alpha = quant.alpha
    else:
        alpha = float(cfg.neuron.alpha if rt.alpha is None else rt.alpha)
    return (cfg, str(resolve_device(rt.device)), alpha, quant)


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
