"""Execution backend for serving tiles (counterpart of
:mod:`repro.core.backend`, serving ops only).

One :class:`ExecutionBackend` per network config owns the device, the
datapath constants and the weights as the kernels consume them.  Its ops:

* :meth:`ExecutionBackend.inference` — classify a padded/masked
  ``(T, B)`` tile (``rsnn_infer``);
* :meth:`ExecutionBackend.step_sessions` — advance ``B`` resident
  sessions through one tick-tile, carries in and out
  (``rsnn_step_sessions``).

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
from repro_torch.kernels import ops
from repro_torch.kernels.rsnn_step import block_rows, max_tile_rows

STATE_KEYS = ("v", "z", "y", "acc_y", "n_spk")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device a backend runs on: ``None`` means ``"cuda"``.  Raises
    when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs its kernels on the "
                "card; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


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

    def tile_rows(self, B: Optional[int] = None) -> int:
        """Batch rows per kernel block: the most a block holds, or, for a
        launch of ``B`` rows, the rows that spread it over every SM."""
        c = self.cfg
        if B is None:
            return max_tile_rows(c.n_in, c.n_hid, c.n_out)
        return block_rows(B, c.n_in, c.n_hid, c.n_out)

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
