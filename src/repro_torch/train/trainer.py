"""Fault-tolerant training loop (counterpart of :mod:`repro.train.trainer`).

* **checkpoint/restart**: atomic async checkpoints every ``ckpt_every``
  steps (params, optimizer state, data position), keep-N retention;
  :meth:`Trainer.restore` resumes from the newest complete checkpoint and
  puts every leaf back on the device its template leaf lives on;
* **non-finite step rejection**: a NaN or inf loss or grad-norm drops the
  step's new state (it is committed only after the check) and skips the
  batch; more than ``max_bad_steps`` consecutive rejections abort;
* **straggler watchdog**: a per-step wall-clock EWMA flags outliers
  (:class:`repro_torch.train.metrics.StragglerWatchdog`);
* **SIGTERM safety**: a preemption signal sets a flag; the loop finishes
  the step, writes a final checkpoint and returns.

A step's wall time is taken after ``float(metrics["loss"])``: that call is
what waits for the card.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.distributed.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    ReplayCursor,
    place_like,
)
from repro_torch.train.metrics import MetricsLogger, StragglerWatchdog


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    ckpt_every: int = 100
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    log_every: int = 10
    max_bad_steps: int = 10          # consecutive NaN/inf rejections allowed
    watchdog_k: float = 4.0
    log_file: Optional[str] = None


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                      # (params, opt, batch) -> (params, opt, metrics)
        params: Any,
        opt_state: Any,
        data_iter: Iterator[Dict],
        cfg: TrainerConfig,
        checkpoint: Optional[CheckpointPolicy] = None,
        cursor: Optional[ReplayCursor] = None,
    ):
        """``checkpoint`` (a :class:`CheckpointPolicy`) overrides
        ``cfg.ckpt_dir``/``keep_ckpts``/``ckpt_every`` and selects async or
        blocking cadence saves.  ``cursor`` is a :class:`ReplayCursor`
        shared with the data iterator
        (:func:`repro_torch.train.eprop_step.epoch_batches`): its position
        rides in every manifest and :meth:`restore` brings it back."""
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data_iter
        self.cfg = cfg
        self.step = 0
        self.policy = checkpoint
        if checkpoint is not None:
            self.ckpt = checkpoint.manager()
            self.ckpt_every = max(1, int(checkpoint.every))
            self._async = bool(checkpoint.async_save)
        else:
            self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            self.ckpt_every = cfg.ckpt_every
            self._async = True
        self.cursor = cursor
        self.metrics = MetricsLogger(cfg.log_file)
        self.watchdog = StragglerWatchdog(k=cfg.watchdog_k)
        self.bad_steps = 0
        self.rejected_steps = 0
        self.straggler_flags = 0
        self._stop = False
        self._old_handlers = {}

    # ------------------------------------------------------------- signals
    def install_signal_handlers(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(sig, self._on_term)

    def restore_signal_handlers(self):
        for sig, h in self._old_handlers.items():
            signal.signal(sig, h)
        self._old_handlers = {}

    def _on_term(self, signum, frame):
        self._stop = True   # finish the current step, checkpoint, return

    # ------------------------------------------------------------- ckpt
    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def save(self, blocking: bool = False):
        extra = {"data_step": self.step}
        if self.cursor is not None:
            extra["cursor"] = self.cursor.as_manifest()
        if blocking:
            self.ckpt.save(self.step, self._state(), extra)
        else:
            self.ckpt.save_async(self.step, self._state(), extra)

    def restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = self._state()
        host, manifest = self.ckpt.restore(latest, state)
        placed = place_like(state, host)
        self.params, self.opt_state = placed["params"], placed["opt_state"]
        self.step = manifest["step"]
        if self.cursor is not None and "cursor" in manifest:
            restored = ReplayCursor.from_manifest(manifest["cursor"])
            self.cursor.epoch, self.cursor.batch = restored.epoch, restored.batch
        return True

    # ------------------------------------------------------------- loop
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        while self.step < cfg.total_steps and not self._stop:
            batch = next(self.data)
            t0 = time.time()
            new_params, new_opt, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics.get("grad_norm", 0.0))
            wall = time.time() - t0

            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                # reject: drop the would-be update, keep the old state
                self.bad_steps += 1
                self.rejected_steps += 1
                del new_params, new_opt
                if self.bad_steps > cfg.max_bad_steps:
                    self.save(blocking=True)
                    raise RuntimeError(
                        f"{self.bad_steps} consecutive non-finite steps at {self.step}")
                continue

            self.bad_steps = 0
            self.params, self.opt_state = new_params, new_opt
            self.step += 1

            if self.watchdog.observe(self.step, wall):
                self.straggler_flags += 1
                self.metrics.log(self.step, wall, {"straggler": 1.0, **metrics})
            if self.step % cfg.log_every == 0:
                self.metrics.log(self.step, wall, metrics)
            if self.step % self.ckpt_every == 0:
                self.save(blocking=not self._async)

        self.ckpt.wait()
        self.save(blocking=True)
        return {
            "step": self.step,
            "rejected_steps": self.rejected_steps,
            "straggler_flags": self.straggler_flags,
            "stopped_by_signal": self._stop,
        }
