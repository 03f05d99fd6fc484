"""The AER-decoder controller — the paper's FSM as eager PyTorch loops
(counterpart of :mod:`repro.core.controller`).

The FPGA FSM walks IDLE → READM → TICK → SPIKE/LABEL → END_S → (END_B) →
END_E, driving samples through ReckOn and committing e-prop updates as it
goes.  Every forward and update runs through one
:class:`~repro_torch.core.backend.ExecutionBackend`, so on the card every
commit is one ``rsnn_train`` launch and every evaluation one
``rsnn_infer`` launch:

* the READM/TICK/SPIKE scatter is :func:`repro_torch.core.aer.decode_batch`;
* ``commit="sample"`` (END_S, the X-HEEP mode): a loop over the samples of
  a batch, each a ``(T, 1)`` tile whose ``dw`` commits at once — sample
  ``s+1`` sees sample ``s``'s update (:func:`make_train_batch_fn`);
* ``commit="batch"`` (END_B, the ARM mode): the whole batch is one
  ``(T, S)`` tile whose batch-summed ``dw`` commits once
  (:func:`batch_commit_update`); the optimizer is told it stands for ``S``
  samples, so lr decay and clipping keep per-sample semantics.

With a quantized config and a quantized :class:`EpropSGD`
(``configs/reckon_braille.QUANT_OPT``) the walk is chip-faithful: 8-bit
SRAM weights, accumulate-then-round commits, integer membranes.

A learner given a :class:`~repro_torch.serve.registry.ModelRegistry`
registers its model there on its own backend and publishes its weights
after every ``publish_every``-th commit, so an engine routed at that model
serves each new image from its next launched tile: the paper's
learning-while-serving loop.

Random bits (stochastic commits) come from a ``torch.Generator`` on the
learner's device; they cannot match ``jax.random``.

A learner given a :class:`~repro_torch.distributed.checkpoint.
CheckpointPolicy` cuts a durable checkpoint every ``policy.every``-th
commit (the weights, the optimizer state, the generator's state and the
replay cursor) and ``fit(resume=True)`` continues from the newest one,
bitwise equal to a run that was never interrupted.  The generator's state
is the device's own (a 16-byte Philox seed and offset on the card, the
5,056-byte mt19937 state on the CPU), so a learner checkpoint restores
only onto a learner on the same device type.

A learner given ``runtime=RuntimeConfig(mesh=..., commit_grid=...)`` learns
data-parallel: every rank of the mesh builds the same learner from the
same seed (so the weights and the commits' generator start alike on every
rank), feeds it the same global batches, and the backend shards each
batch's samples over the ranks and sums their ``dw``; every rank then
commits the same ``dw`` with the same random bits, so the weights stay
replicated.  Rank 0 of the data axis alone writes checkpoints; every rank
restores them, onto any rank count (the weights are whole host arrays).
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import aer, eprop
from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
from repro_torch.core.rsnn import RSNNConfig, init_params, merge_trainable, trainable
from repro_torch.device import DeviceLike
from repro_torch.distributed.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    ReplayCursor,
    place_like,
)
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Runtime registers of the expanded SPI parameter bank (§3.3) that
    the learner reads; the batch depth and the label delay are the
    pipeline's (:mod:`repro_torch.data.pipeline`)."""

    num_epochs: int = 10
    eval_every: int = 1               # validation cadence
    commit: str = "sample"            # "sample" (END_S) | "batch" (END_B)

    def __post_init__(self):
        if self.commit not in ("sample", "batch"):
            raise ValueError(f"unknown commit mode {self.commit!r}")


# A decoded batch on a device: {"raster": (S, T, N) sample-major rasters,
# "label": (S,) int64, "valid": (S, T)}.  Training and evaluation transpose
# to the tick-major (T, B, N) layout the backend consumes.
DeviceBatch = dict


def decode_events_to_batch(words: torch.Tensor, n_in: int, num_ticks: int,
                           label_delay: int = 0) -> DeviceBatch:
    """AER buffer ``(S, L)`` words → dense training batch on the words'
    device (the READM + TICK path)."""
    s = aer.decode_batch(words, n_in, num_ticks)
    valid = aer.supervision_mask(s.label_tick, s.end_tick, num_ticks, label_delay)
    return DeviceBatch(raster=s.raster, label=s.label, valid=valid)


def _one_hot(labels: torch.Tensor, n_out: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels, n_out).to(torch.float32)


def make_train_batch_fn(cfg: RSNNConfig, opt: EpropSGD, backend: ExecutionBackend):
    """The END_S loop: each sample of the batch is a ``(T, 1, N)`` tile
    whose update commits before the next sample runs.

    Returns ``fn(weights, opt_state, batch, generator) -> (weights,
    opt_state, metrics)``; ``metrics`` holds the EPOCH_ACC counters as
    device tensors (``correct``, ``count``, ``spike_rate``)."""

    def train_batch(weights, opt_state, batch: DeviceBatch, generator=None):
        raster, labels, valid = batch["raster"], batch["label"], batch["valid"]
        y_star = _one_hot(labels, cfg.n_out)
        correct, rates = [], []
        for s in range(labels.shape[0]):
            dw, m = backend.train_tile(weights, raster[s][:, None, :],
                                       y_star[s: s + 1], valid[s][:, None])
            weights, opt_state = opt.update(weights, dw, opt_state, generator)
            correct.append(m["pred"][0] == labels[s])
            rates.append(m["spike_rate"])
        return weights, opt_state, {
            "correct": torch.stack(correct).sum(),
            "count": len(correct),
            "spike_rate": torch.stack(rates).mean(),
        }

    return train_batch


def batch_commit_update(cfg: RSNNConfig, opt: EpropSGD, backend: ExecutionBackend,
                        weights, opt_state, batch: DeviceBatch, generator=None):
    """The END_B commit core: the ``(S, T, N)`` batch as one tick-major
    ``(T, S, N)`` tile through ``train_tile``, its batch-summed ``dw``
    committed once with ``num_updates=S``.  Every sample sees the
    batch-start weights.  Returns ``(weights, opt_state, dw, metrics)``."""
    raster = batch["raster"].transpose(0, 1)
    valid = batch["valid"].transpose(0, 1)
    y_star = _one_hot(batch["label"], cfg.n_out)
    dw, metrics = backend.train_tile(weights, raster, y_star, valid)
    weights, opt_state = opt.update(weights, dw, opt_state, generator,
                                    num_updates=float(batch["label"].shape[0]))
    return weights, opt_state, dw, metrics


def make_batch_commit_train_fn(cfg: RSNNConfig, opt: EpropSGD,
                               backend: ExecutionBackend):
    """The END_B training entry over :func:`batch_commit_update`, reporting
    the EPOCH_ACC counters."""

    def train_batch(weights, opt_state, batch: DeviceBatch, generator=None):
        weights, opt_state, _, m = batch_commit_update(
            cfg, opt, backend, weights, opt_state, batch, generator)
        return weights, opt_state, {
            "correct": (m["pred"] == batch["label"]).sum(),
            "count": int(batch["label"].shape[0]),
            "spike_rate": m["spike_rate"],
        }

    return train_batch


def make_eval_batch_fn(cfg: RSNNConfig, backend: ExecutionBackend):
    """Inference-only epoch (the TEST=1 path): one batched tile through
    ``inference``, no updates."""

    def eval_batch(weights, batch: DeviceBatch):
        out = backend.inference(weights, batch["raster"].transpose(0, 1),
                                batch["valid"].transpose(0, 1))
        return {
            "correct": (out["pred"] == batch["label"]).sum(),
            "count": int(batch["label"].shape[0]),
            "spike_rate": out["spike_rate"],
        }

    return eval_batch


def make_batch_infer_fn(cfg: RSNNConfig):
    """Batch inference oracle through the plain tick loop
    (:func:`repro_torch.core.eprop.run_sample_inference`):
    ``fn(weights, raster (T, B, N), valid (T, B)) -> {"acc_y", "pred"}``."""

    def infer_batch(weights, raster: torch.Tensor, valid: torch.Tensor):
        params = merge_trainable(
            {"alpha": torch.tensor(cfg.neuron.alpha, device=raster.device)}, weights)
        out = eprop.run_sample_inference(params, raster, valid, cfg.neuron, cfg.eprop)
        return {"acc_y": out["acc_y"], "pred": out["pred"]}

    return infer_batch


def make_infer_fn(cfg: RSNNConfig):
    """One-sample classify — the chip's one-at-a-time TEST walk:
    ``fn(weights, raster (T, N), valid (T,)) -> {"acc_y" (O,), "pred" ()}``."""
    batched = make_batch_infer_fn(cfg)

    def infer_one(weights, raster: torch.Tensor, valid: torch.Tensor):
        out = batched(weights, raster[:, None, :], valid[:, None])
        return {"acc_y": out["acc_y"][0], "pred": out["pred"][0]}

    return infer_one


@dataclasses.dataclass
class EpochLog:
    """The ILA trace: per-epoch accuracy counters."""

    train_acc: list
    val_acc: list

    def last(self) -> Tuple[float, float]:
        return (
            self.train_acc[-1] if self.train_acc else float("nan"),
            self.val_acc[-1] if self.val_acc else float("nan"),
        )


class OnlineLearner:
    """End-to-end controller: owns weights, optimizer state and the epoch
    loop.

    ``seed`` is an int or a CPU ``torch.Generator``: it draws the initial
    weights (:func:`~repro_torch.core.rsnn.init_params`) and then the seed
    of the device generator that feeds stochastic commits.  ``device``
    defaults to the card (raises without one).  The learner's
    :class:`ExecutionBackend` is shared with the serving engine that
    :meth:`repro_torch.serve.BatchedEngine.from_learner` builds.
    ``pipeline`` arguments follow :mod:`repro_torch.data.pipeline`
    (``batches(split, epoch)``).  ``ctrl.commit`` picks END_S or END_B.

    ``registry`` (a :class:`~repro_torch.serve.registry.ModelRegistry`)
    attaches the learner to serving: its model is registered under
    ``model_id`` on the learner's own backend (adopted into the registry's
    pool, so an engine routed there shares it), and :meth:`publish` runs
    after every ``publish_every``-th commit.  Updates are functional (every
    commit makes new tensors) and the registry loads each image into
    tensors of its own, so a tile launched before a publish keeps the image
    it read.

    ``checkpoint`` (a :class:`~repro_torch.distributed.checkpoint.
    CheckpointPolicy`) arms durability: every ``policy.every``-th commit
    saves the weights, the ``EpropSGD`` residuals and sample count, the
    generator's state and the :class:`ReplayCursor` (asynchronously by
    default), with the backend's register contract, the commit mode and
    the generator's device type in the manifest.  ``fit(resume=True)``
    restores the newest complete checkpoint and replays the batches the
    interrupted run would have consumed.

    ``runtime`` (a :class:`~repro_torch.core.backend.RuntimeConfig`)
    carries a data ``mesh`` and a ``commit_grid`` to the backend (module
    docstring); with a mesh only rank 0 of its data axis writes
    checkpoints.
    """

    def __init__(
        self,
        cfg: RSNNConfig,
        ctrl: ControllerConfig,
        opt_cfg: EpropSGDConfig,
        seed: Union[int, torch.Generator],
        device: DeviceLike = None,
        registry=None,
        model_id: Optional[str] = None,
        publish_every: int = 1,
        checkpoint: Optional[CheckpointPolicy] = None,
        runtime: Optional[RuntimeConfig] = None,
    ):
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        self.cfg, self.ctrl = cfg, ctrl
        self.backend = ExecutionBackend(cfg, device=device,
                                        alpha=float(cfg.neuron.alpha), runtime=runtime)
        dev = self.backend.device
        self.opt = EpropSGD(opt_cfg)
        params = init_params(gen, cfg, device=dev)
        self.weights = self.opt.quantize_init(trainable(params))
        self.alpha = params["alpha"]
        if cfg.eprop.feedback == "random":
            # the random feedback rides with the weights (fixed, untrained)
            self.weights["b_fb"] = params["b_fb"]
        self.opt_state = self.opt.init(self.weights)
        commit_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        self.generator = torch.Generator(device=dev).manual_seed(commit_seed)
        make_fn = (make_batch_commit_train_fn if ctrl.commit == "batch"
                   else make_train_batch_fn)
        self._train_fn = make_fn(cfg, self.opt, self.backend)
        self._eval_fn = make_eval_batch_fn(cfg, self.backend)
        self.log = EpochLog(train_acc=[], val_acc=[])
        self.commits = 0
        self.registry = registry
        self.model_id = model_id if model_id is not None else "default"
        self.publish_every = max(1, int(publish_every))
        # ---- durability
        self.policy = checkpoint
        self.ckpt: Optional[CheckpointManager] = (
            checkpoint.manager() if checkpoint is not None else None)
        self.cursor = ReplayCursor()
        # rank 0 of the data axis writes the checkpoints (every rank holds
        # the same state)
        group = self.backend._group
        self.writes_checkpoints = group is None or dist.get_rank(group) == 0
        self._stop = False            # set by the SIGTERM/SIGINT handler
        self._on_commit: Optional[Callable] = None
        self._old_handlers: Dict[int, object] = {}
        if registry is not None:
            if self.model_id in registry:
                registry.update_weights(self.model_id, self.inference_params())
            else:
                registry.register(self.model_id, cfg, self.inference_params(),
                                  backend=self.backend)

    def publish(self) -> None:
        """Load the live weights into the attached registry (the SPI weight
        reload, mid-serve)."""
        if self.registry is None:
            raise ValueError(
                "learner has no registry attached: construct with registry=")
        self.registry.update_weights(self.model_id, self.inference_params())

    def train_batch(self, batch: DeviceBatch) -> Dict[str, torch.Tensor]:
        """Train on one device batch: one END_B commit, or one END_S loop
        over its samples, per ``ctrl.commit``; publishes after every
        ``publish_every``-th commit when a registry is attached, and cuts a
        checkpoint every ``policy.every``-th when a policy is armed."""
        self.weights, self.opt_state, m = self._train_fn(
            self.weights, self.opt_state, batch, self.generator)
        self.commits += 1
        if self.registry is not None and self.commits % self.publish_every == 0:
            self.publish()
        if self.policy is not None and self.commits % self.policy.every == 0:
            self.save_checkpoint()
        if self._on_commit is not None:
            self._on_commit(self, self.commits)
        return m

    def train_epoch(self, pipeline, epoch: int, start_batch: int = 0) -> float:
        """One training epoch; ``start_batch`` resumes mid-epoch.  The
        cursor moves to ``(epoch, i + 1)`` *before* batch ``i`` trains, so
        a checkpoint cut at its commit names the first batch a resumed run
        must consume.  Stops after the batch in flight on a signal."""
        correct = total = 0
        batches = pipeline.batches("train", epoch, start_batch=start_batch)
        for i, batch in enumerate(batches, start=start_batch):
            self.cursor.epoch, self.cursor.batch = epoch, i + 1
            m = self.train_batch(batch)
            correct += int(m["correct"])
            total += int(m["count"])
            if self._stop:
                break
        else:
            self.cursor.epoch, self.cursor.batch = epoch + 1, 0
        acc = correct / max(total, 1)
        self.log.train_acc.append(acc)
        return acc

    def eval_epoch(self, pipeline, epoch: int, split: str = "val") -> float:
        correct = total = 0
        for batch in pipeline.batches(split, epoch):
            m = self._eval_fn(self.weights, batch)
            correct += int(m["correct"])
            total += int(m["count"])
        acc = correct / max(total, 1)
        if split == "val":
            self.log.val_acc.append(acc)
        return acc

    def inference_params(self) -> Dict[str, torch.Tensor]:
        """Current weights + alpha — what a serving engine
        (:meth:`repro_torch.serve.BatchedEngine.from_learner`) snapshots."""
        return merge_trainable({"alpha": self.alpha}, self.weights)

    # --------------------------------------------------------- durability

    def _ckpt_state(self) -> Dict[str, object]:
        """The restorable state: the SRAM weight image, the optimizer's
        residuals and sample count, and the generator's state (a CPU
        ``uint8`` tensor whatever the generator's device)."""
        return {"weights": self.weights, "opt_state": self.opt_state,
                "generator": self.generator.get_state()}

    def _quant_contract(self) -> Optional[Dict]:
        q = self.backend.quant
        return None if q is None else q.contract()

    def _need_ckpt(self) -> CheckpointManager:
        if self.ckpt is None:
            raise ValueError(
                "learner has no checkpoint policy: construct with checkpoint=")
        return self.ckpt

    def save_checkpoint(self, blocking: Optional[bool] = None) -> None:
        """Cut a checkpoint at the current commit count; ``blocking=None``
        follows ``policy.async_save``.  The manifest holds what a restore
        checks or replays: the commit count, the cursor, the commit mode,
        the register contract, the device count and the generator's
        device type.  On a rank other than the data axis's rank 0 it writes
        nothing."""
        ckpt = self._need_ckpt()
        if not self.writes_checkpoints:
            return
        blocking = not self.policy.async_save if blocking is None else blocking
        extra = {
            "kind": "online_learner",
            "commits": int(self.commits),
            "cursor": self.cursor.as_manifest(),
            "commit_mode": self.ctrl.commit,
            "quant": self._quant_contract(),
            "mesh_devices": int(self.backend.num_devices),
            "model": self.model_id,
            "generator_device": self.generator.device.type,
        }
        save = ckpt.save if blocking else ckpt.save_async
        save(self.commits, self._ckpt_state(), extra)

    def restore_checkpoint(self, step: Optional[int] = None) -> bool:
        """Restore the newest complete checkpoint (or ``step``), checked
        against this learner.

        Returns ``False`` when the directory holds no complete checkpoint.
        Raises :class:`ValueError` when the checkpoint was cut under
        another register contract or commit mode, or by a learner whose
        generator is on another device type: its ``['generator']`` leaf
        cannot seed this learner's generator, and reseeding would give a
        run that is not the uninterrupted one.  A checkpoint of the JAX
        package's learner has a ``['key']`` leaf in place of
        ``['generator']`` and is refused the same way.  An
        attached registry is re-published at once, so live serving lanes
        serve the restored image from their next tile.
        """
        ckpt = self._need_ckpt()
        if step is None:
            step = ckpt.latest_step()
        if step is None:
            return False
        manifest = ckpt.manifest(step)
        want = self._quant_contract()
        got = manifest.get("quant")
        if got != want:
            raise ValueError(
                "checkpoint was cut under a different quantized register "
                f"contract:\n  checkpoint: {got}\n  this learner: {want}")
        if manifest.get("commit_mode") != self.ctrl.commit:
            raise ValueError(
                f"checkpoint was cut in commit={manifest.get('commit_mode')!r} "
                f"mode, this learner runs commit={self.ctrl.commit!r}")
        dev_type, saved = self.generator.device.type, manifest.get("generator_device")
        if saved != dev_type:
            held = ("no ['generator'] leaf" if saved is None else
                    f"a {saved} generator's state in its ['generator'] leaf")
            raise ValueError(
                f"checkpoint holds {held}; this learner's generator is on "
                f"{dev_type}, and reseeding it would not resume the run")
        state = self._ckpt_state()
        host, manifest = ckpt.restore(step, state)
        placed = place_like(state, host)
        self.weights, self.opt_state = placed["weights"], placed["opt_state"]
        self.generator.set_state(placed["generator"])
        self.commits = int(manifest["commits"])
        self.cursor = ReplayCursor.from_manifest(manifest["cursor"])
        if self.registry is not None:
            self.publish()
        return True

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT: finish the batch in flight, cut a final blocking
        checkpoint and return from :meth:`fit` (:attr:`stopped_by_signal`)."""
        for s in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[s] = signal.signal(s, self._on_term)

    def _on_term(self, signum, frame) -> None:
        self._stop = True

    def restore_signal_handlers(self) -> None:
        for s, h in self._old_handlers.items():
            signal.signal(s, h)
        self._old_handlers = {}

    @property
    def stopped_by_signal(self) -> bool:
        return self._stop

    def fit(self, pipeline, verbose: bool = False, resume: bool = False,
            on_commit: Optional[Callable] = None) -> EpochLog:
        """Run the configured epochs, validating every ``eval_every``.
        ``resume=True`` restores the newest checkpoint first and replays
        from its cursor; ``on_commit(learner, commits)`` runs after every
        commit, its checkpoint already cut.  With a policy, ends with a
        blocking save."""
        if on_commit is not None:
            self._on_commit = on_commit
        if resume and self.ckpt is not None:
            self.restore_checkpoint()
        start_batch = self.cursor.batch
        for epoch in range(self.cursor.epoch, self.ctrl.num_epochs):
            tr = self.train_epoch(pipeline, epoch, start_batch=start_batch)
            start_batch = 0
            if self._stop:
                break
            va = (self.eval_epoch(pipeline, epoch)
                  if (epoch + 1) % self.ctrl.eval_every == 0 else float("nan"))
            if verbose:
                print(f"epoch {epoch:4d}  train_acc={tr:.3f}  val_acc={va:.3f}")
        if self.ckpt is not None:
            self.ckpt.wait()
            self.save_checkpoint(blocking=True)
        return self.log

