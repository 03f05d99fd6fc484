"""e-prop batch-commit step for the fault-tolerant
:class:`~repro_torch.train.trainer.Trainer` (counterpart of
:mod:`repro.train.eprop_step`).

The trainer wants ``step_fn(params, opt_state, batch) -> (params,
opt_state, metrics)`` with finite ``loss`` and ``grad_norm`` metrics.  This
module adapts the online-learning stack to it: one END_B commit a step
through :func:`~repro_torch.core.controller.batch_commit_update` on one
:class:`~repro_torch.core.backend.ExecutionBackend` (on the card, one
``rsnn_train`` launch a step).

``loss`` is the mean cross-entropy of the accumulated LI readout and
``grad_norm`` the global norm of the committed ``dw``, so the trainer's
non-finite-step rejection guards the weight SRAM.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.backend import as_backend
from repro_torch.core.controller import batch_commit_update
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.distributed.checkpoint import ReplayCursor
from repro_torch.optim.eprop_opt import EpropSGD


def make_eprop_commit_step(cfg: RSNNConfig, opt: EpropSGD, backend=None) -> Callable:
    """A Trainer step over ``(S, T, N)`` device batches; ``backend`` is a
    device, a :class:`~repro_torch.core.backend.RuntimeConfig` or a backend
    to share (``None``: the card).

    Round-nearest or float commits only: the step carries no generator, so
    ``stochastic_round`` is refused (use
    :class:`~repro_torch.core.controller.OnlineLearner` for those)."""
    if opt.cfg.stochastic_round:
        raise ValueError(
            "Trainer steps carry no generator; stochastic rounding needs "
            "OnlineLearner")
    engine = as_backend(cfg, backend)

    def step(weights, opt_state, batch):
        new_w, new_opt, dw, metrics = batch_commit_update(
            cfg, opt, engine, weights, opt_state, batch)
        labels = batch["label"]
        logp = torch.log_softmax(metrics["acc_y"], dim=-1)
        loss = -logp.gather(-1, labels[:, None]).mean()
        gnorm = torch.sqrt(sum(torch.sum(torch.square(dw[k])) for k in sorted(dw)))
        acc = (metrics["pred"] == labels).to(torch.float32).mean()
        return new_w, new_opt, {
            "loss": loss,
            "grad_norm": gnorm,
            "accuracy": acc,
            "spike_rate": metrics["spike_rate"],
        }

    return step


def epoch_batches(pipeline, split: str = "train", max_epochs: Optional[int] = None,
                  cursor: Optional[ReplayCursor] = None) -> Iterator[dict]:
    """A pipeline's epochs as the endless batch iterator the Trainer
    consumes (``max_epochs`` bounds it).

    ``cursor`` is advanced *in place*: before each batch is yielded it is
    set to ``(epoch, index + 1)``, the next batch a consumer that commits
    the yielded one needs, so a checkpoint cut after the commit records
    where to resume.  A restored cursor starts mid-stream, and the
    pipeline's ``(seed, epoch)``-pure order replays what the interrupted
    run would have consumed.
    """
    epoch = cursor.epoch if cursor is not None else 0
    start = cursor.batch if cursor is not None else 0
    while max_epochs is None or epoch < max_epochs:
        yielded = False
        for i, batch in enumerate(pipeline.batches(split, epoch, start_batch=start),
                                  start=start):
            yielded = True
            if cursor is not None:
                cursor.epoch, cursor.batch = epoch, i + 1
            yield batch
        if not yielded and start == 0:
            return
        epoch += 1
        start = 0
        if cursor is not None:
            cursor.epoch, cursor.batch = epoch, 0
