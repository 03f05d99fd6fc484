"""Training launcher CLI for the LM (counterpart of
:mod:`repro.launch.train`): a real optimisation loop over the synthetic
Zipf token stream through the fault-tolerant ``Trainer`` (atomic async
checkpoints, non-finite step rejection, straggler watchdog, SIGTERM-safe
shutdown, ``--resume``).

On the card (the default), a full config fits one H100 up to qwen3-1.7b,
mamba2-1.3b and seamless-m4t-large-v2 (jamba-v0.1-52b and
llama-3.2-vision-90b train at ``--reduced`` only: about 12 bytes a
parameter of state):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 8 --batch 4 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 8 --batch 4 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-large-v2 --steps 8 --batch 4 --seq 2048
On a CPU, a reduced config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --device cpu --steps 6

:func:`build_run` makes what ``main`` trains (the model,
``AdamW(lr, warmup_steps=10, decay_steps=steps)``, ``make_train_step``,
the ``TokenStream``, and on request ``Model.init`` weights from seed 0
with their AdamW state), so other callers step the same thing.
``--mesh`` (the LM's FSDP × TP sharding) raises: the sharded step waits
for ROADMAP A8 item 5's second half.  The pod-compressed step
(``train/train_step.py:make_train_step_compressed``) and GPipe
(``distributed/pipeline.py``) are library functions, not options here.
Checkpoints go to ``build/lm_ckpt`` in the checkout unless ``--ckpt-dir``
says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "lm_ckpt"


@dataclasses.dataclass
class TrainRun:
    """Everything a training loop steps: ``step_fn(params, opt_state,
    batch) -> (params, opt_state, metrics)`` over batches of ``stream``.
    It holds no state: :meth:`init_state` hands fresh state to the caller,
    whose steps replace it (a run that kept the first state would keep
    its weights and moments alive to the end, 16 GiB at qwen3-1.7b)."""

    model: Model
    opt: AdamW
    step_fn: Callable
    stream: TokenStream
    device: torch.device

    def init_state(self) -> Tuple[Any, Any]:
        """``Model.init(seed=0)`` weights and their AdamW state."""
        params = self.model.init(seed=0, device=self.device)
        return params, self.opt.init(params)


def build_run(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
              n_micro: int = 1, device: DeviceLike = None) -> TrainRun:
    """The model, optimizer, train step and token stream of a run of
    ``steps`` steps on ``device`` (the card unless the caller passes
    ``"cpu"``)."""
    dev = resolve_device(device)
    model = build(cfg)
    opt = AdamW(AdamWConfig(lr=lr, warmup_steps=10, decay_steps=steps))
    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, batch=batch, seq_len=seq, d_model=cfg.d_model,
        family=cfg.family, n_media_tokens=cfg.n_media_tokens), device=dev)
    return TrainRun(model, opt, make_train_step(model, opt, n_micro=n_micro), stream, dev)


@dataclasses.dataclass
class RunResult:
    trainer: Trainer
    summary: dict
    losses: List[float]        # every step's loss in order, a rejected one's too


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="the LM's sharded step: not ported yet (raises)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> RunResult:
    """``main``'s run, returned.  A SIGTERM or SIGINT ends it after the
    step in flight, with a final checkpoint to ``--resume`` from."""
    opts = parse_args(argv)
    if opts.mesh:
        raise NotImplementedError(
            f"--mesh {opts.mesh}: the LM's sharded (FSDP x TP) step is not ported yet "
            f"(ROADMAP A8 item 5, second half)")
    cfg = get_reduced(opts.arch) if opts.reduced else get_config(opts.arch)
    r = build_run(cfg, steps=opts.steps, batch=opts.batch, seq=opts.seq, lr=opts.lr,
                  n_micro=opts.n_micro, device=resolve_device(opts.device))
    losses = []

    def step(params, opt_state, batch):
        out = r.step_fn(params, opt_state, batch)
        losses.append(out[2]["loss"])
        return out

    trainer = Trainer(step, *r.init_state(), r.stream, TrainerConfig(
        total_steps=opts.steps, ckpt_every=opts.ckpt_every, ckpt_dir=opts.ckpt_dir,
        log_every=5))
    trainer.install_signal_handlers()
    try:
        if opts.resume and trainer.restore():
            r.stream.position = trainer.step
            print(f"resumed from step {trainer.step}")
        summary = trainer.run()
    finally:
        trainer.restore_signal_handlers()
    losses = [float(x) for x in losses]
    print("training summary:", summary)
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return RunResult(trainer, summary, losses)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
