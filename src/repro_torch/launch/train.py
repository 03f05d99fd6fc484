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
The sharded (FSDP × TP) step over a ``(data, model)`` mesh, one process a
rank under ``torchrun`` (gloo on the CPU, NCCL on the cards):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-1.7b --reduced --device cpu --mesh 2x2 --steps 6
and on one card ``--mesh 1x1`` (a world of one when no ``torchrun``
started it).

:func:`build_run` makes what ``main`` trains (the model,
``AdamW(lr, warmup_steps=10, decay_steps=steps)``, ``make_train_step``,
the ``TokenStream``, and on request ``Model.init`` weights from seed 0
with their AdamW state), so other callers step the same thing.
``--mesh`` parses as the reference does: ``16x16`` and ``2x16x16`` are
the production meshes, ``DxM`` a ``(data, model)`` debug mesh and ``N``
``(N, 1)``; another three-part string raises ``ValueError`` (the
reference keeps its last two numbers and drops ``pod``).  Each rank
steps the state placed on the mesh (:func:`~repro_torch.train.train_step.
make_train_step_sharded`); rank 0 alone writes the checkpoints, which
hold whole tensors.  The pod-compressed step
(``train/train_step.py:make_train_step_compressed``) and GPipe
(``distributed/pipeline.py``) are library functions, not options here.
Checkpoints go to ``build/lm_ckpt`` in the checkout unless ``--ckpt-dir``
says otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import join_world, leave_world, make_debug_mesh, \
    make_production_mesh
from repro_torch.models.model import Model, build
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train.train_step import make_sharded_parts, make_train_step, \
    make_train_step_sharded
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
    place: Optional[Callable] = None   # (params, opt_state) onto the mesh

    def init_state(self) -> Tuple[Any, Any]:
        """``Model.init(seed=0)`` weights and their AdamW state, placed on
        the run's mesh when it has one."""
        params = self.model.init(seed=0, device=self.device)
        state = params, self.opt.init(params)
        return state if self.place is None else self.place(*state)


def build_run(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
              n_micro: int = 1, device: DeviceLike = None, mesh=None,
              rules: Optional[ShardingRules] = None) -> TrainRun:
    """The model, optimizer, train step and token stream of a run of
    ``steps`` steps on ``device`` (the card unless the caller passes
    ``"cpu"``); with ``mesh``, the sharded step over it, the state placed
    by ``rules`` (default the baseline)."""
    dev = resolve_device(device)
    model = build(cfg)
    opt = AdamW(AdamWConfig(lr=lr, warmup_steps=10, decay_steps=steps))
    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, batch=batch, seq_len=seq, d_model=cfg.d_model,
        family=cfg.family, n_media_tokens=cfg.n_media_tokens), device=dev)
    if mesh is None:
        return TrainRun(model, opt, make_train_step(model, opt, n_micro=n_micro), stream, dev)
    step = make_train_step_sharded(model, opt, mesh, rules, n_micro=n_micro)
    place = make_sharded_parts(model, opt, mesh, rules, n_micro=n_micro)[0]
    return TrainRun(model, opt, step, stream, dev, place)


def parse_mesh(spec: str) -> Tuple[str, Tuple[int, ...]]:
    """``--mesh`` as the reference reads it: ``("production", (16, 16))``
    or ``("production", (2, 16, 16))``, else ``("debug", (data, model))``
    (``N`` alone is ``(N, 1)``).  Another three-part string raises
    ``ValueError``: the reference keeps its last two numbers as ``(data,
    model)`` and drops ``pod`` without a word."""
    dims = [int(d) for d in spec.split("x")]
    if dims in ([16, 16], [2, 16, 16]):
        return "production", tuple(dims)
    if len(dims) == 1:
        return "debug", (dims[0], 1)
    if len(dims) == 2:
        return "debug", tuple(dims)
    raise ValueError(f"--mesh {spec}: a three-part mesh other than 2x16x16 has no "
                     f"(pod, data, model) layout here (the reference drops its pod)")


def make_mesh(spec: str, device: str):
    """The mesh ``--mesh spec`` names, over the current world."""
    kind, dims = parse_mesh(spec)
    if kind == "production":
        return make_production_mesh(multi_pod=len(dims) == 3, device=device)
    return make_debug_mesh(*dims, device=device)


@contextlib.contextmanager
def _world(device: str):
    """The process world ``torchrun`` describes in the environment
    (``env://``), or a world of one when nothing does (a ``file://``
    rendezvous in a temporary directory); a world already joined is used
    as it is.  Each rank takes the card ``LOCAL_RANK`` names on its own
    machine (``RANK`` is its place in the world, over every machine).
    Yields this rank's device."""
    if dist.is_initialized():
        yield (torch.device("cpu") if device == "cpu"
               else torch.device("cuda", torch.cuda.current_device()))
        return
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:
            rank, world, init = (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                                 "env://")
            local = int(os.environ.get("LOCAL_RANK", rank))
        else:
            rank, world, init, local = 0, 1, f"file://{tmp}/rendezvous", 0
        dev = join_world(rank, world, init, device=device, local_rank=local)
        try:
            yield dev
        finally:
            leave_world()


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
                    help="e.g. 2x2 (data x model), 16x16 or 2x16x16 (default: one device)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> RunResult:
    """``main``'s run, returned.  A SIGTERM or SIGINT ends it after the
    step in flight, with a final checkpoint to ``--resume`` from."""
    opts = parse_args(argv)
    if not opts.mesh:
        return _run(opts, resolve_device(opts.device), None)
    parse_mesh(opts.mesh)
    with _world(opts.device) as dev:
        return _run(opts, dev, make_mesh(opts.mesh, opts.device))


def _run(opts, dev: torch.device, mesh) -> RunResult:
    cfg = get_reduced(opts.arch) if opts.reduced else get_config(opts.arch)
    r = build_run(cfg, steps=opts.steps, batch=opts.batch, seq=opts.seq, lr=opts.lr,
                  n_micro=opts.n_micro, device=dev, mesh=mesh)
    writer = mesh is None or dist.get_rank() == 0
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
            if writer:
                print(f"resumed from step {trainer.step}")
        summary = trainer.run()
    finally:
        trainer.restore_signal_handlers()
    if mesh is not None:
        dist.barrier()      # rank 0's last checkpoint is on disk before any rank goes on
    losses = [float(x) for x in losses]
    if writer:
        print("training summary:", summary)
        if losses:
            print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return RunResult(trainer, summary, losses)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
