"""Chaos drill (counterpart of :mod:`repro.train.chaos`): kill a training
run at the worst moments, restart it, and check that the recovered weights
are *bitwise* what an uninterrupted run produces.

Two halves:

* **worker** (``python -m repro_torch.train.chaos --ckpt-dir ...``): a
  subprocess that builds a Braille END_B
  :class:`~repro_torch.core.controller.OnlineLearner` with
  :func:`build_learner`'s defaults (quantized, stochastic commits, an
  asynchronous checkpoint at every commit) on ``--device`` (the card unless
  ``--device cpu``), restores the newest checkpoint and runs ``fit``.  Faults ride on the learner's
  ``on_commit`` hook:

  - ``--kill-at-commit K``: ``SIGKILL`` itself at commit ``K``, once at
    least one complete checkpoint is on disk (it waits up to
    :data:`KILL_WAIT_S` for the writer thread, and raises when none lands:
    a kill before the first checkpoint would test nothing);
  - ``--kill-mid-save-step K``: patch the checkpoint module's
    ``os.rename`` to ``SIGKILL`` the process the moment step ``K``'s
    atomic rename would land, leaving the torn ``.tmp``;
  - ``--sigterm-at-commit K``: the graceful drill; the handler finishes
    the batch, cuts a final blocking checkpoint, and the worker exits
    with :data:`STOPPED_RC`.

  After every commit the worker prints one JSON line (``{"worker": ...}``)
  with its device, its ``rsnn_train`` launches so far, the step it resumed
  from, its ``recovery_s`` (its start to its first commit) and whether it
  built the kernel library.  A worker that finishes its epochs writes the
  final weights (npz) and a result (json) to ``--out`` and exits 0.
  ``--mesh-devices`` and ``--deterministic`` (the integer commit grid and
  the elastic 8 -> 4 drill) are not ported: the worker refuses them.

* **supervisor** (:func:`run_chaos`): spawns one worker with a fault, checks
  that it died by ``SIGKILL`` or stopped with :data:`STOPPED_RC`, then
  respawns it without the fault until it exits clean; :func:`golden_run`
  gives the uninterrupted weights in-process.

Determinism that makes the bitwise gate possible: the batch order is pure
in ``(seed, epoch)`` (:mod:`repro_torch.data.pipeline`), the stochastic
commits' generator state is checkpointed, and ``rsnn_train`` sums ``dw``
in a fixed order, so two launches give the same bits.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

STOPPED_RC = 75        # worker stopped gracefully by SIGTERM (EX_TEMPFAIL)
KILL_WAIT_S = 120.0    # --kill-at-commit: longest wait for a first checkpoint

_SRC = str(Path(__file__).resolve().parents[2])


def build_learner(
    ckpt_dir: Optional[str],
    *,
    device=None,
    quantized: bool = True,
    epochs: int = 3,
    spb: int = 16,
    samples_per_class: int = 12,
    num_ticks: int = 48,
    seed: int = 3,
    async_save: bool = True,
    registry=None,
):
    """A Braille END_B learner and its pipeline, built alike for golden,
    interrupted and resumed runs (one construction point, so the bitwise
    comparison cannot be defeated by a config that drifts).  Quantized
    learners commit stochastically; a checkpoint is cut at every commit and
    every one is kept."""
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.quant import WEIGHT_SPEC
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.checkpoint import CheckpointPolicy
    from repro_torch.optim.eprop_opt import EpropSGDConfig

    data = make_braille_dataset(
        "AEU", BrailleConfig(samples_per_class=samples_per_class, num_ticks=num_ticks))
    cfg = Presets.braille(n_classes=3, num_ticks=num_ticks, quantized=quantized)
    ctrl = ControllerConfig(num_epochs=epochs, commit="batch", eval_every=10_000)
    opt = (EpropSGDConfig(lr=0.01, clip=10.0, quant=WEIGHT_SPEC, stochastic_round=True)
           if quantized else EpropSGDConfig(lr=0.01, clip=10.0))
    policy = (CheckpointPolicy(directory=ckpt_dir, every=1, keep=0, async_save=async_save)
              if ckpt_dir is not None else None)
    learner = OnlineLearner(cfg, ctrl, opt, seed + 100, device=device,
                            registry=registry, checkpoint=policy)
    pipeline = make_pipeline("arm", data, samples_per_batch=spb, shuffle_train=True,
                             seed=seed, device=learner.backend.device)
    return learner, pipeline


def golden_run(**kw) -> Dict[str, np.ndarray]:
    """The uninterrupted reference: the same learner, no checkpoints, no
    kills.  Returns the final weights as host NumPy."""
    learner, pipeline = build_learner(None, **kw)
    learner.fit(pipeline)
    return {k: v.cpu().numpy() for k, v in sorted(learner.weights.items())}


# ---------------------------------------------------------------- worker

def _arm_mid_save_kill(at_step: int) -> None:
    """SIGKILL this process the moment checkpoint ``at_step``'s atomic
    rename would land: the write is complete but never committed, leaving
    the torn ``.tmp`` the next manager must sweep."""
    from repro_torch.distributed import checkpoint as ckpt_mod

    real_rename = ckpt_mod.os.rename
    tag = f"step_{at_step:09d}"

    def rename(src, dst):
        if tag == Path(str(dst)).name:
            os.kill(os.getpid(), signal.SIGKILL)
        return real_rename(src, dst)

    ckpt_mod.os.rename = rename


def _wait_for_checkpoint(ckpt, limit_s: float) -> int:
    """Poll until a complete checkpoint is on disk; raise after ``limit_s``."""
    t0 = time.perf_counter()
    while (step := ckpt.latest_step()) is None:
        if time.perf_counter() - t0 > limit_s:
            raise RuntimeError(
                f"no complete checkpoint on disk {limit_s:.0f} s after the kill "
                "commit: a SIGKILL now would test nothing")
        time.sleep(0.01)
    return step


def run_worker(args: argparse.Namespace) -> int:
    from repro_torch.kernels import build, ops

    t0 = time.time()
    learner, pipeline = build_learner(
        args.ckpt_dir, device=args.device, epochs=args.epochs, spb=args.spb,
        samples_per_class=args.samples_per_class, num_ticks=args.ticks)
    if args.kill_mid_save_step is not None:
        _arm_mid_save_kill(args.kill_mid_save_step)
    learner.install_signal_handlers()
    device = learner.backend.device.type
    resumed_from = learner.commits if learner.restore_checkpoint() else None
    first_commit_s: Dict[str, float] = {}

    def status(commits: int) -> Dict:
        return {"device": device, "commits": commits, "resumed_from": resumed_from,
                "recovery_s": first_commit_s.get("t"),
                "rsnn_train": ops.launches["rsnn_train"], "built": bool(build.build_log)}

    def on_commit(lrn, commits):
        first_commit_s.setdefault("t", time.time() - t0)
        print(json.dumps({"worker": status(commits)}), flush=True)
        if args.kill_at_commit is not None and commits >= args.kill_at_commit:
            _wait_for_checkpoint(lrn.ckpt, KILL_WAIT_S)
            os.kill(os.getpid(), signal.SIGKILL)
        if args.sigterm_at_commit is not None and commits >= args.sigterm_at_commit:
            os.kill(os.getpid(), signal.SIGTERM)

    learner.fit(pipeline, on_commit=on_commit)
    learner.restore_signal_handlers()
    if learner.stopped_by_signal:
        return STOPPED_RC

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out.with_suffix(".npz"),
                 **{k: v.cpu().numpy() for k, v in sorted(learner.weights.items())})
        train_acc = learner.log.train_acc[-1] if learner.log.train_acc else None
        out.with_suffix(".json").write_text(json.dumps({
            **status(learner.commits),
            "wall_s": time.time() - t0,
            "train_acc": train_acc,
        }))
    return 0


# ------------------------------------------------------------ supervisor

def spawn(argv, timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Run one worker subprocess with the port's ``src`` on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.train.chaos", *map(str, argv)],
        env=env, capture_output=True, text=True, timeout=timeout)


def _record(proc: subprocess.CompletedProcess, seconds: float) -> Dict:
    """One spawn's exit code, seconds and last ``{"worker": ...}`` line."""
    last = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"worker"'):
            last = json.loads(line)["worker"]
    return {"rc": proc.returncode, "seconds": seconds, "status": last}


def _output(proc: subprocess.CompletedProcess) -> str:
    return f"\n--- stdout\n{proc.stdout[-4000:]}\n--- stderr\n{proc.stderr[-4000:]}"


def run_chaos(ckpt_dir: str, out: str, kill_args, worker_args,
              max_restarts: int = 5, timeout: float = 600.0) -> Dict:
    """The drill: one doomed worker, then restarts until a clean exit.

    ``kill_args`` ride only on the first spawn, which must die by SIGKILL
    or stop with :data:`STOPPED_RC`; restarts run the same worker without
    them.  Returns the final worker's result with ``restarts`` and
    ``spawns`` (each spawn's exit code, seconds and last status line)."""
    base = ["--ckpt-dir", ckpt_dir, "--out", out, *map(str, worker_args)]
    spawns = []

    def run(argv):
        t0 = time.perf_counter()
        proc = spawn(argv, timeout=timeout)
        spawns.append(_record(proc, time.perf_counter() - t0))
        return proc

    first = run(base + list(map(str, kill_args)))
    if first.returncode not in (-signal.SIGKILL, STOPPED_RC):
        raise RuntimeError(
            f"doomed worker exited rc={first.returncode}, not by its fault"
            + _output(first))
    restarts = 0
    while restarts < max_restarts:
        restarts += 1
        proc = run(base)
        if proc.returncode == 0:
            break
        if proc.returncode not in (-signal.SIGKILL, STOPPED_RC):
            raise RuntimeError(
                f"restart {restarts} died unexpectedly rc={proc.returncode}"
                + _output(proc))
    else:
        raise RuntimeError(f"no clean exit after {max_restarts} restarts")
    result = json.loads(Path(out).with_suffix(".json").read_text())
    result["restarts"] = restarts
    result["spawns"] = spawns
    return result


def load_result_weights(out: str) -> Dict[str, np.ndarray]:
    with np.load(Path(out).with_suffix(".npz")) as z:
        return {k: z[k] for k in z.files}


NOT_PORTED = ("--mesh-devices", "--deterministic")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for flag in NOT_PORTED:
        if any(a.split("=")[0] == flag for a in argv):
            ap.error(f"{flag} is not ported: the commit grid and the elastic "
                     "drill need a mesh")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--spb", type=int, default=16)
    ap.add_argument("--samples-per-class", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--kill-at-commit", type=int, default=None)
    ap.add_argument("--kill-mid-save-step", type=int, default=None)
    ap.add_argument("--sigterm-at-commit", type=int, default=None)
    return run_worker(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
