"""Chaos drill (counterpart of :mod:`repro.train.chaos`): kill a training
run at the worst moments, restart it, and check that the recovered weights
are *bitwise* what an uninterrupted run produces.

Two halves:

* **worker** (``python -m repro_torch.train.chaos --ckpt-dir ...``): a
  subprocess that builds a Braille END_B
  :class:`~repro_torch.core.controller.OnlineLearner` with
  :func:`build_learner`'s defaults (quantized, stochastic commits, an
  asynchronous checkpoint at every commit) on ``--device`` (the card unless
  ``--device cpu``), restores the newest checkpoint and runs ``fit``.
  ``--float`` trains float weights, ``--seed`` seeds the learner and the
  batch order, ``--every N`` checkpoints every N commits and ``--sync``
  saves blocking, as the reference's worker takes them (its ``--backend``
  has no counterpart: the port dispatches by ``--device``).  Faults ride
  on the learner's ``on_commit`` hook:

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
  with its device, its ranks, whether it commits on the integer grid, its
  ``rsnn_train`` launches so far (all of them, and those that reduced
  onto the grid), the step it resumed from, its ``recovery_s`` (its start
  to its first commit) and whether it built the kernel library.  A worker that finishes its epochs
  writes the final weights (npz) and a result (json) to ``--out`` and
  exits 0.

  ``--deterministic`` sums END_B's ``dw`` on the integer commit grid
  (:data:`~repro_torch.core.quant.DW_COMMIT_SPEC`), so a commit does not
  depend on the rank count.  ``--mesh-devices N`` (N > 1) makes the worker
  a *launcher* of an N-rank data-parallel world: N processes of this
  module (``--rank r``, a ``file://`` rendezvous, the group timeout of
  :data:`repro_torch.launch.mesh.DEFAULT_TIMEOUT_S`), in one process
  group of their own, each dying with the launcher.  Every rank runs the
  same learner on a
  ``("data",)`` mesh; rank 0 writes the checkpoints, the status lines and
  the result.  The faults act per rank: ``--kill-at-commit`` SIGKILLs the
  last rank (once rank 0's checkpoint is on disk), which leaves the
  others blocked in a collective; ``--kill-mid-save-step`` kills rank 0,
  the writer; ``--sigterm-at-commit`` stops every rank after the same
  batch.  When a rank dies the launcher kills the rest of the world and
  dies by the same signal (or exits with the rank's code), so the
  supervisor sees the fault as it would from one process; a world whose
  ranks all stopped by SIGTERM exits :data:`STOPPED_RC`.  On the card
  each rank takes a card of its own (NCCL runs one rank a card), so a
  one-card machine runs ``--mesh-devices 1`` only; the multi-rank drills
  run on gloo ranks on the CPU.

* **supervisor** (:func:`run_chaos`): spawns one worker with a fault, checks
  that it died by ``SIGKILL`` or stopped with :data:`STOPPED_RC`, then
  respawns it without the fault until it exits clean, on
  ``restart_mesh_devices`` ranks when given (the elastic 8 -> 4 drill);
  :func:`golden_run` gives the uninterrupted weights in-process, on one
  device.

Determinism that makes the bitwise gate possible: the batch order is pure
in ``(seed, epoch)`` (:mod:`repro_torch.data.pipeline`), the stochastic
commits' generator state is checkpointed (and starts alike on every
rank), and ``rsnn_train`` sums ``dw`` in a fixed order, so two launches
give the same bits; across rank counts, the commit grid's int32 sums.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

STOPPED_RC = 75        # worker stopped gracefully by SIGTERM (EX_TEMPFAIL)
KILL_WAIT_S = 120.0    # --kill-at-commit: longest wait for a first checkpoint
POLL_S = 0.05          # the launcher's look at its ranks
GRACE_S = 1.0          # after a rank's fault: time to collect the others' codes

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
    checkpoint_every: int = 1,
    keep: int = 0,
    async_save: bool = True,
    registry=None,
    mesh_devices: int = 0,
    deterministic: bool = False,
):
    """A Braille END_B learner and its pipeline, built alike for golden,
    interrupted and resumed runs (one construction point, so the bitwise
    comparison cannot be defeated by a config that drifts).  Quantized
    learners commit stochastically; a checkpoint is cut every
    ``checkpoint_every`` commits and the newest ``keep`` are kept (0: every
    one).  ``mesh_devices > 1`` puts the learner on a data mesh over the
    world of that many ranks the caller has joined; ``deterministic`` arms
    the integer commit grid."""
    from repro_torch.core.backend import RuntimeConfig
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.quant import DW_COMMIT_SPEC, WEIGHT_SPEC
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.device import resolve_device
    from repro_torch.distributed.checkpoint import CheckpointPolicy
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.optim.eprop_opt import EpropSGDConfig

    data = make_braille_dataset(
        "AEU", BrailleConfig(samples_per_class=samples_per_class, num_ticks=num_ticks))
    cfg = Presets.braille(n_classes=3, num_ticks=num_ticks, quantized=quantized)
    ctrl = ControllerConfig(num_epochs=epochs, commit="batch", eval_every=10_000)
    opt = (EpropSGDConfig(lr=0.01, clip=10.0, quant=WEIGHT_SPEC, stochastic_round=True)
           if quantized else EpropSGDConfig(lr=0.01, clip=10.0))
    policy = (CheckpointPolicy(directory=ckpt_dir, every=checkpoint_every, keep=keep,
                               async_save=async_save)
              if ckpt_dir is not None else None)
    mesh = make_data_mesh(device=resolve_device(device).type) if mesh_devices > 1 else None
    rt = RuntimeConfig(mesh=mesh, commit_grid=DW_COMMIT_SPEC if deterministic else None)
    learner = OnlineLearner(cfg, ctrl, opt, seed + 100, device=device,
                            registry=registry, checkpoint=policy, runtime=rt)
    pipeline = make_pipeline("arm", data, samples_per_batch=spb, shuffle_train=True,
                             seed=seed, device=learner.backend.device)
    return learner, pipeline


def golden_run(**kw) -> Dict[str, np.ndarray]:
    """The uninterrupted reference: the same learner, no checkpoints, no
    kills, in this process (on one device unless the caller has joined a
    world and passes ``mesh_devices``).  Returns the final weights as host
    NumPy."""
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


def _emit(obj) -> None:
    """One JSON line to standard output in a single write: the ranks of a
    world share the launcher's pipe, and a line written in pieces would
    interleave with another rank's."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps(obj) + "\n").encode())


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
    """One worker, or one rank of a world the launcher started (the caller
    has joined it)."""
    import torch.distributed as dist

    from repro_torch.kernels import build, ops

    t0 = time.time()
    learner, pipeline = build_learner(
        args.ckpt_dir, device=args.device, quantized=not args.float, epochs=args.epochs,
        spb=args.spb, samples_per_class=args.samples_per_class, num_ticks=args.ticks,
        seed=args.seed, checkpoint_every=args.every, async_save=not args.sync,
        mesh_devices=args.mesh_devices, deterministic=args.deterministic)
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    if world > 1:       # the supervisor's record of the world's processes
        _emit({"rank": {"rank": rank, "pid": os.getpid()}})
    if args.kill_mid_save_step is not None:
        _arm_mid_save_kill(args.kill_mid_save_step)
    learner.install_signal_handlers()
    device = learner.backend.device.type
    resumed_from = learner.commits if learner.restore_checkpoint() else None
    first_commit_s: Dict[str, float] = {}

    def status(commits: int) -> Dict:
        return {"device": device, "ranks": learner.backend.num_devices,
                "commit_grid": learner.backend.commit_grid is not None,
                "commits": commits, "resumed_from": resumed_from,
                "recovery_s": first_commit_s.get("t"),
                "rsnn_train": ops.launches["rsnn_train"],
                "rsnn_train_grid": ops.grid_launches["rsnn_train"],
                "built": bool(build.build_log)}

    def on_commit(lrn, commits):
        first_commit_s.setdefault("t", time.time() - t0)
        if rank == 0:
            _emit({"worker": status(commits)})
        if (args.kill_at_commit is not None and commits >= args.kill_at_commit
                and rank == world - 1):
            _wait_for_checkpoint(lrn.ckpt, KILL_WAIT_S)
            os.kill(os.getpid(), signal.SIGKILL)
        if args.sigterm_at_commit is not None and commits >= args.sigterm_at_commit:
            os.kill(os.getpid(), signal.SIGTERM)

    learner.fit(pipeline, on_commit=on_commit)
    learner.restore_signal_handlers()
    if learner.stopped_by_signal:
        return STOPPED_RC

    if args.out and rank == 0:
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

def _env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def spawn(argv, timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Run one worker subprocess (or a launcher and its world) with the
    port's ``src`` on its path."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.train.chaos", *map(str, argv)],
        env=_env(), capture_output=True, text=True, timeout=timeout)


def _record(proc: subprocess.CompletedProcess, seconds: float) -> Dict:
    """One spawn's exit code, seconds, last ``{"worker": ...}`` line and
    the process ids of its world's ranks (none for one process)."""
    last, pids = None, []
    for line in proc.stdout.splitlines():
        if line.startswith('{"worker"'):
            last = json.loads(line)["worker"]
        elif line.startswith('{"rank"'):
            pids.append(json.loads(line)["rank"]["pid"])
    return {"rc": proc.returncode, "seconds": seconds, "status": last, "pids": pids}


def _output(proc: subprocess.CompletedProcess) -> str:
    return f"\n--- stdout\n{proc.stdout[-4000:]}\n--- stderr\n{proc.stderr[-4000:]}"


def run_chaos(ckpt_dir: str, out: str, kill_args, worker_args,
              mesh_devices: int = 0, restart_mesh_devices: Optional[int] = None,
              max_restarts: int = 5, timeout: float = 600.0) -> Dict:
    """The drill: one doomed worker, then restarts until a clean exit.

    ``kill_args`` ride only on the first spawn, which must die by SIGKILL
    or stop with :data:`STOPPED_RC`; restarts run the same worker without
    them, on ``restart_mesh_devices`` ranks when given (else
    ``mesh_devices``; 0 or 1 is one process).  Returns the final worker's
    result with ``restarts`` and ``spawns`` (each spawn's exit code,
    seconds and last status line)."""
    base = ["--ckpt-dir", ckpt_dir, "--out", out, *map(str, worker_args)]
    spawns = []

    def run(argv, ranks):
        t0 = time.perf_counter()
        proc = spawn(argv + ["--mesh-devices", str(ranks)], timeout=timeout)
        spawns.append(_record(proc, time.perf_counter() - t0))
        return proc

    rc_mesh = mesh_devices if restart_mesh_devices is None else restart_mesh_devices
    first = run(base + list(map(str, kill_args)), mesh_devices)
    if first.returncode not in (-signal.SIGKILL, STOPPED_RC):
        raise RuntimeError(
            f"doomed worker exited rc={first.returncode}, not by its fault"
            + _output(first))
    restarts = 0
    while restarts < max_restarts:
        restarts += 1
        proc = run(base, rc_mesh)
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


# ------------------------------------------------------------- launcher

def _rank_preexec(pgid: int) -> None:
    """In a rank, before it runs: join the world's process group (``pgid``
    0 starts it) and be SIGKILLed when the launcher dies (Linux
    ``prctl(PR_SET_PDEATHSIG)``), so that a launcher killed by its
    supervisor's timeout leaves no rank behind."""
    os.setpgid(0, pgid)
    if sys.platform.startswith("linux"):
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def _stop_world(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _watch(procs) -> int:
    """Wait for the world: 0 when every rank finished, :data:`STOPPED_RC`
    when every rank stopped or finished and one stopped, else the first
    fault's code (a rank killed by a signal before a rank that failed for
    want of it), the rest of the world killed at once."""
    while True:
        rcs = [p.poll() for p in procs]
        if any(rc not in (None, 0, STOPPED_RC) for rc in rcs):
            time.sleep(GRACE_S)           # the others' codes, to find the cause
            faults = [p.poll() for p in procs]
            _stop_world(procs)
            return min(rc for rc in faults if rc not in (None, 0, STOPPED_RC))
        if all(rc is not None for rc in rcs):
            return STOPPED_RC if STOPPED_RC in rcs else 0
        time.sleep(POLL_S)


def launch_world(argv, ranks: int) -> int:
    """Start ``ranks`` processes of this module (``argv`` plus ``--rank r``
    and a fresh ``file://`` rendezvous) in one process group of their own,
    each dying with the launcher, and watch them (:func:`_watch`).  A rank
    that exits with a fault brings the rest of the world down at once (the
    survivors would block in a collective); the launcher then dies by that
    rank's signal, or returns its code."""
    rdv = Path(tempfile.mkdtemp(prefix="chaos-world-"))
    procs = []
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.train.chaos", *argv,
                 "--rank", str(r), "--rendezvous", str(rdv / "rendezvous")],
                env=_env(),
                preexec_fn=functools.partial(_rank_preexec, procs[0].pid if procs else 0)))
        rc = _watch(procs)
    finally:
        _stop_world(procs)
        shutil.rmtree(rdv, ignore_errors=True)
    if rc < 0:
        os.kill(os.getpid(), -rc)
    return rc


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--float", action="store_true",
                    help="float weights (default: quantized chip mode)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--spb", type=int, default=16)
    ap.add_argument("--samples-per-class", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--deterministic", action="store_true",
                    help="END_B on the integer commit grid (the same bits on any "
                         "rank count)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="N > 1: launch an N-rank data-parallel world (one card a "
                         "rank on cuda, gloo ranks on cpu)")
    ap.add_argument("--every", type=int, default=1, help="checkpoint every N commits")
    ap.add_argument("--sync", action="store_true", help="blocking saves (default: async)")
    ap.add_argument("--kill-at-commit", type=int, default=None)
    ap.add_argument("--kill-mid-save-step", type=int, default=None)
    ap.add_argument("--sigterm-at-commit", type=int, default=None)
    # set by the launcher on each rank of its world
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_devices < 0:
        ap.error("--mesh-devices must be >= 0")
    if args.every < 1:
        ap.error("--every must be >= 1")
    if args.rank is not None and (args.rendezvous is None
                                  or not 0 <= args.rank < args.mesh_devices):
        ap.error("--rank needs --rendezvous and 0 <= rank < --mesh-devices")
    return args


def main(argv=None) -> int:
    import torch

    from repro_torch.launch import mesh

    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parse_args(argv)
    if args.mesh_devices > 1 and args.rank is None:
        if args.device != "cpu":
            from repro_torch.device import resolve_device

            resolve_device(args.device)
            if args.mesh_devices > torch.cuda.device_count():
                raise ValueError(
                    f"--mesh-devices {args.mesh_devices} on {args.device} needs as many "
                    f"cards, this machine has {torch.cuda.device_count()}: NCCL runs "
                    "one rank a card")
        return launch_world(argv, args.mesh_devices)
    if args.rank is None:
        return run_worker(args)
    mesh.join_world(args.rank, args.mesh_devices, f"file://{args.rendezvous}",
                    device=args.device)
    try:
        rc = run_worker(args)
        # every rank done before any tears down its connections: a rank
        # that leaves while a peer is still in the group can abort the peer
        torch.distributed.barrier()
        return rc
    finally:
        mesh.leave_world()


if __name__ == "__main__":
    sys.exit(main())
