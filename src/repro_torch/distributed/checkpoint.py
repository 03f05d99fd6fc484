"""Atomic, asynchronous checkpoints with keep-N retention and manifests
(counterpart of :mod:`repro.distributed.checkpoint`, in the same format).

Layout:
  <dir>/step_000000420/
      manifest.json        {step, time, leaves, **extra}
      arrays.npz           one entry per flattened tree leaf
  <dir>/LATEST             text file naming the newest complete checkpoint

Atomicity: each checkpoint is written into ``step_X.tmp`` and renamed into
place only after every array is on disk, so a crash mid-save never
corrupts the restore path (rename is atomic on POSIX).  Torn ``.tmp``
directories left by a crashed process are invisible to ``all_steps`` /
``latest_step`` and swept when the next manager is built.  ``save_async``
hands the host snapshot to one persistent writer thread through a bounded
queue (:attr:`CheckpointManager.MAX_PENDING`), so a training loop blocks
only on the device-to-host copy.  The serial writer keeps saves ordered,
so the LATEST pointer and the pruning stay race-free; a failed background
write is raised at the *next* ``save`` / ``save_async`` / ``wait``.

Host copies: the device-to-host copy runs on the calling thread and is a
copy (``t.detach().cpu().numpy().copy()``: on the CPU ``.numpy()`` aliases
the tensor, which the next commit could change before the writer reads
it).  The writer thread touches only NumPy.

The format is the JAX package's, in both directions.  A tree is dicts,
lists and tuples (``None`` is an empty subtree) over tensor, NumPy or
Python-number leaves.  Leaves are flattened as ``jax.tree_util.
tree_flatten`` does (dict keys sorted) and named as ``jax.tree_util.keystr``
names them (``['weights']['w_in']``, ``['a'][0]``).  The port's trees keep
insertion order, so the sort is what makes the ``leaves`` list, and the
npz entries, the same as the JAX manager writes.

Bit-exactness: leaves are stored as raw NumPy arrays (``np.savez``), so
every dtype round-trips bit for bit, including the integer-valued float32
carriers of the quantized SRAM image and the ``EpropSGD`` residuals.
NumPy has no bfloat16: a bf16 leaf is stored as the raw 2-byte ``|V2``
records the JAX manager writes for an ``ml_dtypes.bfloat16`` array (its
bits viewed through int16), and a ``|V2`` entry restores into a bf16
template leaf by the same view back.

Sharded state: a DTensor leaf is saved whole (``full_tensor()``, a
collective every rank of its mesh joins), and restores into a DTensor
template leaf placed as the template is.  A tree that holds DTensors is
written by rank 0 of the world alone: every rank calls ``save`` (the
gathers need them all), and the others drop each gathered leaf without a
host copy.
``restore`` checks every leaf's shape *and* dtype against the caller's
template and fails with a per-leaf diff.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import from_global


@dataclasses.dataclass
class ReplayCursor:
    """Durable position in a deterministic batch replay.

    ``epoch`` and ``batch`` name the *next* batch a training loop would
    consume: a loop sets ``(epoch, batch) = (e, i + 1)`` just before it
    commits batch ``i`` of epoch ``e``, so a checkpoint cut after the
    commit resumes at the first unconsumed batch.  The pipelines derive
    each epoch's order from ``(seed, epoch)`` alone
    (:mod:`repro_torch.data.pipeline`), so a replay from a cursor gives the
    batches the interrupted run would have consumed.
    """

    epoch: int = 0
    batch: int = 0

    def as_manifest(self) -> Dict[str, int]:
        return {"epoch": int(self.epoch), "batch": int(self.batch)}

    @classmethod
    def from_manifest(cls, d: Dict[str, int]) -> "ReplayCursor":
        return cls(epoch=int(d["epoch"]), batch=int(d["batch"]))


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Durability policy a training loop hands to its checkpoint hooks.

    ``every`` is the save cadence in commits (``OnlineLearner``) or steps
    (``Trainer``); ``keep <= 0`` keeps every checkpoint; ``async_save``
    selects :meth:`CheckpointManager.save_async` over the blocking
    :meth:`CheckpointManager.save`.
    """

    directory: str | Path
    every: int = 1
    keep: int = 3
    async_save: bool = True

    def manager(self) -> "CheckpointManager":
        return CheckpointManager(self.directory, keep=self.keep)


def _walk(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` in ``jax.tree_util.tree_flatten`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _map(tree: Any, fn, path: str = "") -> Any:
    """``fn(keystr, leaf)`` over every leaf; containers keep their order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


# How NumPy stores a bf16 leaf: raw 2-byte records.
BF16_RECORD = np.dtype("V2")


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a NumPy array that shares no memory with it (a bf16
    tensor as its bits in ``|V2`` records; a DTensor whole, gathered from
    its shards: every rank of its mesh takes part)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            bits = leaf.detach().cpu().view(torch.int16).numpy().copy()
            return bits.view(BF16_RECORD)
        return leaf.detach().cpu().numpy().copy()
    if isinstance(leaf, (np.ndarray, np.generic, bool, int, float)):
        return np.array(leaf)
    raise TypeError(f"unsupported checkpoint leaf {type(leaf).__name__}")


def host_tree(tree: Any) -> Any:
    """``tree`` with every leaf copied to a NumPy array."""
    return _map(tree, lambda _, leaf: _to_host(leaf))


def _host_if_writer(tree: Any) -> Optional[Any]:
    """:func:`host_tree` of ``tree`` on the process that writes it, else
    ``None``: a tree of DTensors is written by rank 0 of the world, and
    every other rank joins each leaf's gather in the same order and keeps
    nothing of it."""
    sharded = any(isinstance(leaf, DTensor) for _, leaf in _walk(tree))
    if not sharded or dist.get_rank() == 0:
        return host_tree(tree)
    _map(tree, lambda _, leaf: leaf.full_tensor() if isinstance(leaf, DTensor) else None)
    return None


def place_like(template: Any, host: Any) -> Any:
    """``host`` (a NumPy tree shaped like ``template``) back where the
    template's leaves live: a tensor leaf becomes a tensor on the
    template's device, a DTensor leaf a DTensor placed as the template's
    (each rank keeps its shards of the whole array), any other leaf stays
    a NumPy array."""
    arrays = dict(_walk(host))

    def place(key, leaf):
        if isinstance(leaf, torch.Tensor):
            arr = arrays[key]
            if leaf.dtype == torch.bfloat16 and arr.dtype == BF16_RECORD:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if isinstance(leaf, DTensor):
                return from_global(t, leaf.device_mesh, leaf.placements,
                                   leaf.to_local().device)
            return t.to(leaf.device)
        return arrays[key]

    return _map(template, place)


def _spec(leaf: Any) -> Tuple[Tuple[int, ...], np.dtype]:
    """A leaf's shape and NumPy dtype, without copying a tensor."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return tuple(leaf.shape), BF16_RECORD
        return tuple(leaf.shape), torch.empty((), dtype=leaf.dtype).numpy().dtype
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype


def _flatten(tree: Any) -> Tuple[List[str], List[Any]]:
    flat = list(_walk(tree))
    return [n for n, _ in flat], [leaf for _, leaf in flat]


def _unflatten_like(template: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Rebuild ``template``'s structure from stored arrays, checking every
    leaf's shape and dtype against the template: a mismatch fails here
    with a per-leaf diff, not later as a launch refused for its shape."""
    problems = []

    def pick(key, leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        want_shape, want_dtype = _spec(leaf)
        if tuple(arr.shape) != want_shape or arr.dtype != want_dtype:
            problems.append(
                f"  {key}: checkpoint has {arr.shape} {arr.dtype}, "
                f"template needs {want_shape} {want_dtype}")
        return arr

    out = _map(template, pick)
    if problems:
        raise ValueError("checkpoint does not match the restore template:\n"
                         + "\n".join(problems))
    return out


class CheckpointManager:
    # Backpressure bound on queued but unwritten async saves: the commit
    # loop runs at most this many checkpoints ahead of the disk before
    # save_async blocks (an unbounded queue turns a slow disk into
    # unbounded host memory).
    MAX_PENDING = 2

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._queue: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # A ``.tmp`` directory is a save whose atomic rename never ran: an
        # incomplete checkpoint, never a restore candidate.
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------- save
    def _raise_pending(self) -> None:
        """Raise a failed background write now, at the next save entry."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        """Blocking save (device-to-host copy, write, atomic rename, prune).
        Drains the queued async saves first (the serial writer owns the
        LATEST pointer) and raises their error if one failed."""
        self._raise_pending()
        self.wait()
        host = _host_if_writer(tree)
        if host is None:
            return self.dir / f"step_{step:09d}"
        return self._write(step, host, extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """The device-to-host copy runs now, the disk IO on the writer
        thread.  Blocks only when :attr:`MAX_PENDING` saves are queued; an
        earlier async save's error is raised here."""
        self._raise_pending()
        host = _host_if_writer(tree)
        if host is None:
            return
        if self._queue is None:
            self._queue = queue.Queue(maxsize=self.MAX_PENDING)
            self._writer = threading.Thread(target=self._drain, daemon=True)
            self._writer.start()
        self._queue.put((step, host, dict(extra or {})))

    def _drain(self) -> None:
        """Writer-thread loop: write every queued save in order; an error
        waits in ``_error`` for the next save or wait."""
        while True:
            step, host, extra = self._queue.get()
            try:
                self._write(step, host, extra)
            except BaseException as e:  # raised at the next save/save_async/wait
                self._error = e
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def _write(self, step: int, host_tree: Any, extra: Dict) -> Path:
        names, leaves = _flatten(host_tree)
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **dict(zip(names, leaves)))
        manifest = {"step": step, "time": time.time(), "leaves": names, **extra}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        os.replace(latest_tmp, self.dir / "LATEST")  # atomic pointer update
        self._prune()
        return final

    def _prune(self) -> None:
        if self.keep <= 0:
            return  # keep <= 0 keeps every checkpoint
        for step in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{step:09d}", ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest complete step: the LATEST pointer when it names a
        complete checkpoint, else (a stale, corrupt or missing pointer) the
        newest complete ``step_*`` directory."""
        latest = self.dir / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            if (self.dir / name / "manifest.json").exists():
                try:
                    return int(name.split("_")[1])
                except (IndexError, ValueError):
                    pass  # corrupt pointer contents: fall back to the scan
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict:
        """The manifest of checkpoint ``step``, without its arrays."""
        return json.loads((self.dir / f"step_{step:09d}" / "manifest.json").read_text())

    def restore(self, step: int, template: Any) -> Tuple[Any, Dict]:
        """Returns (NumPy tree shaped like ``template``, manifest).  Every
        leaf is checked against the template's shape and dtype; a mismatch
        raises :class:`ValueError` naming each leaf at fault."""
        manifest = self.manifest(step)
        with np.load(self.dir / f"step_{step:09d}" / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten_like(template, arrays), manifest
