"""Stateful streaming sessions on the PyTorch/CUDA port (the counterpart
of ``streaming_sessions.py``): the neuromorphic edge scenario end to end.

The paper's headline deployment is an unbounded per-user AER event stream
classified *online*: recurrent state persists between event bursts, and
nothing ever arrives as a whole padded sample.  This demo drives that path:

1. trains ReckOn on Braille with online e-prop (briefly),
2. opens one session per simulated user (``engine.open_session()``),
3. replays each user's AER words in small interleaved bursts
   (``handle.feed`` + ``engine.pump()``: the engine continuously batches
   whichever sessions have processable ticks into shared tick-tiles for
   the ``rsnn_step_sessions`` kernel, with every session's membrane and
   trace state resident in the device session pool, LRU-evicted under
   capacity pressure),
4. polls incremental classifications mid-stream (``handle.poll()``), and
5. closes each stream for its final result (``handle.result()``).

    PYTHONPATH=src python examples/streaming_sessions_torch.py \
        [--classes AEU|SAEU|AEOU] [--epochs 12] [--users 64] [--bursts 6] \
        [--tick-tile 16] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

import numpy as np

from repro_torch.core import aer
from repro_torch.core.controller import ControllerConfig, OnlineLearner
from repro_torch.core.rsnn import Presets
from repro_torch.data.braille import SUBSETS, make_braille_dataset
from repro_torch.data.pipeline import EventStream, make_pipeline
from repro_torch.optim.eprop_opt import EpropSGDConfig
from repro_torch.serve import BatchedEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", default="AEU", choices=list(SUBSETS))
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--users", type=int, default=64)
    ap.add_argument("--bursts", type=int, default=6,
                    help="feed each user's stream in this many increments")
    ap.add_argument("--tick-tile", type=int, default=16,
                    help="fixed tick length of streaming tiles "
                         "(latency-bounded mode)")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    data = make_braille_dataset(opts.classes)

    # --- train (ARM mode, online e-prop) -----------------------------------
    cfg = Presets.braille(n_classes=len(SUBSETS[opts.classes]),
                          num_ticks=data["train"]["num_ticks"])
    pipe = make_pipeline("arm", data, samples_per_batch=70, prefetch=2,
                         device=opts.device)
    learner = OnlineLearner(
        cfg, ControllerConfig(num_epochs=opts.epochs, eval_every=5),
        EpropSGDConfig(lr=0.01, clip=10.0), 1, device=opts.device,
    )
    for ep in range(opts.epochs):
        learner.train_epoch(pipe, ep)

    # --- stream ------------------------------------------------------------
    # Shares the learner's ExecutionBackend: update_weights would hot-swap
    # the image mid-stream if training continued, building nothing new.
    engine = BatchedEngine.from_learner(
        learner, max_batch=32, tick_tile=opts.tick_tile
    )
    test = list(EventStream(data, "test", repeat=8, shuffle=True, seed=0))
    users = []
    for i in range(opts.users):
        ev = np.asarray(test[i % len(test)], np.uint32)
        users.append(ev[np.argsort(ev & aer.MAX_TICK, kind="stable")])
    cuts = [np.linspace(0, len(ev), opts.bursts + 1).astype(int)
            for ev in users]

    handles = [engine.open_session(meta={"user": i})
               for i in range(opts.users)]
    for b in range(opts.bursts):
        for h, ev, c in zip(handles, users, cuts):
            h.feed(ev[c[b]:c[b + 1]])
        engine.pump()
        snap = handles[0].poll()
        if snap is not None:
            print(f"burst {b + 1}/{opts.bursts}: user 0 @ tick {snap.ticks:3d} "
                  f"-> class {snap.pred} (label {snap.label})")
    engine.pump(drain=True)

    correct = 0
    for h in handles:
        final = h.result()
        correct += int(final.pred == final.label)
    stats = engine.stream_stats(wall_s=1.0)   # counters only, not a bench
    print(f"\n{opts.users} sessions closed: "
          f"accuracy {correct}/{opts.users} "
          f"({100.0 * correct / opts.users:.1f}%)")
    print(f"tiles={stats.tiles}  mean lanes={stats.mean_lanes:.1f}  "
          f"evictions={stats.evictions}  "
          f"weight derivations={stats.rebuilds}")


if __name__ == "__main__":
    main()
