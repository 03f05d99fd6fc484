"""Train-then-serve Braille demo on the PyTorch/CUDA port (the counterpart
of ``serve_braille.py``): the ARM-mode SoC as an inference service.

Trains ReckOn on the Braille task with online e-prop, END_B commits through
the ``rsnn_train`` kernel; the learner is attached to a ``ModelRegistry``
and publishes its weights after every commit.  A hardened
``BatchedEngine`` on that registry serves a ragged AER request stream
(``EventStream``) and reports accuracy, throughput and latency
percentiles.  Then one more epoch interleaves commits with requests
(``interleave_train_serve``): each commit is published and the next tile
serves it, the paper's learning-while-serving experiment.

    PYTHONPATH=src python examples/serve_braille_torch.py \
        [--classes AEU|SAEU|AEOU] [--epochs 20] [--batch 32] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

from repro_torch.core.controller import ControllerConfig, OnlineLearner
from repro_torch.core.rsnn import Presets
from repro_torch.data.braille import SUBSETS, make_braille_dataset
from repro_torch.data.pipeline import EventStream, interleave_train_serve, make_pipeline
from repro_torch.optim.eprop_opt import EpropSGDConfig
from repro_torch.serve import BatchedEngine, GuardConfig, ModelRegistry, ServeStatus


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", default="AEU", choices=list(SUBSETS))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    data = make_braille_dataset(opts.classes)
    print(f"dataset source: {data['train']['source']} "
          f"({data['train']['events'].shape[0]} train samples)")

    # --- train (ARM mode, END_B e-prop), publishing every commit -----------
    cfg = Presets.braille(n_classes=len(SUBSETS[opts.classes]),
                          num_ticks=data["train"]["num_ticks"])
    pipe = make_pipeline("arm", data, samples_per_batch=70, prefetch=2,
                         device=opts.device)
    registry = ModelRegistry()
    learner = OnlineLearner(
        cfg, ControllerConfig(num_epochs=opts.epochs, eval_every=5, commit="batch"),
        EpropSGDConfig(lr=0.01, clip=10.0), 1, device=opts.device,
        registry=registry, model_id="braille",
    )
    for ep in range(opts.epochs):
        tr = learner.train_epoch(pipe, ep)
        if (ep + 1) % 5 == 0:
            print(f"epoch {ep:3d}  train={tr:.3f}", flush=True)

    # --- serve the published image ------------------------------------------
    engine = BatchedEngine(registry=registry, device=opts.device,
                           max_batch=opts.batch, guard=GuardConfig())
    engine.warmup(data["test"]["num_ticks"], opts.batch)
    stream = EventStream(data, "test", repeat=4, shuffle=True, seed=0)
    results, stats = engine.serve(iter(stream))
    correct = sum(int(r.pred == r.label) for r in results)
    print(f"\nserved {stats.requests} requests in {stats.wall_s * 1e3:.1f} ms "
          f"({stats.samples_per_sec:.0f} samples/s, {stats.batches} tiles, "
          f"mean batch {stats.mean_batch:.1f}, {stats.rejected} rejected)")
    print(f"latency: p50={stats.p50_latency_s * 1e3:.2f} ms  "
          f"p99={stats.p99_latency_s * 1e3:.2f} ms")
    print(f"serving accuracy: {correct / max(stats.requests, 1):.1%} "
          f"(paper: AEU 90%, SAEU 78.8%, AEOU 60%)")

    # --- learning while serving: each commit published, served next tile ---
    spec = registry.get("braille")
    swaps = spec.swaps
    results2 = []
    for kind, item in interleave_train_serve(
        pipe, EventStream(data, "test"), epoch=opts.epochs, serve_per_batch=16
    ):
        if kind == "train":
            learner.train_batch(item)     # publishes into the registry
        else:
            engine.submit(item)
            for tile in engine.scheduler.ready_tiles():
                results2.extend(engine.run_tile(tile))
    for tile in engine.scheduler.drain():
        results2.extend(engine.run_tile(tile))
    results2.extend(engine.take_dead_results())
    ok = [r for r in results2 if r.status is ServeStatus.OK]
    correct2 = sum(int(r.pred == r.label) for r in ok)
    print(f"interleaved train+serve epoch ({spec.swaps - swaps} publishes, one "
          f"shared backend): {len(ok)}/{len(results2)} answered OK, accuracy "
          f"{correct2 / max(len(ok), 1):.1%}")


if __name__ == "__main__":
    main()
