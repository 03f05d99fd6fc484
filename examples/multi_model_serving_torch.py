"""Two SRAM programs, one card: multi-model serving while one model learns,
on the PyTorch/CUDA port (the counterpart of ``multi_model_serving.py``).

The paper's SoC is runtime-reprogrammable: the host reloads ReckOn's weight
SRAM over SPI, so the same accelerator runs the Braille classifier and the
cue-accumulation task as two programs.  This demo is that scenario at
service scale:

1. trains a Braille classifier and registers it (frozen) in a
   :class:`~repro_torch.serve.registry.ModelRegistry`;
2. attaches a cue-accumulation :class:`~repro_torch.core.controller.
   OnlineLearner` to the *same* registry (``registry=``/``model_id=``: the
   learner's backend joins the registry's pool and the learner publishes
   its live weights after every END_B commit, the SPI weight reload,
   mid-serve);
3. serves **mixed Braille + cue traffic through one**
   :class:`~repro_torch.serve.BatchedEngine` while the cue model keeps
   training: every request routed by ``model_id``, every tile one model's,
   each hot-swap a new image for the next tile (the kernels take the
   weights as arguments: nothing is rebuilt but the datapath weights).

    PYTHONPATH=src python examples/multi_model_serving_torch.py \
        [--braille-epochs 20] [--cue-epochs 4] [--batch 16] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

from repro_torch.configs import reckon_cue
from repro_torch.core.controller import ControllerConfig, OnlineLearner
from repro_torch.core.rsnn import Presets
from repro_torch.data.braille import SUBSETS, make_braille_dataset
from repro_torch.data.cue import CueConfig, make_cue_dataset
from repro_torch.data.pipeline import EventStream, make_pipeline
from repro_torch.optim.eprop_opt import EpropSGDConfig
from repro_torch.serve import BatchedEngine, ModelRegistry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--braille-epochs", type=int, default=20)
    ap.add_argument("--cue-epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    reg = ModelRegistry()

    # --- program 1: Braille, trained then frozen ---------------------------
    b_data = make_braille_dataset("AEU")
    b_cfg = Presets.braille(n_classes=len(SUBSETS["AEU"]),
                            num_ticks=b_data["train"]["num_ticks"])
    b_learner = OnlineLearner(
        b_cfg, ControllerConfig(num_epochs=opts.braille_epochs),
        EpropSGDConfig(lr=0.01, clip=10.0), 1, device=opts.device,
    )
    b_pipe = make_pipeline("arm", b_data, samples_per_batch=70, device=opts.device)
    for ep in range(opts.braille_epochs):
        b_learner.train_epoch(b_pipe, ep)
    reg.register("braille", b_cfg, b_learner.inference_params(),
                 backend=b_learner.backend)
    print(f"registered 'braille' (frozen, {opts.braille_epochs} epochs)")

    # --- program 2: cue accumulation, learning *while* serving -------------
    ccfg = CueConfig()
    c_data = make_cue_dataset(50, 50, cfg=ccfg)
    c_cfg = reckon_cue.config_for(num_ticks=ccfg.num_ticks)
    c_learner = OnlineLearner(
        c_cfg,
        ControllerConfig(num_epochs=opts.cue_epochs, commit="batch"),
        EpropSGDConfig(lr=0.01, clip=10.0), 2, device=opts.device,
        registry=reg, model_id="cue",      # <- registered, auto-publishing
    )
    c_pipe = make_pipeline("arm", c_data, samples_per_batch=10, device=opts.device)
    print(f"registered 'cue' (live) — models: {reg.ids()}")

    # --- one engine, both models -------------------------------------------
    engine = BatchedEngine(registry=reg, device=opts.device, max_batch=opts.batch)

    def mixed_stream():
        """Alternate Braille and cue requests: worst-case interleaving."""
        streams = [
            ("braille", iter(EventStream(b_data, "test", shuffle=True))),
            ("cue", iter(EventStream(c_data, "val", shuffle=True))),
        ]
        while streams:
            for mid, it in list(streams):
                ev = next(it, None)
                if ev is None:
                    streams.remove((mid, it))
                else:
                    yield ev, mid

    swaps0 = reg.get("cue").swaps
    for ep in range(opts.cue_epochs):
        # train one cue epoch: every END_B commit hot-swaps the registry
        # image the engine serves from its next tile
        tr = c_learner.train_epoch(c_pipe, ep)
        results, stats = engine.serve(mixed_stream())
        acc = {
            mid: [int(r.pred == r.label) for r in results if r.model_id == mid]
            for mid in reg.ids()
        }
        line = "  ".join(
            f"{mid}: {sum(v) / max(len(v), 1):.1%} ({len(v)} reqs)"
            for mid, v in acc.items()
        )
        print(f"epoch {ep}: cue train={tr:.3f} | served {line} "
              f"[{stats.batches} tiles, {stats.rebuilds} weight derivations]")
        if stats.per_model:
            for mid, s in stats.per_model.items():
                print(f"    {mid:8s} {s.samples_per_sec:8.0f} samples/s  "
                      f"p99 {s.p99_latency_s * 1e3:.2f} ms")

    print(f"\ncue hot-swaps while serving: {reg.get('cue').swaps - swaps0} "
          f"(backends in the registry's pool: {len(reg.pool)})")
    print("one engine, two SRAM programs — the paper's runtime "
          "reprogrammability at service scale")


if __name__ == "__main__":
    main()
