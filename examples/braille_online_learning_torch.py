"""Braille digit classification with on-line e-prop learning (§4.3) on the
PyTorch/CUDA port (the counterpart of ``braille_online_learning.py``).

Mirrors the paper's ARM-mode SoC: the dataset lives host-side; batches of
samples are offloaded to a device buffer (the shared BRAM) with prefetch;
the learner trains on each sample as it streams through.  ``--commit
sample`` (default) updates the weights at every end-of-sample, true online
learning (``rsnn_train`` at B=1 a sample); ``--commit batch`` runs each
offloaded batch as one tile through the ``rsnn_train`` kernel and commits
the summed update at the END_B boundary.

    PYTHONPATH=src python examples/braille_online_learning_torch.py \
        [--classes AEU|SAEU|AEOU] [--epochs 50] [--commit sample|batch] \
        [--quant] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

from repro_torch.core.controller import ControllerConfig, OnlineLearner
from repro_torch.core.quant import WEIGHT_SPEC
from repro_torch.core.rsnn import Presets
from repro_torch.data.braille import SUBSETS, make_braille_dataset
from repro_torch.data.pipeline import make_pipeline
from repro_torch.optim.eprop_opt import EpropSGDConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", default="AEU", choices=list(SUBSETS))
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--commit", default="sample", choices=["sample", "batch"],
                    help="END_S per-sample commit (chip-faithful) or END_B "
                         "batch commit (one tile per offloaded batch)")
    ap.add_argument("--quant", action="store_true",
                    help="8-bit weight grid with accumulate-then-round commits "
                         "(the chip's weight-SRAM behaviour)")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    data = make_braille_dataset(opts.classes)
    print(f"dataset source: {data['train']['source']} "
          f"({data['train']['events'].shape[0]} train samples)")

    # ARM mode: batched offload through a BRAM-sized device buffer.
    pipe = make_pipeline("arm", data, samples_per_batch=70, prefetch=2,
                         device=opts.device)

    cfg = Presets.braille(n_classes=len(SUBSETS[opts.classes]),
                          num_ticks=data["train"]["num_ticks"])
    opt_cfg = EpropSGDConfig(
        # batch commits take a tuned 2x lr
        lr=0.01 if opts.commit == "sample" else 0.02, clip=10.0,
        quant=WEIGHT_SPEC if opts.quant else None,
        stochastic_round=opts.quant,
    )
    learner = OnlineLearner(
        cfg, ControllerConfig(num_epochs=opts.epochs, eval_every=5,
                              commit=opts.commit),
        opt_cfg, 1, device=opts.device,
    )
    for ep in range(opts.epochs):
        tr = learner.train_epoch(pipe, ep)
        if (ep + 1) % 5 == 0:
            va = learner.eval_epoch(pipe, ep)
            print(f"epoch {ep:3d}  train={tr:.3f}  val={va:.3f}", flush=True)
    test = learner.eval_epoch(pipe, 0, split="test")
    print(f"\n{opts.classes} test accuracy: {test:.1%} "
          f"(paper: AEU 90%, SAEU 78.8%, AEOU 60%)")


if __name__ == "__main__":
    main()
