"""Quickstart on the PyTorch/CUDA port (the counterpart of
``quickstart.py``): train ReckOn's RSNN with e-prop on cue accumulation
(§4.2).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions (under a minute).
"""

import argparse

from repro_torch.core.controller import ControllerConfig, EpochLog, OnlineLearner
from repro_torch.core.rsnn import Presets
from repro_torch.data.cue import CueConfig, make_cue_dataset
from repro_torch.data.pipeline import make_pipeline
from repro_torch.optim.eprop_opt import EpropSGDConfig


def run(device: str = "cuda", n_train: int = 50, n_val: int = 50,
        epochs: int = 10) -> EpochLog:
    """Train ``epochs`` END_S epochs on ``n_train`` cue samples, validating
    on ``n_val`` after each; returns the learner's log."""
    ccfg = CueConfig()
    data = make_cue_dataset(n_train=n_train, n_val=n_val, cfg=ccfg)

    # X-HEEP mode: the whole (AER-encoded) dataset lives on the device,
    # like the BRAM-resident datasets of the paper's first SoC.
    pipe = make_pipeline("xheep", data, device=device)

    cfg = Presets.cue_accumulation(num_ticks=ccfg.num_ticks)
    learner = OnlineLearner(
        cfg,
        ControllerConfig(num_epochs=epochs),
        EpropSGDConfig(lr=0.01, clip=10.0),
        0, device=device,
    )
    return learner.fit(pipe, verbose=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    log = run(opts.device)
    print(f"\nfinal validation accuracy: {log.val_acc[-1]:.1%} "
          f"(paper: 96.8%/96.4%, silicon: 96.4%)")


if __name__ == "__main__":
    main()
