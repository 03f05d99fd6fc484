"""Cue-accumulation ("binary decision navigation") dataset — §4.2
(counterpart of :mod:`repro.data.cue`; NumPy only, byte-identical buffers
for equal seeds).

The task (Bellec et al., NeurIPS'18; shipped with ReckOn's RTL testbench):
a sequence of left/right cues, then after a delay a recall cue asks which
side had the majority.  40 input neurons in 4 groups of 10 — [left cues |
right cues | recall cue | background noise]; each of the 7 cues activates
its side's group for ``cue_ticks`` ticks at rate ``p_active``, the noise
group fires at ``p_noise`` throughout, and supervision (TARGET_VALID) is
asserted during the recall window.  Labels: 0 = left majority, 1 = right.
Samples are AER event buffers (:func:`repro_torch.core.aer.encode_sample`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import aer
from repro_torch.data import pipeline


@dataclasses.dataclass(frozen=True)
class CueConfig:
    num_cues: int = 7
    cue_ticks: int = 10
    gap_ticks: int = 6
    delay_ticks: int = 10
    recall_ticks: int = 20
    p_active: float = 0.4     # firing prob/tick inside an active cue group
    p_noise: float = 0.05     # background group rate
    p_recall: float = 0.4
    group: int = 10           # neurons per group
    seed: int = 0

    @property
    def n_in(self) -> int:
        return 4 * self.group

    @property
    def num_ticks(self) -> int:
        t = self.num_cues * (self.cue_ticks + self.gap_ticks)
        return t + self.delay_ticks + self.recall_ticks

    @property
    def recall_start(self) -> int:
        return self.num_cues * (self.cue_ticks + self.gap_ticks) + self.delay_ticks


def _make_sample(rng: np.random.Generator, cfg: CueConfig
                 ) -> Tuple[np.ndarray, int, int, int]:
    T, G = cfg.num_ticks, cfg.group
    raster = np.zeros((T, cfg.n_in), np.float32)
    sides = rng.integers(0, 2, size=cfg.num_cues)          # 0=left, 1=right
    label = int(sides.sum() * 2 > cfg.num_cues)            # majority side
    for i, side in enumerate(sides):
        t0 = i * (cfg.cue_ticks + cfg.gap_ticks)
        block = rng.random((cfg.cue_ticks, G)) < cfg.p_active
        raster[t0: t0 + cfg.cue_ticks, side * G: (side + 1) * G] = block
    r0 = cfg.recall_start
    raster[r0: r0 + cfg.recall_ticks, 2 * G: 3 * G] = (
        rng.random((cfg.recall_ticks, G)) < cfg.p_recall
    )
    raster[:, 3 * G:] = rng.random((T, G)) < cfg.p_noise
    return raster, label, r0, T - 1      # supervision from recall on


def make_cue_dataset(
    n_train: int = 50, n_val: int = 50, n_test: int = 0, cfg: CueConfig = CueConfig()
) -> Dict[str, Dict[str, np.ndarray]]:
    """The paper's 50-sample train/validation sets as AER buffers:
    ``{split: {"events": (S, L) uint32, "n_in", "num_ticks",
    "event_density"}}``."""
    rng = np.random.default_rng(cfg.seed)
    sizes = {"train": n_train, "val": n_val, "test": n_test}
    max_len = 0
    buffers_by_split = {}
    for split, n in sizes.items():
        if n == 0:
            continue
        buffers = []
        for _ in range(n):
            raster, label, label_tick, end_tick = _make_sample(rng, cfg)
            buffers.append(aer.encode_sample(raster, label, label_tick, end_tick))
        buffers_by_split[split] = buffers
        max_len = max(max_len, max(len(b) for b in buffers))
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for split, buffers in buffers_by_split.items():
        out[split] = {
            "events": aer.pad_events(buffers, max_len),
            "n_in": cfg.n_in,
            "num_ticks": cfg.num_ticks,
        }
        out[split]["event_density"] = pipeline.event_density(out[split])
    return out
