"""Braille-digit dataset — §4.3 of the paper (counterpart of
:mod:`repro.data.braille`; NumPy only, byte-identical buffers for equal
seeds).

The real benchmark (Müller-Cleve et al. 2022) slides a sensorised fingertip
with 12 capacitive taxels over embossed Braille characters and encodes the
capacitance changes as spikes; the paper trains ReckOn on subsets
{A,E,U}, {Space,A,E,U}, {A,E,O,U} of the 7-class NIR split.

The recordings are not redistributable offline, so this module:

* loads the real data if the user drops ``braille.npz`` (keys
  ``events/labels/names``) into ``data/braille/``;
* otherwise generates a **calibrated synthetic surrogate**: each character
  is its Braille dot matrix (2 cols × 3 rows); sliding contact turns every
  dot into a spatio-temporal Gaussian activation bump over a 4×3 taxel
  grid (12 sensors), with per-sample jitter in onset, speed, amplitude and
  background noise; spikes are Bernoulli-coded per tick.  The row-blur
  constant ``sigma_row`` is set so the single-dot difference between O
  (dot 1-3-5) and U (dot 1-3-6) lands in the confusable regime — matching
  the paper's difficulty ordering: 3-class ≈ 90% test ≫ 4-class(+Space)
  ≈ 79% ≫ 4-class(A,E,O,U) ≈ 60%.

Samples are emitted as bit-faithful AER buffers like every other dataset.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import aer
from repro_torch.data import pipeline

# Braille dot matrices: dot numbering (col, row): 1=(0,0) 2=(0,1) 3=(0,2)
#                                                 4=(1,0) 5=(1,1) 6=(1,2)
DOTS = {
    "A": [(0, 0)],                          # dot 1
    "E": [(0, 0), (1, 1)],                  # dots 1,5
    "I": [(0, 1), (1, 0)],                  # dots 2,4
    "O": [(0, 0), (0, 2), (1, 1)],          # dots 1,3,5
    "U": [(0, 0), (0, 2), (1, 2)],          # dots 1,3,6
    "Y": [(0, 0), (0, 2), (1, 0), (1, 2)],  # dots 1,3,4,6
    "Space": [],
}

SUBSETS = {
    "AEU": ["A", "E", "U"],
    "SAEU": ["Space", "A", "E", "U"],
    "AEOU": ["A", "E", "O", "U"],
}


@dataclasses.dataclass(frozen=True)
class BrailleConfig:
    num_ticks: int = 128
    n_sensor_cols: int = 4
    n_sensor_rows: int = 3          # 4×3 = 12 taxels
    amplitude: float = 0.55         # peak spike prob at perfect alignment
    sigma_t: float = 6.0            # temporal bump width (ticks)
    sigma_row: float = 1.05         # row blur — the O/U confusability dial
    p_noise: float = 0.045
    onset_jitter: float = 9.0
    speed_jitter: float = 0.12
    amp_jitter: float = 0.28
    space_texture: float = 0.35     # faint pseudo-dot amplitude for Space
                                    # (paper-texture drag — makes Space/A
                                    # confusable like the real recordings)
    samples_per_class: int = 200
    seed: int = 7

    @property
    def n_in(self) -> int:
        return self.n_sensor_cols * self.n_sensor_rows


def _sample_profile(rng: np.random.Generator, letter: str, cfg: BrailleConfig) -> np.ndarray:
    """Per-(tick, sensor) spike probabilities for one slide."""
    T = cfg.num_ticks
    p = np.full((T, cfg.n_sensor_rows, cfg.n_sensor_cols), cfg.p_noise)
    onset = T * 0.15 + rng.normal(0.0, cfg.onset_jitter)
    speed = (T * 0.55 / 2.0) * (1.0 + rng.normal(0.0, cfg.speed_jitter))
    amp = cfg.amplitude * (1.0 + rng.normal(0.0, cfg.amp_jitter))
    t = np.arange(T)[:, None, None]
    rows = np.arange(cfg.n_sensor_rows)[None, :, None]
    cols = np.arange(cfg.n_sensor_cols)[None, None, :]
    dots = list(DOTS[letter])
    weights = [1.0] * len(dots)
    if letter == "Space" and cfg.space_texture > 0:
        # surface-texture drag: a couple of faint pseudo-dots per slide
        for _ in range(int(rng.integers(1, 3))):
            dots.append((int(rng.integers(0, 2)), int(rng.integers(0, 3))))
            weights.append(cfg.space_texture)
    for (dcol, drow), w in zip(dots, weights):
        # dot passes sensor column sc at onset + (dcol + sc*0.35)·speed
        t_pass = onset + (dcol + 0.35 * cols) * speed
        bump = np.exp(-0.5 * ((t - t_pass) / cfg.sigma_t) ** 2)
        align = np.exp(-0.5 * ((rows - drow) / cfg.sigma_row) ** 2)
        p = p + w * amp * bump * align
    return np.clip(p.reshape(T, -1), 0.0, 0.95)


def _real_path() -> Path:
    return Path(__file__).resolve().parents[3] / "data" / "braille" / "braille.npz"


def make_braille_dataset(
    subset: str = "AEU",
    cfg: BrailleConfig = BrailleConfig(),
    splits: Sequence[float] = (0.7, 0.2, 0.1),
) -> Dict[str, Dict[str, np.ndarray]]:
    """Returns {"train"/"val"/"test": {"events", "n_in", "num_ticks"}}.

    Split ratios follow the NIR protocol (980/280/140 of 1400 = 70/20/10).
    """
    classes = SUBSETS[subset] if subset in SUBSETS else list(subset)
    rng = np.random.default_rng(cfg.seed)
    real = _real_path()
    per_class: Dict[str, List[np.ndarray]] = {}
    if real.exists():
        with np.load(real, allow_pickle=True) as z:
            names = [str(n) for n in z["names"]]
            for c in classes:
                idx = [i for i, n in enumerate(names) if n == c]
                per_class[c] = [z["events"][i] for i in idx]
        source = "real"
    else:
        for c in classes:
            rasters = [
                (rng.random((cfg.num_ticks, cfg.n_in)) < _sample_profile(rng, c, cfg))
                .astype(np.float32)
                for _ in range(cfg.samples_per_class)
            ]
            per_class[c] = rasters
        source = "synthetic"

    buffers, labels = [], []
    for li, c in enumerate(classes):
        for raster in per_class[c]:
            buffers.append(
                aer.encode_sample(raster, li, label_tick=int(cfg.num_ticks * 0.3),
                                  end_tick=cfg.num_ticks - 1)
            )
            labels.append(li)
    order = rng.permutation(len(buffers))
    buffers = [buffers[i] for i in order]

    n = len(buffers)
    n_tr = int(splits[0] * n)
    n_va = int(splits[1] * n)
    max_len = max(len(b) for b in buffers)
    chunks = {
        "train": buffers[:n_tr],
        "val": buffers[n_tr : n_tr + n_va],
        "test": buffers[n_tr + n_va :],
    }
    out = {}
    for split, bufs in chunks.items():
        out[split] = {
            "events": aer.pad_events(bufs, max_len),
            "n_in": cfg.n_in,
            "num_ticks": cfg.num_ticks,
            "source": source,
            "classes": classes,
        }
        # measured per-channel event density — what the traffic gates and
        # the backend's dense/event dispatch consume (grounds the paper's
        # "~2-5% on Braille" figure instead of assuming it)
        out[split]["event_density"] = pipeline.event_density(out[split])
    return out

