"""Telemetry of the training loops (counterpart of
:mod:`repro.train.metrics`, the same arithmetic): the port's analog of the
paper's ILA debug unit.

Each step's scalars are folded into a host-side ring buffer, kept for the
straggler watchdog and the non-finite-step check, and optionally appended
to a JSON-lines log.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StepStats:
    step: int
    wall_s: float
    metrics: Dict[str, float]


class MetricsLogger:
    def __init__(self, log_file: Optional[str] = None, window: int = 256):
        self.history: Deque[StepStats] = deque(maxlen=window)
        self.log_file = Path(log_file) if log_file else None
        self._fh = self.log_file.open("a") if self.log_file else None

    def log(self, step: int, wall_s: float, metrics: Dict) -> StepStats:
        flat = {k: float(v) for k, v in metrics.items()}
        st = StepStats(step, wall_s, flat)
        self.history.append(st)
        if self._fh:
            self._fh.write(json.dumps({"step": step, "wall_s": wall_s, **flat}) + "\n")
            self._fh.flush()
        return st

    def close(self):
        if self._fh:
            self._fh.close()


class StragglerWatchdog:
    """Per-step wall-clock EWMA; flags steps slower than ``k``·σ (and 5%
    over the mean) once ``warmup`` steps have been seen."""

    def __init__(self, k: float = 4.0, alpha: float = 0.05, warmup: int = 8):
        self.k, self.alpha, self.warmup = k, alpha, warmup
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0
        self.flagged: List[int] = []

    def observe(self, step: int, wall_s: float) -> bool:
        self.n += 1
        if self.mean is None:
            self.mean = wall_s
            return False
        delta = wall_s - self.mean
        slow = (
            self.n > self.warmup
            and delta > self.k * math.sqrt(self.var + 1e-12)
            and delta > 0.05 * self.mean
        )
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        if slow:
            self.flagged.append(step)
        return slow


def finite(x: float) -> bool:
    return math.isfinite(x)
