"""Early stop — the port's copy of ``shifu_tpu.train.early_stop``'s
``WindowEarlyStop`` (the NN trainers' validation window) and
``GBTEarlyStopDecider`` (reference ``dt/DTEarlyStopDecider.java``)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass
class WindowEarlyStop:
    """Stop when the validation error has not improved for
    ``window_size`` consecutive epochs."""
    window_size: int = 10
    best: float = math.inf
    since_best: int = 0

    def should_stop(self, valid_error: float) -> bool:
        if valid_error < self.best - 1e-12:
            self.best = valid_error
            self.since_best = 0
        else:
            self.since_best += 1
        return self.since_best >= self.window_size


@dataclass
class GBTEarlyStopDecider:
    """Moving-average + trend halt: stop when the smoothed validation
    error has been rising for ``patience`` consecutive trees."""
    window: int = 5
    patience: int = 3
    history: List[float] = field(default_factory=list)
    rising: int = 0

    def add(self, valid_error: float) -> bool:
        self.history.append(valid_error)
        if len(self.history) < 2 * self.window:
            return False
        cur = sum(self.history[-self.window:]) / self.window
        prev = sum(self.history[-2 * self.window:-self.window]) / self.window
        self.rising = self.rising + 1 if cur > prev else 0
        return self.rising >= self.patience
