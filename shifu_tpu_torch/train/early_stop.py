"""Boosted-tree early stop — the port's copy of
``shifu_tpu.train.early_stop.GBTEarlyStopDecider`` (reference
``dt/DTEarlyStopDecider.java``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
