"""Validation split as a seeded mask — the port's copy of
``shifu_tpu.train.sampling.validation_split`` (numpy's generator, so both
packages draw the same rows)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def validation_split(n: int, valid_rate: float, seed: int = 0,
                     stratified: bool = False,
                     targets: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean mask, True = validation row.  Stratified keeps the pos/neg
    ratio in both splits (reference stratified sampling path)."""
    rng = np.random.default_rng(seed)
    if not stratified or targets is None:
        return rng.random(n) < valid_rate
    mask = np.zeros(n, dtype=bool)
    for cls in np.unique(targets):
        idx = np.flatnonzero(targets == cls)
        k = int(round(len(idx) * valid_rate))
        mask[rng.choice(idx, size=k, replace=False)] = True
    return mask
