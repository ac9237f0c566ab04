"""Scorer — the port of ``shifu_tpu.eval.scorer`` for tree ensembles.

Batched over rows x models like the reference (``core/Scorer.java:53``);
the per-model scores are scaled by ``SCORE_SCALE`` and aggregated per row.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..models import load_any

SCORE_SCALE = 1000.0  # reference scales [0,1] raw scores by 1000


def discover_model_paths(models_dir: str) -> List[str]:
    """model* files in NUMERIC member order (model2 before model10)."""
    def index_key(p: str) -> tuple:
        stem = os.path.splitext(os.path.basename(p))[0]
        digits = "".join(ch for ch in stem if ch.isdigit())
        return (int(digits) if digits else 0, p)

    return sorted((p for p in glob.glob(os.path.join(models_dir, "model*.*"))
                   if not p.endswith(".json")),  # convert sidecars
                  key=index_key)


def load_models(models_dir: str) -> List:
    """Every model file of a models dir, in member order (host arrays)."""
    models = [load_any(p) for p in discover_model_paths(models_dir)]
    if not models:
        raise FileNotFoundError(f"no model files in {models_dir} — run "
                                "`train`")
    return models


@dataclass
class CaseScoreResult:
    """Per-row aggregate + per-model scores (already scaled)."""
    scores: np.ndarray       # [n, models] scaled
    mean: np.ndarray         # [n]
    max: np.ndarray
    min: np.ndarray
    median: np.ndarray


class Scorer:
    """Multi-model batch scorer over binned rows (tree ensembles)."""

    def __init__(self, models: Sequence, scale: float = SCORE_SCALE,
                 device=None):
        if not models:
            raise ValueError("no models to score with")
        self.models = list(models)
        self.scale = scale
        self.device = resolve_device(device)

    @classmethod
    def from_dir(cls, models_dir: str, scale: float = SCORE_SCALE,
                 device=None) -> "Scorer":
        return cls(load_models(models_dir), scale, device=device)

    def score(self, x: Optional[np.ndarray],
              bins: np.ndarray) -> CaseScoreResult:
        """Tree models consume the binned matrix; ``x`` is unused until
        models that read normalized floats are ported."""
        cols = [m.compute(bins, device=self.device)[:, 0]
                for m in self.models]
        raw = np.stack(cols, axis=1) * np.float32(self.scale)
        return CaseScoreResult(scores=raw, mean=raw.mean(axis=1),
                               max=raw.max(axis=1), min=raw.min(axis=1),
                               median=np.median(raw, axis=1))
