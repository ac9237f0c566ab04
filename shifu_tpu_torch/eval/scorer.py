"""Scorer + ModelRunner — the port of ``shifu_tpu.eval.scorer`` for tree
ensembles (reference ``core/Scorer.java:53``, ``core/ModelRunner.java:54``).

Batched over rows x models like the reference: the bins go to the scoring
device once a batch, in the narrowest dtype the ensemble admits (uint8
when every forest has <= 256 bins), and each forest walks them with
``ops/tree_quant.predict_forest_quant`` — the ``tree_traverse`` kernel on
a CUDA device (it launches or raises), its plain version on the CPU.  The
per-model scores are scaled by ``SCORE_SCALE`` and aggregated per row.
Multi-class sets score with :meth:`Scorer.score_classes`: native forests
contribute their class-distribution rows (B4's node-index walk on the
card), one-vs-all members their ``class_index`` column, each model one
launch a batch as on the binary path.  NN/LR/WDL/SVM model files raise in
``models.load_any``.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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

    def select(self, selector: str) -> np.ndarray:
        s = (selector or "mean").lower()
        if s in ("mean", "avg"):
            return self.mean
        if s == "max":
            return self.max
        if s == "min":
            return self.min
        if s == "median":
            return self.median
        if s.startswith("model"):
            return self.scores[:, int(s[5:])]
        raise ValueError(f"unknown score selector {selector!r}")


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
        """Tree models consume the binned matrix, which goes to the device
        once in the ensemble's wire dtype (the reference's
        ``ensemble_bins_dtype``); ``x`` is unused until models that read
        normalized floats are ported."""
        b = self._put(bins)
        cols = [m.compute(b)[:, 0] for m in self.models]
        raw = np.stack(cols, axis=1) * np.float32(self.scale)
        return CaseScoreResult(scores=raw, mean=raw.mean(axis=1),
                               max=raw.max(axis=1), min=raw.min(axis=1),
                               median=np.median(raw, axis=1))

    def _put(self, bins: np.ndarray) -> torch.Tensor:
        """The binned batch on the scoring device, once, in the ensemble's
        wire dtype (the reference's ``ensemble_bins_dtype``)."""
        from ..ops.tree_quant import ensemble_bins_dtype
        return torch.from_numpy(np.ascontiguousarray(bins)).to(
            self.device, ensemble_bins_dtype(self.models))

    # ------------------------------------------------------- multi-class
    def n_classes(self) -> int:
        """K from any model's spec extra (``n_classes`` is stamped by both
        the native and the one-vs-all training paths); 0 = binary."""
        for m in self.models:
            k = (getattr(m.spec, "extra", None) or {}).get("n_classes")
            if k:
                return int(k)
        return 0

    def score_classes(self, x: Optional[np.ndarray],
                      bins: np.ndarray) -> np.ndarray:
        """[n, K] class scores (reference ``Scorer.score_classes``): native
        models contribute their whole distribution row, one-vs-all models
        their ``class_index`` column; contributors average per class in
        float64 on the host.  ``x`` is unused until models that read
        normalized floats are ported."""
        k = self.n_classes()
        if k < 2:
            raise ValueError("score_classes needs multi-class models")
        b = self._put(bins)
        sums = np.zeros((len(bins), k))
        cnts = np.zeros(k)
        for m in self.models:
            out = m.compute(b)
            ci = (m.spec.extra or {}).get("class_index")
            if out.shape[1] == k:
                sums += out
                cnts += 1.0
            elif ci is not None:
                sums[:, int(ci)] += out[:, 0]
                cnts[int(ci)] += 1.0
            else:
                raise ValueError(
                    f"{type(m).__name__} is neither K-output NATIVE nor "
                    "class-indexed OVA — cannot assemble class scores")
        return sums / np.maximum(cnts, 1.0)[None, :]


class ModelRunner:
    """raw chunk -> normalize -> score (reference ``ModelRunner.compute``,
    also the engine inside ``EvalScoreUDF``)."""

    def __init__(self, model_config, column_configs, models: Sequence,
                 for_eval_set: Optional[int] = None,
                 scale: float = SCORE_SCALE, device=None):
        from ..data.transform import DatasetTransformer
        self.transformer = DatasetTransformer(model_config, column_configs,
                                              for_eval_set=for_eval_set)
        self.scorer = Scorer(models, scale, device=device)

    def compute(self, chunk) -> Dict[str, object]:
        tc = self.transformer.transform(chunk)
        res = self.scorer.score(tc.x, bins=tc.bins)
        return {"result": res, "target": tc.target, "weight": tc.weight,
                "n": tc.n, "bins": tc.bins}

    def compute_classes(self, chunk) -> Dict[str, object]:
        """Multi-class scoring: [n, K] class scores instead of per-model
        scalar scores."""
        tc = self.transformer.transform(chunk)
        cs = self.scorer.score_classes(tc.x, bins=tc.bins)
        return {"class_scores": cs, "target": tc.target,
                "weight": tc.weight, "n": tc.n}
