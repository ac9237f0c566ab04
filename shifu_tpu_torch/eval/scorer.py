"""Scorer + ModelRunner — the port of ``shifu_tpu.eval.scorer`` (reference
``core/Scorer.java:53``, ``core/ModelRunner.java:54``).

Batched over rows x models like the reference.  Tree forests read the bins,
which go to the scoring device once a batch in the narrowest dtype the
forests admit (uint8 when every forest has <= 256 bins), and walk them
with ``ops/tree_quant.predict_forest_quant`` — the ``tree_traverse``
kernel on a CUDA device (it launches or raises), its plain version on the
CPU.  NN and LR models read the normalized floats ``x``, which go to the
device once a batch; same-shape nets score as ONE stacked forward
(``models.nn.forward`` over their weights stacked on a leading axis, built
once), the reference's ``_stacked_nn_groups``.  A wide-and-deep model
reads both planes (``input_kind`` "both": its numeric block of ``x`` and
its categorical columns of the bins, ``compute_full``) and a kernel SVM
the normalized floats; each scores by itself.  The per-model scores are
scaled by ``SCORE_SCALE`` and aggregated per row.  Multi-class sets score
with :meth:`Scorer.score_classes`: native models (a softmax head, a
class-distribution forest) contribute their whole row, one-vs-all members
their ``class_index`` column.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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
    """Multi-model batch scorer over normalized and binned rows."""

    def __init__(self, models: Sequence, scale: float = SCORE_SCALE,
                 device=None):
        if not models:
            raise ValueError("no models to score with")
        self.models = list(models)
        self.scale = scale
        self.device = resolve_device(device)
        self.tree_models = [m for m in self.models
                            if getattr(m, "input_kind", "norm") == "bins"]
        self.needs_bins = any(getattr(m, "input_kind", "norm")
                              in ("bins", "both") for m in self.models)
        self._groups = None                  # stacked same-shape nets

    @classmethod
    def from_dir(cls, models_dir: str, scale: float = SCORE_SCALE,
                 device=None) -> "Scorer":
        return cls(load_models(models_dir), scale, device=device)

    def nn_groups(self) -> List[Tuple[List[int], object, list]]:
        """Same-shape NN/LR models as ``(model indices, spec, stacked
        params on the device)``, built once: one forward a group."""
        if self._groups is None:
            from ..models.nn import IndependentNNModel, stack_params
            by_shape: Dict[tuple, List[int]] = {}
            for i, m in enumerate(self.models):
                if isinstance(m, IndependentNNModel):
                    by_shape.setdefault(m.spec.shape_key(), []).append(i)
            self._groups = [
                (idxs, self.models[idxs[0]].spec,
                 stack_params([self.models[i].params for i in idxs],
                              self.device))
                for idxs in by_shape.values()]
        return self._groups

    def outputs(self, x: Optional[np.ndarray],
                bins: Optional[np.ndarray]) -> List[np.ndarray]:
        """Every model's ``[n, out]`` f32 output, in model order: the
        forests over ``bins``, the nets and SVMs over ``x``, WDL models
        over both."""
        outs: List[Optional[np.ndarray]] = [None] * len(self.models)
        groups = self.nn_groups()
        needs_x = len(self.tree_models) < len(self.models)
        if needs_x and x is None:
            raise ValueError("NN/LR/SVM/WDL models need the normalized rows "
                             "— pass x to the scorer")
        if self.needs_bins and bins is None:
            raise ValueError("tree and WDL models need binned input — pass "
                             "bins= to the scorer")
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device) if needs_x else None
        if groups:
            from ..models.nn import forward
            with torch.no_grad():
                for idxs, spec, stacked in groups:
                    o = forward(stacked, spec, xd).cpu().numpy()
                    for pos, i in enumerate(idxs):
                        outs[i] = o[pos]
        b = self._put(bins) if self.needs_bins else None
        for i, m in enumerate(self.models):
            if outs[i] is not None:
                continue
            kind = getattr(m, "input_kind", "norm")
            if kind == "bins":
                outs[i] = m.compute(b)
            elif kind == "both":
                outs[i] = m.compute_full(xd, b)
            else:
                outs[i] = m.compute(xd)
        return outs

    def score(self, x: Optional[np.ndarray],
              bins: Optional[np.ndarray] = None) -> CaseScoreResult:
        """Scaled per-model scores and their per-row aggregates."""
        cols = [o[:, 0] for o in self.outputs(x, bins)]
        raw = np.stack(cols, axis=1) * np.float32(self.scale)
        return CaseScoreResult(scores=raw, mean=raw.mean(axis=1),
                               max=raw.max(axis=1), min=raw.min(axis=1),
                               median=np.median(raw, axis=1))

    def bins_dtype(self) -> torch.dtype:
        """The bins' dtype on the device: the forests' wire dtype (the
        reference's ``ensemble_bins_dtype``), int32 beside a WDL model,
        whose categorical ids can pass 255."""
        from ..ops.tree_quant import ensemble_bins_dtype
        if len(self.tree_models) < sum(
                getattr(m, "input_kind", "norm") in ("bins", "both")
                for m in self.models):
            return torch.int32
        return ensemble_bins_dtype(self.tree_models)

    def _put(self, bins: np.ndarray) -> torch.Tensor:
        """The binned batch on the scoring device, once."""
        return torch.from_numpy(np.ascontiguousarray(bins)).to(
            self.device, self.bins_dtype())

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
                      bins: Optional[np.ndarray] = None) -> np.ndarray:
        """[n, K] class scores (reference ``Scorer.score_classes``): native
        models contribute their whole row, one-vs-all models their
        ``class_index`` column; contributors average per class in float64
        on the host."""
        k = self.n_classes()
        if k < 2:
            raise ValueError("score_classes needs multi-class models")
        outs = self.outputs(x, bins)
        sums = np.zeros((len(outs[0]), k))
        cnts = np.zeros(k)
        for m, out in zip(self.models, outs):
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
