"""Eval metrics: confusion-matrix sweep, ROC/PR/gain curves, AUC — the
host half of ``shifu_tpu.eval.metrics``, numpy float64 as there.

Reference ``core/ConfusionMatrix.java:62,553`` sorts scores descending and
walks thresholds accumulating unit + weighted tp/fp/tn/fn per bucket;
``core/eval/AreaUnderCurve.java:61-97`` integrates ROC by trapezoid;
``PerformanceEvaluator.java`` assembles the report.  Here the whole sweep is
one vectorized sort + cumsum — every threshold at once — and buckets are
sampled from the full curve afterwards.

The multi-class report (:func:`evaluate_multiclass`: accuracy, per-class
one-vs-rest AUC, confusion matrix) runs on the host in float64 too.

Not ported: the reference's device sweep (``sweep_device``,
``evaluate_scores_device``), which serves callers whose scores stay on the
device (``eval/gate.py``, refresh; ROADMAP Queue 1 item 12).  ``eval``
writes the scores to its score file first, so it sweeps on the host in
the reference too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class PerformancePoint:
    """One row of the reference's per-bucket report
    (``PerformanceResult``/``ConfusionMatrixObject``)."""
    binLowestScore: float
    tp: float
    fp: float
    fn: float
    tn: float
    precision: float
    recall: float            # catch rate / TPR
    fpr: float               # action rate on goods
    actionRate: float        # share of population at/above threshold
    liftUnit: float          # recall / actionRate
    weightedTp: float = 0.0
    weightedFp: float = 0.0
    weightedFn: float = 0.0
    weightedTn: float = 0.0
    weightedPrecision: float = 0.0
    weightedRecall: float = 0.0
    weightedFpr: float = 0.0


@dataclass
class PerformanceResult:
    areaUnderRoc: float
    weightedAuc: float
    areaUnderPr: float
    points: List[PerformancePoint] = field(default_factory=list)
    modelCount: int = 1
    recordCount: int = 0
    posCount: float = 0.0
    negCount: float = 0.0

    def to_dict(self) -> Dict:
        def clean(v):
            # NaN is not legal JSON — degenerate (single-class) sweeps
            # serialize as null
            return None if isinstance(v, float) and np.isnan(v) else v
        return {
            "areaUnderRoc": clean(self.areaUnderRoc),
            "weightedAuc": clean(self.weightedAuc),
            "areaUnderPr": clean(self.areaUnderPr),
            "recordCount": self.recordCount,
            "posCount": self.posCount,
            "negCount": self.negCount,
            "modelCount": self.modelCount,
            "performance": [vars(p) for p in self.points],
        }


def auc_trapezoid(fpr: np.ndarray, tpr: np.ndarray) -> float:
    """Trapezoid AUC over a monotone curve (reference
    ``AreaUnderCurve.java:61-97``)."""
    order = np.argsort(fpr, kind="stable")
    return float(np.trapezoid(tpr[order], fpr[order]))


@dataclass
class SweepCurves:
    """Full-resolution cumulative curves, scores descending."""
    thresholds: np.ndarray
    tp: np.ndarray
    fp: np.ndarray
    wtp: np.ndarray
    wfp: np.ndarray
    pos_total: float
    neg_total: float
    wpos_total: float
    wneg_total: float


def sweep(scores: np.ndarray, targets: np.ndarray,
          weights: Optional[np.ndarray] = None) -> SweepCurves:
    """Sort-desc + cumsum over every threshold at once.

    Tied scores collapse to one curve point (the end of the tie block): a
    threshold can only sit between distinct score values, so keeping
    intra-tie prefixes would make AUC depend on input row order.  The
    trapezoid over block ends integrates the diagonal across each tie."""
    scores = np.asarray(scores, np.float64)
    targets = np.asarray(targets, np.float64)
    w = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(-scores, kind="stable")
    s, t, ww = scores[order], targets[order], w[order]
    tp = np.cumsum(t)
    fp = np.cumsum(1.0 - t)
    wtp = np.cumsum(t * ww)
    wfp = np.cumsum((1.0 - t) * ww)
    if len(s):
        ends = np.flatnonzero(np.diff(s) != 0)
        keep = np.concatenate([ends, [len(s) - 1]])
        s, tp, fp, wtp, wfp = s[keep], tp[keep], fp[keep], wtp[keep], wfp[keep]
    return SweepCurves(thresholds=s, tp=tp, fp=fp, wtp=wtp, wfp=wfp,
                       pos_total=float(tp[-1]) if len(tp) else 0.0,
                       neg_total=float(fp[-1]) if len(fp) else 0.0,
                       wpos_total=float(wtp[-1]) if len(wtp) else 0.0,
                       wneg_total=float(wfp[-1]) if len(wfp) else 0.0)


def evaluate_scores(scores: np.ndarray, targets: np.ndarray,
                    weights: Optional[np.ndarray] = None,
                    buckets: int = 10) -> PerformanceResult:
    """Full eval report: AUC (unit + weighted), PR AUC, per-bucket confusion
    rows at ``buckets`` equal-population thresholds (reference
    ``performanceBucketNum``, default 10)."""
    return evaluate_curves(sweep(scores, targets, weights), buckets)


def evaluate_curves(c: SweepCurves, buckets: int = 10) -> PerformanceResult:
    """Report from precomputed curves — callers that also render charts
    (``eval/report.py``) sweep ONCE and share."""
    n = len(c.thresholds)           # distinct thresholds (ties collapsed)
    total = int(c.pos_total + c.neg_total)
    if n == 0 or c.pos_total == 0 or c.neg_total == 0:
        return PerformanceResult(float("nan"), float("nan"), float("nan"),
                                 recordCount=total, posCount=c.pos_total,
                                 negCount=c.neg_total)
    tpr = c.tp / c.pos_total
    fpr = c.fp / c.neg_total
    wtpr = c.wtp / max(c.wpos_total, 1e-12)
    wfpr = c.wfp / max(c.wneg_total, 1e-12)
    precision = c.tp / np.maximum(c.tp + c.fp, 1e-12)

    auc = auc_trapezoid(np.concatenate([[0.0], fpr, [1.0]]),
                        np.concatenate([[0.0], tpr, [1.0]]))
    wauc = auc_trapezoid(np.concatenate([[0.0], wfpr, [1.0]]),
                         np.concatenate([[0.0], wtpr, [1.0]]))
    # PR AUC over recall axis
    pr_auc = float(np.trapezoid(
        np.concatenate([[precision[0]], precision]),
        np.concatenate([[0.0], tpr])))

    points = []
    cum_pop = c.tp + c.fp
    for b in range(1, buckets + 1):
        # bucket boundary = threshold closest to b/buckets population share
        i = min(n - 1, int(np.searchsorted(cum_pop, b * total / buckets)))
        tp_, fp_ = float(c.tp[i]), float(c.fp[i])
        fn_, tn_ = c.pos_total - tp_, c.neg_total - fp_
        wtp_, wfp_ = float(c.wtp[i]), float(c.wfp[i])
        wfn_, wtn_ = c.wpos_total - wtp_, c.wneg_total - wfp_
        action = float(cum_pop[i]) / total
        points.append(PerformancePoint(
            binLowestScore=float(c.thresholds[i]),
            tp=tp_, fp=fp_, fn=fn_, tn=tn_,
            precision=tp_ / max(tp_ + fp_, 1e-12),
            recall=tp_ / max(c.pos_total, 1e-12),
            fpr=fp_ / max(c.neg_total, 1e-12),
            actionRate=action,
            liftUnit=(tp_ / max(c.pos_total, 1e-12)) / max(action, 1e-12),
            weightedTp=wtp_, weightedFp=wfp_, weightedFn=wfn_, weightedTn=wtn_,
            weightedPrecision=wtp_ / max(wtp_ + wfp_, 1e-12),
            weightedRecall=wtp_ / max(c.wpos_total, 1e-12),
            weightedFpr=wfp_ / max(c.wneg_total, 1e-12)))
    return PerformanceResult(
        areaUnderRoc=auc, weightedAuc=wauc, areaUnderPr=pr_auc, points=points,
        recordCount=total, posCount=c.pos_total, negCount=c.neg_total)


def gain_chart_rows(result: PerformanceResult) -> List[Dict]:
    """Gain-chart table (reference ``core/eval/GainChart.java`` csv body)."""
    return [{"actionRate": p.actionRate, "recall": p.recall,
             "precision": p.precision, "lift": p.liftUnit,
             "weightedRecall": p.weightedRecall, "score": p.binLowestScore}
            for p in result.points]


def evaluate_multiclass(class_scores: np.ndarray, targets: np.ndarray,
                        weights: Optional[np.ndarray] = None) -> Dict:
    """Multi-class eval report: weighted accuracy (argmax vote, reference
    ``MultiClsTagPredictor.predictTag``), per-class one-vs-rest AUC, macro
    AUC, and the K x K weighted confusion matrix.

    class_scores: [n, K]; targets: [n] class indices.
    """
    class_scores = np.asarray(class_scores, np.float64)
    t = np.asarray(targets).astype(int)
    n, k = class_scores.shape
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    pred = class_scores.argmax(axis=1)
    acc = float((w * (pred == t)).sum() / max(w.sum(), 1e-12))
    conf = np.zeros((k, k))
    np.add.at(conf, (t, pred), w)
    aucs = []
    for ci in range(k):
        c = sweep(class_scores[:, ci], (t == ci).astype(float), w)
        if c.pos_total > 0 and c.neg_total > 0:
            aucs.append(auc_trapezoid(c.fp / c.neg_total, c.tp / c.pos_total))
        else:
            aucs.append(float("nan"))
    finite = [a for a in aucs if np.isfinite(a)]
    return {"nClasses": k, "recordCount": int(n),
            "accuracy": acc, "errorRate": 1.0 - acc,
            "perClassAuc": [float(a) for a in aucs],
            "macroAuc": float(np.mean(finite)) if finite else float("nan"),
            "classCounts": np.bincount(t, minlength=k).tolist(),
            "confusionMatrix": conf.tolist()}
