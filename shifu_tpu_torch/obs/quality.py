"""Streaming model-quality monitor: live AUC, calibration, score-PSI; the
port of ``shifu_tpu.obs.quality``.

The reference's ``posttrain`` step measures the score distribution once,
offline; this module closes the production loop the way a serving
system must (the large-scale-ML-systems argument: quality is measured
where the model serves, not where it trained):

- **score-PSI** — a fixed-bin histogram of live scores per model
  generation vs the training-time snapshot eval persists as
  ``telemetry/posttrain.json`` (:func:`write_posttrain_snapshot`), the
  exact PSI the drift plane computes for inputs, applied to OUTPUTS;
- **calibration** — reliability bins (mean predicted probability vs
  observed positive rate) and their expected calibration error over the
  joined windows;
- **live AUC** — rolling AUC over joined ``(score, label)`` windows
  (:mod:`shifu_tpu_torch.eval.metrics`' sweep — the same math offline eval
  uses), attributed PER GENERATION so a hot-swap shows old-vs-new live
  AUC side by side.

Degradation is judged on the CURRENT generation once ``minJoined`` rows
have joined: live AUC more than ``-Dshifu.quality.aucDelta`` below the
snapshot AUC, or score-PSI at/over ``-Dshifu.quality.psiThreshold``
(default: the drift threshold).  The refresh controller reads
``summary()`` as its third trigger source; the monitor/report planes
render the same dict from the ``telemetry/quality.json`` artifact.

Zero-cost when off: the plane only exists when
``-Dshifu.scorelog.sampleRate`` > 0 (:func:`start_quality_monitor`
returns ``None`` otherwise) — no histograms, no windows, no artifact.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..ioutil import atomic_write_json
from ..ops.stats_math import psi
from . import registry, tracer

log = logging.getLogger(__name__)

POSTTRAIN_BASENAME = "posttrain.json"
QUALITY_BASENAME = "quality.json"

SCORE_BINS = 10                  # PSI + reliability bins over [lo, hi]
DEFAULT_AUC_DELTA = 0.05
DEFAULT_MIN_JOINED = 64
# per-generation rolling window bound on joined rows (memory, and how
# fast the live AUC forgets)
WINDOW_ROWS = 4096


def posttrain_snapshot_path(model_set_dir: str) -> str:
    return os.path.join(model_set_dir, "telemetry", POSTTRAIN_BASENAME)


def quality_artifact_path(model_set_dir: str) -> str:
    return os.path.join(model_set_dir, "telemetry", QUALITY_BASENAME)


def quality_auc_delta(override: Optional[float] = None) -> float:
    if override is not None:
        return float(override)
    from ..config import environment
    p = environment.get_property("shifu.quality.aucDelta")
    if p is not None:
        try:
            return float(p)
        except (TypeError, ValueError):
            pass
    return DEFAULT_AUC_DELTA


def quality_psi_threshold(override: Optional[float] = None) -> float:
    if override is not None:
        return float(override)
    from ..config import environment
    p = environment.get_property("shifu.quality.psiThreshold")
    if p is not None:
        try:
            return float(p)
        except (TypeError, ValueError):
            pass
    return psi_threshold()


# the drift plane's PSI threshold (the reference's ``obs.drift``; the
# port's drift monitor is ROADMAP Queue 1 item 13) — the quality plane's
# default score-PSI threshold
DEFAULT_PSI_THRESHOLD = 0.25


def psi_threshold(override: Optional[float] = None) -> float:
    """``-Dshifu.drift.psiThreshold`` (default 0.25) — a copy of the
    reference's ``obs.drift.psi_threshold``."""
    if override is not None:
        return float(override)
    from ..config import environment
    p = environment.get_property("shifu.drift.psiThreshold")
    if p is not None:
        try:
            return float(p)
        except (TypeError, ValueError):
            pass
    return DEFAULT_PSI_THRESHOLD


def quality_min_joined(override: Optional[int] = None) -> int:
    if override is not None:
        return int(override)
    from ..config import environment
    p = environment.get_property("shifu.quality.minJoined")
    if p is not None:
        try:
            return int(p)
        except (TypeError, ValueError):
            pass
    return DEFAULT_MIN_JOINED


def _score_histogram(scores: np.ndarray, lo: float, hi: float,
                     bins: int = SCORE_BINS) -> np.ndarray:
    span = max(hi - lo, 1e-12)
    idx = np.clip(((np.asarray(scores, np.float64) - lo) / span
                   * bins).astype(np.int64), 0, bins - 1)
    return np.bincount(idx, minlength=bins).astype(np.float64)


def write_posttrain_snapshot(path: str, scores, auc: Optional[float],
                             scale: Optional[float] = None
                             ) -> Dict[str, Any]:
    """The training-time score snapshot (the posttrain analogue) the
    live plane compares against: offline AUC + the score histogram over
    the observed range.  Written atomically by eval; ``scale`` is the
    scorer's score scale (probability = score / scale)."""
    if scale is None:
        from ..eval.scorer import SCORE_SCALE
        scale = SCORE_SCALE
    s = np.asarray(scores, np.float64).ravel()
    lo = float(s.min()) if s.size else 0.0
    hi = float(s.max()) if s.size else 1.0
    doc = {
        "kind": "posttrain",
        "schema_version": tracer.SCHEMA_VERSION,
        "ts": round(time.time(), 3),
        "rows": int(s.size),
        "auc": None if auc is None else round(float(auc), 6),
        "score_scale": float(scale),
        "score_lo": round(lo, 6),
        "score_hi": round(hi, 6),
        "score_hist": [int(c) for c in _score_histogram(s, lo, hi)],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_json(path, doc)
    return doc


def load_posttrain_snapshot(model_set_dir: str) -> Optional[Dict[str, Any]]:
    path = posttrain_snapshot_path(model_set_dir)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class _GenWindow:
    """One generation's live state: score histogram (every sampled
    score) + bounded joined (score, label) window."""

    __slots__ = ("scored", "hist", "scores", "labels", "joined")

    def __init__(self, bins: int):
        self.scored = 0
        self.hist = np.zeros(bins, np.float64)
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        self.joined = 0

    def trim(self, cap: int) -> None:
        while self.joined > cap and len(self.scores) > 1:
            self.joined -= int(len(self.scores.pop(0)))
            self.labels.pop(0)


class QualityMonitor:
    """Per-generation live quality over the score-log feed.

    ``observe_scores`` takes EVERY sampled score (the PSI feed);
    ``update`` takes only joined rows (the AUC/calibration feed).
    Both are a few numpy ops per call — safe on the serve path at the
    sample rates the score log is meant for.
    """

    def __init__(self, snapshot: Optional[Dict[str, Any]] = None,
                 psi_threshold: Optional[float] = None,
                 auc_delta: Optional[float] = None,
                 min_joined: Optional[int] = None,
                 window_rows: int = WINDOW_ROWS):
        self.snapshot = snapshot
        self.psi_threshold = quality_psi_threshold(psi_threshold)
        self.auc_delta = quality_auc_delta(auc_delta)
        self.min_joined = quality_min_joined(min_joined)
        self.window_rows = int(window_rows)
        snap = snapshot or {}
        self.baseline_auc = snap.get("auc")
        self._lo = float(snap.get("score_lo", 0.0))
        self._hi = float(snap.get("score_hi", 1.0))
        self._scale = float(snap.get("score_scale", 1.0)) or 1.0
        self._expected = (np.asarray(snap["score_hist"], np.float64)
                          if snap.get("score_hist") else None)
        self._gens: Dict[int, _GenWindow] = {}

    def _gen(self, gen: int) -> _GenWindow:
        w = self._gens.get(int(gen))
        if w is None:
            w = self._gens[int(gen)] = _GenWindow(SCORE_BINS)
        return w

    # ------------------------------------------------------------- feeds
    def observe_scores(self, gen: int, scores) -> None:
        s = np.asarray(scores, np.float64).ravel()
        if not s.size:
            return
        w = self._gen(gen)
        w.scored += int(s.size)
        w.hist += _score_histogram(s, self._lo, self._hi)

    def update(self, gen: int, scores, labels, weights=None) -> None:
        s = np.asarray(scores, np.float32).ravel()
        lab = np.asarray(labels, np.float32).ravel()
        if not s.size:
            return
        w = self._gen(gen)
        w.scores.append(s)
        w.labels.append(lab)
        w.joined += int(s.size)
        w.trim(self.window_rows)

    def reset_windows(self) -> None:
        """Fresh windows (kept snapshot/thresholds) — the refresh
        controller calls this after a cycle so a just-promoted model is
        judged only on its own traffic."""
        self._gens = {}

    # ----------------------------------------------------------- read-out
    def _gen_row(self, w: _GenWindow) -> Dict[str, Any]:
        live_auc = ece = None
        if w.joined >= max(self.min_joined, 1):
            s = np.concatenate(w.scores)
            lab = np.concatenate(w.labels)
            if 0.0 < float(lab.mean()) < 1.0:   # both classes present
                from ..eval.metrics import auc_trapezoid, sweep
                c = sweep(s, lab)
                live_auc = float(auc_trapezoid(
                    c.fp / max(c.neg_total, 1e-12),
                    c.tp / max(c.pos_total, 1e-12)))
                ece = self._ece(s, lab)
        p = None
        if self._expected is not None and w.hist.sum() > 0:
            p = float(psi(self._expected, w.hist))
        return {"scored": w.scored, "joined": w.joined,
                "live_auc": None if live_auc is None
                else round(live_auc, 6),
                "ece": None if ece is None else round(ece, 6),
                "psi": None if p is None else round(p, 6)}

    def _ece(self, scores: np.ndarray, labels: np.ndarray) -> float:
        """Reliability-bin expected calibration error: |mean predicted
        probability - observed positive rate| weighted by bin mass."""
        prob = np.clip(np.asarray(scores, np.float64) / self._scale,
                       0.0, 1.0)
        idx = np.clip((prob * SCORE_BINS).astype(np.int64), 0,
                      SCORE_BINS - 1)
        n = np.bincount(idx, minlength=SCORE_BINS).astype(np.float64)
        p_sum = np.bincount(idx, weights=prob, minlength=SCORE_BINS)
        y_sum = np.bincount(idx, weights=labels.astype(np.float64),
                            minlength=SCORE_BINS)
        mask = n > 0
        return float(np.sum(np.abs(p_sum[mask] - y_sum[mask]))
                     / max(n.sum(), 1.0))

    def summary(self) -> Dict[str, Any]:
        gens = {str(g): self._gen_row(w)
                for g, w in sorted(self._gens.items())}
        cur = max(self._gens) if self._gens else None
        row = gens[str(cur)] if cur is not None else {}
        reasons = []
        if (row.get("live_auc") is not None
                and self.baseline_auc is not None
                and self.baseline_auc - row["live_auc"]
                >= self.auc_delta):
            reasons.append("live-auc")
        if (row.get("psi") is not None
                and row.get("scored", 0) >= max(self.min_joined, 1)
                and row["psi"] >= self.psi_threshold):
            reasons.append("score-psi")
        return {
            "kind": "quality",
            "schema_version": tracer.SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "baseline_auc": self.baseline_auc,
            "auc_delta": self.auc_delta,
            "psi_threshold": self.psi_threshold,
            "min_joined": self.min_joined,
            "current_gen": cur,
            "live_auc": row.get("live_auc"),
            "score_psi": row.get("psi"),
            "ece": row.get("ece"),
            "joined": row.get("joined", 0),
            "generations": gens,
            "degraded": bool(reasons),
            "reasons": reasons,
        }

    def compact(self) -> Dict[str, Any]:
        """The heartbeat-extras shape (small: every beat carries it)."""
        summ = self.summary()
        return {"degraded": summ["degraded"],
                "live_auc": summ["live_auc"],
                "score_psi": summ["score_psi"],
                "joined": summ["joined"],
                "generations": {g: r["live_auc"]
                                for g, r in summ["generations"].items()}}

    def emit(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Publish: ``quality.*`` gauges into the registry and, when
        ``path`` is given, the full table as ``quality.json``
        (atomic)."""
        summ = self.summary()
        registry.gauge("quality.scored_rows").set(
            sum(w.scored for w in self._gens.values()))
        registry.gauge("quality.joined_rows").set(
            sum(w.joined for w in self._gens.values()))
        registry.gauge("quality.degraded").set(
            1.0 if summ["degraded"] else 0.0)
        if summ["live_auc"] is not None:
            registry.gauge("quality.live_auc").set(summ["live_auc"])
        if summ["score_psi"] is not None:
            registry.gauge("quality.score_psi").set(summ["score_psi"])
        if summ["ece"] is not None:
            registry.gauge("quality.ece").set(summ["ece"])
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                atomic_write_json(path, summ)
            except OSError:
                log.warning("quality table write failed", exc_info=True)
        return summ


def start_quality_monitor(model_set_dir: Optional[str] = None,
                          snapshot: Optional[Dict[str, Any]] = None,
                          sample_rate: Optional[float] = None,
                          psi_threshold: Optional[float] = None,
                          auc_delta: Optional[float] = None,
                          min_joined: Optional[int] = None
                          ) -> Optional[QualityMonitor]:
    """A monitor seeded from the model set's posttrain snapshot —
    ``None`` when the score log is off (no feed to monitor).  Without a
    snapshot the monitor still tracks live AUC/ECE; PSI and the AUC
    baseline need the artifact."""
    from .scorelog import scorelog_sample_rate
    if scorelog_sample_rate(sample_rate) <= 0.0:
        return None
    if snapshot is None and model_set_dir:
        snapshot = load_posttrain_snapshot(model_set_dir)
    return QualityMonitor(snapshot=snapshot,
                          psi_threshold=psi_threshold,
                          auc_delta=auc_delta, min_joined=min_joined)
