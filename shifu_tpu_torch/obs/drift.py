"""Streaming drift monitor — per-column PSI of live windows vs training;
the port's copy of ``shifu_tpu.obs.drift``.

Fraud distributions drift; the reference treats PSI as a first-class
stat (``udf/PSICalculatorUDF``, the ``stats -psi`` unit sweep).  This
module makes it a LIVE signal: :class:`DriftMonitor` is seeded with the
training-time binning snapshot (the per-bin counts ``stats`` wrote into
``ColumnConfig.json`` — ``binCountNeg``/``binCountPos``, missing bin
last) and accumulates the SAME per-column bin counts incrementally from
whatever binned windows flow past it (norm re-runs on new data windows,
eval sets, the refresh stream), so

    PSI(training snapshot, everything seen so far)

is available at any moment, computed by the exact batch formula
(:func:`shifu_tpu_torch.ops.stats_math.psi` — counts are additive, so the
incremental accumulation IS the batch computation) at per-window cost of
one ``np.add.at`` over a packed (column, bin) space.

This is the refresh loop's trigger: the controller
(:mod:`shifu_tpu_torch.refresh.controller`) reads ``psi_max`` from a
live monitor or the ``drift.json`` artifact to decide whether a retrain
is warranted, and ``analysis --telemetry`` renders the same table from
the artifact.

Zero-cost when telemetry is disabled: :func:`start_drift_monitor`
returns ``None`` and the pipeline call sites skip the per-window update
entirely.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..ioutil import atomic_write_json
from ..ops.stats_math import psi
from . import registry, tracer

log = logging.getLogger(__name__)

DRIFT_BASENAME = "drift.json"

# industry-standard PSI bands: < 0.1 stable, 0.1-0.25 drifting, > 0.25
# act (retrain) — the default flag threshold, property-overridable
DEFAULT_PSI_THRESHOLD = 0.25


def psi_threshold(override: Optional[float] = None) -> float:
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


class DriftMonitor:
    """Incremental per-column PSI vs the ColumnConfig binning snapshot.

    ``columns`` is the bin-index space of the windows that will be fed in
    (the transformer's model-input columns, in order): ``update(bins)``
    expects ``bins[:, j]`` to hold column ``columns[j]``'s bin index in
    ``0..num_bins`` (missing = ``num_bins``) — exactly the
    ``TransformedChunk.bins`` / clean-plane layout.  Columns whose
    snapshot has no per-bin counts (stats not run, or a meta/target
    column) are carried as NaN and never flagged.
    """

    def __init__(self, columns: Sequence, threshold: Optional[float] = None):
        self.columns = list(columns)
        self.threshold = psi_threshold(threshold)
        nb, expected = [], []
        self._have = np.zeros(len(self.columns), bool)
        for j, cc in enumerate(self.columns):
            neg = cc.columnBinning.binCountNeg
            pos = cc.columnBinning.binCountPos
            n_bins = cc.num_bins() + 1          # + trailing missing bin
            exp = np.zeros(n_bins, np.float64)
            if neg is not None and pos is not None:
                m = min(n_bins, len(neg), len(pos))
                exp[:m] = (np.asarray(neg[:m], np.float64)
                           + np.asarray(pos[:m], np.float64))
                self._have[j] = exp.sum() > 0
            nb.append(n_bins)
            expected.append(exp)
        self._nb = np.asarray(nb, np.int64)
        self._offsets = np.concatenate(
            [[0], np.cumsum(self._nb)]).astype(np.int64)
        self._expected = expected
        self._counts = np.zeros(int(self._offsets[-1]), np.float64)
        self.rows = 0
        self.windows = 0

    # ------------------------------------------------------------ updates
    def update(self, bins: np.ndarray,
               weights: Optional[np.ndarray] = None) -> None:
        """Fold one binned window ``[R, C]`` into the live counts (rows
        with zero weight — a streamed window's padding — are excluded)."""
        bins = np.asarray(bins)
        if bins.ndim != 2 or bins.shape[1] != len(self.columns):
            raise ValueError(
                f"drift window has {bins.shape[1:]} columns, monitor "
                f"tracks {len(self.columns)}")
        if weights is not None:
            keep = np.asarray(weights) > 0
            bins = bins[keep]
        if not len(bins):
            return
        # pack (column, bin) into one flat axis: a single bincount pass
        # per window regardless of column count (the stats -psi recipe)
        idx = np.minimum(np.asarray(bins, np.int64), self._nb - 1) \
            + self._offsets[:-1]
        self._counts += np.bincount(idx.ravel(),
                                    minlength=len(self._counts))
        self.rows += int(len(bins))
        self.windows += 1

    # ------------------------------------------------------------ read-out
    def column_psi(self) -> np.ndarray:
        """Per-column PSI (NaN where the snapshot has no counts or no
        live rows have been seen)."""
        out = np.full(len(self.columns), np.nan)
        if self.rows == 0:
            return out
        for j in range(len(self.columns)):
            if not self._have[j]:
                continue
            s, e = self._offsets[j], self._offsets[j + 1]
            out[j] = float(psi(self._expected[j], self._counts[s:e]))
        return out

    def summary(self) -> Dict[str, Any]:
        vals = self.column_psi()
        ok = ~np.isnan(vals)
        flagged = [self.columns[j].columnName
                   for j in np.flatnonzero(ok & (vals > self.threshold))]
        return {
            "kind": "drift",
            "schema_version": tracer.SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "rows": self.rows,
            "windows": self.windows,
            "threshold": self.threshold,
            "psi_max": float(np.nanmax(vals)) if ok.any() else None,
            "psi_mean": float(np.nanmean(vals)) if ok.any() else None,
            "flagged": flagged,
            "columns": {
                self.columns[j].columnName: round(float(vals[j]), 6)
                for j in np.flatnonzero(ok)},
        }

    def emit(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Publish: ``drift.*`` gauges into the registry (scraped by the
        exporter, rendered by ``analysis --telemetry``) and, when
        ``path`` is given, the full per-column table as ``drift.json``
        (atomic)."""
        summ = self.summary()
        registry.gauge("drift.rows").set(self.rows)
        registry.gauge("drift.columns_tracked").set(int(self._have.sum()))
        registry.gauge("drift.columns_flagged").set(len(summ["flagged"]))
        if summ["psi_max"] is not None:
            registry.gauge("drift.psi_max").set(summ["psi_max"])
            registry.gauge("drift.psi_mean").set(summ["psi_mean"])
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                atomic_write_json(path, summ)
            except OSError:
                log.warning("drift table write failed", exc_info=True)
        return summ


def start_drift_monitor(columns: Sequence,
                        threshold: Optional[float] = None
                        ) -> Optional[DriftMonitor]:
    """A monitor over the transformer's column list — ``None`` when
    telemetry is disabled (call sites skip their per-window update)."""
    if not tracer.enabled():
        return None
    mon = DriftMonitor(columns, threshold=threshold)
    if not mon._have.any():
        return None                  # nothing to compare against yet
    return mon
