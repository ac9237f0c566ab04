"""Vectorized normalization — all norm types of the reference (the port's
copy of ``shifu_tpu.ops.normalize``: host-side numpy f64, unchanged, so
the fused serving transform replays the same tables).

Covers every ``NormType`` of reference ``ModelNormalizeConf.java:34-46`` with
the semantics of reference ``core/Normalizer.java:124-287,444,619``:

- ZSCALE/ZSCORE (+OLD_*): numeric -> clip((v-mean)/std, ±cutoff); missing ->
  mean (z=0); categorical -> binPosRate (missing: POSRATE of the missing bin,
  or mean), then z-scored (OLD_* skips the z-step for categoricals).
- WOE / WEIGHT_WOE: per-bin (weighted) WOE lookup; missing -> last bin's woe.
- WOE_ZSCORE / WEIGHT_WOE_ZSCORE: woe then z-scored by the count-weighted
  woe mean/std (reference ``calculateWoeMeanAndStdDev``).
- HYBRID / WEIGHT_HYBRID: numeric zscore, categorical (weighted) woe.
- ONEHOT: bin one-hot incl. missing bin; ZSCALE_ONEHOT: numeric zscore +
  categorical one-hot.
- DISCRETE_ZSCORE: numeric discretized to bin left boundary (first bin: min)
  then z-scored; categorical -> posrate zscore.
- ASIS_WOE/ASIS_PR: raw numeric passthrough (missing -> mean); categorical ->
  bin woe / posrate.
- ZSCALE_INDEX / WOE_INDEX / WOE_ZSCALE_INDEX: categorical -> raw category
  index (missing -> num categories), numeric -> zscore / woe / zscored-woe.

Everything is table-lookup + affine math over columnar arrays: per column we
precompute a bin->value table, so normalization = bin-index gather (+ z-score
clip); here the tables are evaluated in numpy and the serving
transform gathers them on the device.

Precision truncation mirrors ``NormalizeUDF.java:540-570``: FLOAT7 rounds to
7 decimals, FLOAT16 squeezes through half precision, FLOAT32/DOUBLE64 cast.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import ColumnConfig
from ..config.model_config import NormType, PrecisionType


class CategoryMissingNormType(enum.Enum):
    POSRATE = "POSRATE"
    MEAN = "MEAN"


def _nan_to(arr: Optional[List[Optional[float]]], fill: float) -> np.ndarray:
    if arr is None:
        return np.array([fill])
    a = np.array([fill if v is None else v for v in arr], dtype=np.float64)
    a[~np.isfinite(a)] = fill
    return a


def woe_mean_std(cc: ColumnConfig, weighted: bool) -> Tuple[float, float]:
    """Count-weighted mean/std of the per-bin woe values (incl. missing bin),
    reference ``Normalizer.calculateWoeMeanAndStdDev``."""
    bn = cc.columnBinning
    woes = _nan_to(bn.binWeightedWoe if weighted else bn.binCountWoe, 0.0)
    if weighted:
        counts = (_nan_to(bn.binWeightedPos, 0) + _nan_to(bn.binWeightedNeg, 0))
    else:
        counts = (_nan_to([float(x) for x in (bn.binCountPos or [0])], 0)
                  + _nan_to([float(x) for x in (bn.binCountNeg or [0])], 0))
    n = min(len(woes), len(counts))
    woes, counts = woes[:n], counts[:n]
    total = counts.sum()
    if total <= 0:
        return 0.0, 1.0
    mean = float((woes * counts).sum() / total)
    var = float(((woes - mean) ** 2 * counts).sum() / total)
    return mean, np.sqrt(var) if var > 1e-20 else 1.0


def z_score(v: np.ndarray, mean: float, std: float, cutoff: float) -> np.ndarray:
    """Reference ``Normalizer.computeZScore``: clip to mean±cutoff·std then
    standardize; zero when std ~ 0."""
    if std is None or std < 1e-5:
        return np.zeros_like(v)
    clipped = np.clip(v, mean - cutoff * std, mean + cutoff * std)
    return (clipped - mean) / std


@dataclass
class NormalizedColumn:
    """Per-column normalization plan: output width + vectorized transform."""
    cc: ColumnConfig
    norm_type: NormType
    cutoff: float
    cate_missing: CategoryMissingNormType = CategoryMissingNormType.POSRATE

    def output_names(self) -> List[str]:
        name = self.cc.columnName
        if self.norm_type in (NormType.ONEHOT, NormType.ZSCALE_ONEHOT):
            if self.norm_type == NormType.ONEHOT or self.cc.is_categorical():
                return [f"{name}_{i}" for i in range(self.cc.num_bins() + 1)]
        return [name]

    @property
    def width(self) -> int:
        return len(self.output_names())

    # ------------------------------------------------------------ tables
    def _posrate_table(self) -> np.ndarray:
        """bin -> posRate incl. missing bin; missing-bin fill per policy."""
        cc = self.cc
        mean = cc.mean()
        table = _nan_to(cc.bin_pos_rate, mean)
        if self.cate_missing == CategoryMissingNormType.MEAN and len(table):
            table[-1] = mean
        return table

    def _woe_table(self, weighted: bool) -> np.ndarray:
        bn = self.cc.columnBinning
        return _nan_to(bn.binWeightedWoe if weighted else bn.binCountWoe, 0.0)

    def bin_value_table(self, num_bins: int) -> np.ndarray:
        """``bin index -> normalized value`` as ONE f64 table, evaluated by
        the offline transform itself over every index a binner can emit
        (``0..num_bins+1``: real bins, the missing bin, and the clip
        sentinel).  Any bin-index-only norm family collapses to this
        gather, so the fused serving prelude (``serve.transform``) replays
        the offline values verbatim from a device constant — the public
        contract behind its bit-parity guarantee.  Value-carrying numeric
        families (ZSCALE/ZSCORE/HYBRID/ASIS) do NOT collapse; callers
        handle those with the clip/affine path instead."""
        dom = np.arange(num_bins + 2)
        if self.cc.is_categorical():
            return np.asarray(self._transform_categorical(dom), np.float64)
        return np.asarray(self._transform_numeric(
            np.zeros(len(dom)), np.ones(len(dom), bool), dom), np.float64)

    # --------------------------------------------------------- transform
    def transform(self, values: np.ndarray, valid: np.ndarray,
                  bin_idx: np.ndarray) -> np.ndarray:
        """values: numeric floats (NaN ok) or unused for categorical;
        bin_idx: precomputed bin indices (missing -> num_bins);
        returns [R, width] float64."""
        cc = self.cc
        t = self.norm_type
        cutoff = self.cutoff
        mean, std = cc.mean(), cc.std_dev()

        if t in (NormType.ONEHOT,) or (t == NormType.ZSCALE_ONEHOT and cc.is_categorical()):
            width = self.width
            out = np.zeros((len(bin_idx), width))
            idx = np.clip(bin_idx, 0, width - 1)
            out[np.arange(len(bin_idx)), idx] = 1.0
            return out

        if cc.is_categorical():
            return self._transform_categorical(bin_idx)[:, None]
        return self._transform_numeric(values, valid, bin_idx)[:, None]

    def _transform_numeric(self, values: np.ndarray, valid: np.ndarray,
                           bin_idx: np.ndarray) -> np.ndarray:
        cc, t, cutoff = self.cc, self.norm_type, self.cutoff
        mean, std = cc.mean(), cc.std_dev()
        v = np.where(valid, values, mean)  # missing -> mean (z = 0)

        if t in (NormType.WOE, NormType.WEIGHT_WOE, NormType.WOE_INDEX):
            table = self._woe_table(t == NormType.WEIGHT_WOE)
            return _safe_gather(table, bin_idx)
        if t in (NormType.WOE_ZSCORE, NormType.WOE_ZSCALE,
                 NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE,
                 NormType.WOE_ZSCALE_INDEX):
            weighted = t in (NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE)
            woe = _safe_gather(self._woe_table(weighted), bin_idx)
            wmean, wstd = woe_mean_std(cc, weighted)
            return z_score(woe, wmean, wstd, cutoff)
        if t in (NormType.DISCRETE_ZSCORE, NormType.DISCRETE_ZSCALE):
            bnds = _nan_to(cc.bin_boundary, mean)
            table = bnds.copy()
            if cc.columnStats.min is not None:
                table[0] = cc.columnStats.min  # first bin uses the min value
            disc = _safe_gather(np.append(table, mean), bin_idx)  # missing->mean
            return z_score(disc, mean, std, cutoff)
        if t in (NormType.ASIS_WOE, NormType.ASIS_PR):
            return v
        # ZSCALE/ZSCORE/OLD_*/HYBRID*/ZSCALE_ONEHOT numeric / *_INDEX numeric
        return z_score(v, mean, std, cutoff)

    def _transform_categorical(self, bin_idx: np.ndarray) -> np.ndarray:
        cc, t, cutoff = self.cc, self.norm_type, self.cutoff
        if t in (NormType.ZSCALE_INDEX, NormType.ZSCORE_INDEX, NormType.WOE_INDEX,
                 NormType.WOE_ZSCALE_INDEX):
            return bin_idx.astype(np.float64)  # missing already = num categories
        if t in (NormType.WOE, NormType.WEIGHT_WOE, NormType.HYBRID,
                 NormType.WEIGHT_HYBRID, NormType.ASIS_WOE):
            weighted = t in (NormType.WEIGHT_WOE, NormType.WEIGHT_HYBRID)
            return _safe_gather(self._woe_table(weighted), bin_idx)
        if t in (NormType.WOE_ZSCORE, NormType.WOE_ZSCALE,
                 NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE):
            weighted = t in (NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE)
            woe = _safe_gather(self._woe_table(weighted), bin_idx)
            wmean, wstd = woe_mean_std(cc, weighted)
            return z_score(woe, wmean, wstd, cutoff)
        if t == NormType.ASIS_PR:
            return _safe_gather(self._posrate_table(), bin_idx)
        # ZSCALE family: posrate then z-score (OLD_* returns raw posrate)
        pr = _safe_gather(self._posrate_table(), bin_idx)
        if t in (NormType.OLD_ZSCALE, NormType.OLD_ZSCORE):
            return pr
        return z_score(pr, self.cc.mean(), self.cc.std_dev(), cutoff)


def _safe_gather(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    if len(table) == 0:
        return np.zeros(len(idx))
    return table[np.clip(idx, 0, len(table) - 1)]


def apply_precision(x: np.ndarray, precision: PrecisionType) -> np.ndarray:
    """Output rounding family, reference ``NormalizeUDF.java:540-570``."""
    if precision == PrecisionType.FLOAT7:
        return np.round(x, 7)
    if precision == PrecisionType.FLOAT16:
        return x.astype(np.float16).astype(np.float64)
    if precision == PrecisionType.FLOAT32:
        return x.astype(np.float32).astype(np.float64)
    return x
