"""`stats` step: per-column statistics + binning — the port of
``shifu_tpu.pipeline.stats``.

Streams the extracted chunks once (the fused sweep, default) or twice
(``-Dshifu.stats.onePass=false``) through the numeric accumulator on the
step's device — fine histograms by kernel B3 — and the categorical one on
the host, then fills every ``ColumnStats``/``ColumnBinning`` field the
reference writes: mean/std/min/max/median/p25/p75, missing counts,
KS/IV/WOE (count + weighted), per-bin counts/pos-rates/woe,
skewness/kurtosis.  ``tmp/profile.json`` records the phases.

Not ported yet (ROADMAP Queue 1 item 2): ``-correlation``, PSI
(``psiColumnName``), ``-rebin``, MunroPat exact binning and the mid-sweep
checkpoints (``shifu.stats.checkpointChunks``); the telemetry counters and
fault-injection sites stay out (item 13).
"""

from __future__ import annotations

import logging
import math
import os
from typing import List, Optional

import numpy as np

from ..config import ColumnConfig, environment
from ..config.model_config import BinningAlgorithm
from ..config.validator import ModelStep
from ..data.cells import missing_mask, stripped_cells
from ..data.extract import ChunkExtractor
from ..data.parsepool import iter_extracted
from ..data.reader import DataSource
from ..ops.binning import CategoricalAccumulator, NumericAccumulator
from ..ops.stats_math import column_metrics, pos_rate
from .processor import BasicProcessor

log = logging.getLogger(__name__)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to shifu_tpu_torch yet (ROADMAP Queue 1 "
        "item 2)")


class StatsProcessor(BasicProcessor):
    step = ModelStep.STATS

    def process(self) -> int:
        mc = self.model_config
        if mc.stats.psiColumnName:
            raise _not_ported(f"PSI (stats.psiColumnName "
                              f"{mc.stats.psiColumnName!r})")
        if mc.stats.binningAlgorithm in (BinningAlgorithm.MunroPat,
                                         BinningAlgorithm.MunroPatI):
            raise _not_ported(f"{mc.stats.binningAlgorithm.value} exact "
                              "binning")
        if environment.get_int("shifu.stats.checkpointChunks", 0):
            raise _not_ported("mid-sweep stats checkpoints "
                              "(shifu.stats.checkpointChunks)")
        extractor = ChunkExtractor(mc, self.column_configs)
        num_cols = extractor.numeric_cols
        cat_cols = extractor.categorical_cols
        source = DataSource(self._abs(mc.dataSet.dataPath),
                            mc.dataSet.dataDelimiter,
                            header_path=self._abs(mc.dataSet.headerPath),
                            header_delimiter=mc.dataSet.headerDelimiter)
        num_acc = NumericAccumulator(
            n_cols=len(num_cols), unit_weight=not extractor.weight_name,
            device=self.device, fused_budget=environment.get_int(
                "shifu.stats.fusedBudgetBytes", 1 << 30))
        cat_acc = CategoricalAccumulator()
        rate = float(mc.stats.sampleRate)
        fused = environment.get_bool("shifu.stats.onePass", True)
        # the sweep's identity, kept in the STATS journal
        self.journal.arm(self._sweep_signature(source, fused))
        missing_set = {m.strip().lower() for m in extractor.missing_values}

        def cat_update(ex, tgt) -> None:
            for cc in cat_cols:
                vals = ex.categorical[cc.columnName]
                cells = stripped_cells(vals)
                if cells is None:             # no S view: object arrays
                    s = [str(v).strip() for v in vals]
                    valid = np.fromiter((v.lower() not in missing_set
                                         for v in s), bool, len(s))
                    cat_acc.update(cc.columnName, s, valid, tgt, ex.weight,
                                   stripped=True)
                else:
                    cat_acc.update_cells(cc.columnName, cells,
                                         ~missing_mask(cells, missing_set),
                                         tgt, ex.weight)

        def binarized(ex):
            # multi-class: bin pos/neg stats binarize as class 0 vs rest
            return (ex.target > 0).astype(ex.target.dtype) \
                if extractor.multiclass else ex.target

        total_rows = 0
        if fused:
            with self.phase("fused_sweep"):
                for _, ex in iter_extracted(source, extractor, rate=rate):
                    if ex.n == 0:
                        continue
                    total_rows += ex.n
                    tgt = binarized(ex)
                    if num_cols:
                        num_acc.update_fused(ex.numeric, ex.numeric_valid,
                                             tgt, ex.weight)
                    cat_update(ex, tgt)
            if total_rows == 0:
                raise RuntimeError("stats: dataset is empty after "
                                   "filtering")
            if num_cols:
                num_acc.finalize_fused()
        else:
            with self.phase("pass1_moments"):
                for _, ex in iter_extracted(source, extractor, rate=rate):
                    if ex.n == 0:
                        continue
                    total_rows += ex.n
                    if num_cols:
                        num_acc.update_moments(ex.numeric, ex.numeric_valid)
            if total_rows == 0:
                raise RuntimeError("stats: dataset is empty after "
                                   "filtering")
            if num_cols:
                num_acc.finalize_range()
            with self.phase("pass2_histograms"):
                for _, ex in iter_extracted(source, extractor, rate=rate):
                    if ex.n == 0:
                        continue
                    tgt = binarized(ex)
                    if num_cols:
                        num_acc.update_histogram(ex.numeric,
                                                 ex.numeric_valid,
                                                 tgt, ex.weight)
                    cat_update(ex, tgt)
        with self.phase("finalize"):
            if num_cols:
                self._finalize_numeric(num_cols, num_acc, total_rows)
            self._finalize_categorical(cat_cols, cat_acc, total_rows)
        self.save_column_configs()
        log.info("stats: %d rows, %d numeric, %d categorical columns",
                 total_rows, len(num_cols), len(cat_cols))
        return 0

    def _sweep_signature(self, source: DataSource, fused: bool) -> dict:
        """Inputs + config identity of the sweep."""
        mc = self.model_config
        files = []
        for f in source.files:
            try:
                st = os.stat(f)
                files.append([os.path.basename(f), st.st_size,
                              st.st_mtime_ns])
            except OSError:
                files.append([f, None, None])
        return {"files": files,
                "sampleRate": float(mc.stats.sampleRate),
                "binningAlgorithm": mc.stats.binningAlgorithm.value,
                "binningMethod": mc.stats.binningMethod.value,
                "maxNumBin": int(mc.stats.maxNumBin),
                "fused": bool(fused),
                "checkpointChunks": 0}

    # ------------------------------------------------------------- numeric
    def _finalize_numeric(self, num_cols: List[ColumnConfig],
                          acc: NumericAccumulator, total_rows: int) -> None:
        mc = self.model_config
        boundaries, aggs, pcts, distinct = acc.finalize_sketch(
            mc.stats.binningMethod, mc.stats.maxNumBin)
        # skew/kurt directly from central moments
        cnt = np.maximum(acc.moments["count"], 1.0)
        m2 = acc.moments["M2"] / cnt
        m3 = acc.moments["M3"] / cnt
        m4 = acc.moments["M4"] / cnt
        with np.errstate(invalid="ignore", divide="ignore"):
            skew = np.where(m2 > 0, m3 / np.power(np.maximum(m2, 1e-300), 1.5), 0.0)
            kurt = np.where(m2 > 0, m4 / np.maximum(m2 ** 2, 1e-300) - 3.0, 0.0)
            std = np.sqrt(acc.moments["M2"] / np.maximum(cnt - 1, 1.0))

        for i, cc in enumerate(num_cols):
            bnds, agg = boundaries[i], aggs[i]         # agg [bins+1, 4]
            cpos, cneg, wpos, wneg = agg[:, 0], agg[:, 1], agg[:, 2], agg[:, 3]
            cm = column_metrics(cneg[None, :], cpos[None, :])
            wm = column_metrics(wneg[None, :], wpos[None, :])
            st, bn = cc.columnStats, cc.columnBinning
            count = float(acc.moments["count"][i])
            st.totalCount = total_rows
            st.validNumCount = int(count)
            st.missingCount = int(acc.missing[i])
            st.missingPercentage = float(acc.missing[i] / max(total_rows, 1))
            st.min = _f(acc.moments["min"][i] if count else None)
            st.max = _f(acc.moments["max"][i] if count else None)
            st.mean = _f(acc.moments["mean"][i] if count else None)
            st.stdDev = _f(std[i] if count > 1 else None)
            st.skewness = _f(skew[i])
            st.kurtosis = _f(kurt[i])
            p = pcts[i]
            st.p25th, st.median, st.p75th = _f(p[0]), _f(p[1]), _f(p[2])
            st.distinctCount = int(distinct[i])
            st.ks = _f(cm.ks[0])
            st.iv = _f(cm.iv[0])
            st.woe = _f(cm.woe[0])
            st.weightedKs = _f(wm.ks[0])
            st.weightedIv = _f(wm.iv[0])
            st.weightedWoe = _f(wm.woe[0])
            bn.length = len(bnds) + 1
            bn.binBoundary = [float(b) for b in bnds]
            bn.binCategory = None
            bn.extra["binningAlgorithm"] = mc.stats.binningAlgorithm.value
            bn.binCountNeg = [int(x) for x in cneg]
            bn.binCountPos = [int(x) for x in cpos]
            bn.binWeightedNeg = [float(x) for x in wneg]
            bn.binWeightedPos = [float(x) for x in wpos]
            bn.binPosRate = _fl(pos_rate(cpos, cneg))
            bn.binCountWoe = _fl(cm.bin_woe[0])
            bn.binWeightedWoe = _fl(wm.bin_woe[0])

    # --------------------------------------------------------- categorical
    def _finalize_categorical(self, cat_cols: List[ColumnConfig],
                              acc: CategoricalAccumulator,
                              total_rows: int) -> None:
        mc = self.model_config
        # reference hard cap regardless of cateMaxNumBin=0 ("uncapped"):
        # Constants.MAX_CATEGORICAL_BINC_COUNT = 10000
        max_cates = min(mc.stats.cateMaxNumBin or 10000, 10000)
        for cc in cat_cols:
            cats, counts, n_distinct, n_missing = acc.finalize(
                cc.columnName, max_cates)
            cpos, cneg, wpos, wneg = (counts[:, 0], counts[:, 1],
                                      counts[:, 2], counts[:, 3])
            cm = column_metrics(cneg[None, :], cpos[None, :])
            wm = column_metrics(wneg[None, :], wpos[None, :])
            st, bn = cc.columnStats, cc.columnBinning
            st.totalCount = total_rows
            st.validNumCount = total_rows - n_missing
            st.missingCount = n_missing
            st.missingPercentage = n_missing / max(total_rows, 1)
            st.distinctCount = n_distinct
            pr = pos_rate(cpos, cneg)
            st.ks = _f(cm.ks[0])
            st.iv = _f(cm.iv[0])
            st.woe = _f(cm.woe[0])
            st.weightedKs = _f(wm.ks[0])
            st.weightedIv = _f(wm.iv[0])
            st.weightedWoe = _f(wm.woe[0])
            # categorical "mean/std": pos-rate weighted stats, as the
            # reference reuses posRate as the numeric encoding of a category
            tot = cpos + cneg
            if tot.sum() > 0:
                mean = float(np.nansum(pr * tot) / tot.sum())
                st.mean = mean
                st.stdDev = float(np.sqrt(
                    np.nansum((np.nan_to_num(pr) - mean) ** 2 * tot)
                    / max(tot.sum() - 1, 1)))
            bn.length = len(cats) + 1
            bn.binCategory = list(cats)
            bn.binBoundary = None
            bn.binCountNeg = [int(x) for x in cneg]
            bn.binCountPos = [int(x) for x in cpos]
            bn.binWeightedNeg = [float(x) for x in wneg]
            bn.binWeightedPos = [float(x) for x in wpos]
            bn.binPosRate = _fl(pr)
            bn.binCountWoe = _fl(cm.bin_woe[0])
            bn.binWeightedWoe = _fl(wm.bin_woe[0])


def _f(x) -> Optional[float]:
    if x is None:
        return None
    x = float(x)
    return None if math.isnan(x) or math.isinf(x) else x


def _fl(arr) -> List[Optional[float]]:
    return [(_f(x) if x == x else None)
            for x in np.asarray(arr, dtype=np.float64)]
