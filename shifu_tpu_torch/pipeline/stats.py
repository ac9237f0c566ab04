"""`stats` step: per-column statistics + binning (+ PSI, correlation,
rebin) — the port of ``shifu_tpu.pipeline.stats``.

Streams the extracted chunks once (the fused sweep, default) or twice
(``-Dshifu.stats.onePass=false``, and MunroPat / MunroPatI exact binning)
through the numeric accumulator on the step's device — fine histograms by
kernel B3 — and the categorical one on the host, then fills every
``ColumnStats``/``ColumnBinning`` field the reference writes:
mean/std/min/max/median/p25/p75, missing counts, KS/IV/WOE (count +
weighted), per-bin counts/pos-rates/woe, skewness/kurtosis, PSI and
unitStats.  ``-correlation`` writes ``correlation.csv`` (the pair sums are
GEMMs on the step's device, :mod:`shifu_tpu_torch.ops.correlation`; on a
mesh each rank sums its block of every chunk and one float64 all_reduce
merges them),
``-rebin`` merges adjacent bins by IV, and
``-Dshifu.stats.checkpointChunks=N`` checkpoints the fused sweep every N
chunks to ``tmp/stats/partial_sweep.npz`` so an interrupted run resumes
(the ``stats:chunk`` fault site fires before each chunk).
``tmp/profile.json`` records the phases; with telemetry on each is a span,
and the step counts ``stats.rows``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .. import faults, obs
from ..config import ColumnConfig, environment
from ..config.model_config import BinningAlgorithm
from ..config.validator import ModelStep
from ..data.cells import missing_mask, stripped_cells
from ..data.extract import ChunkExtractor
from ..data.parsepool import iter_extracted
from ..data.reader import DataSource
from ..ioutil import atomic_savez, atomic_write_text
from ..ops.binning import (CATEGORY_GROUP_SEP, CategoricalAccumulator,
                           ColumnBinner, NumericAccumulator)
from ..ops.correlation import CorrelationAccumulator
from ..ops.stats_math import (column_metrics, merge_adjacent_by_iv,
                              pos_rate, psi)
from .processor import BasicProcessor

log = logging.getLogger(__name__)


class StatsProcessor(BasicProcessor):
    step = ModelStep.STATS

    def process(self) -> int:
        mc = self.model_config
        extractor = ChunkExtractor(mc, self.column_configs)
        num_cols = extractor.numeric_cols
        cat_cols = extractor.categorical_cols
        source = DataSource(self._abs(mc.dataSet.dataPath),
                            mc.dataSet.dataDelimiter,
                            header_path=self._abs(mc.dataSet.headerPath),
                            header_delimiter=mc.dataSet.headerDelimiter)
        exact_alg = mc.stats.binningAlgorithm in (BinningAlgorithm.MunroPat,
                                                  BinningAlgorithm.MunroPatI)
        from ..parallel.mesh import device_mesh
        # pure data-parallel mesh: every rank reads every chunk and keeps
        # its block of the rows (a world of one: the single-card layout)
        mesh = device_mesh()
        num_acc = NumericAccumulator(
            n_cols=len(num_cols), unit_weight=not extractor.weight_name,
            device=self.device, exact=exact_alg,
            fused_budget=environment.get_int(
                "shifu.stats.fusedBudgetBytes", 1 << 30), mesh=mesh)
        cat_acc = CategoricalAccumulator()
        psi_col = mc.stats.psiColumnName if self.params.get("psi") or \
            mc.stats.psiColumnName else None
        rate = float(mc.stats.sampleRate)
        # MunroPat materializes rows anyway: it keeps the two-pass flow
        fused = not exact_alg and environment.get_bool(
            "shifu.stats.onePass", True)
        want_corr = bool(self.params.get("correlation"))
        corr_acc = None
        missing_set = {m.strip().lower() for m in extractor.missing_values}

        # mid-sweep checkpoints (fused sweep only): every N chunks the
        # accumulators snapshot to tmp/stats/partial_sweep.npz and a crash
        # resumes at the first chunk after it.  0 = off (checkpointing
        # routes the sweep through the provisional grid).
        ckpt_chunks = environment.get_int("shifu.stats.checkpointChunks", 0)
        partial_path = self.paths.stats_partial_path
        sig = self._sweep_signature(source, fused, ckpt_chunks)
        items = self.journal.arm(sig, resume=bool(ckpt_chunks and fused))
        resume_chunk, total_rows = 0, 0
        if ckpt_chunks and fused and items.get("sweep"):
            restored = _load_partial(partial_path, _sig_hash(sig))
            if restored is not None:
                meta, arrays = restored
                resume_chunk = int(meta["chunk_next"])
                total_rows = int(meta["total_rows"])
                if num_cols:
                    num_acc.restore_checkpoint(
                        {k[4:]: v for k, v in arrays.items()
                         if k.startswith("num_")})
                cat_acc.load_state(meta["cat"], arrays)
                obs.counter("stats.resumed_chunks").inc(resume_chunk)
                log.info("stats: resuming fused sweep at chunk %d "
                         "(%d rows already accumulated)", resume_chunk,
                         total_rows)
        elif os.path.isfile(partial_path):
            try:                       # stale partial from another config
                os.remove(partial_path)
            except OSError:
                pass

        def save_partial(chunk_next: int, rows: int) -> None:
            arrays: Dict[str, np.ndarray] = {}
            if num_cols:
                for k, v in num_acc.checkpoint_state().items():
                    arrays["num_" + k] = v
            cat_meta, cat_arrays = cat_acc.state_lists()
            arrays.update(cat_arrays)
            meta = {"version": 1, "chunk_next": chunk_next,
                    "total_rows": rows, "sig": _sig_hash(sig),
                    "cat": cat_meta}
            arrays["__meta__"] = np.frombuffer(
                json.dumps(meta).encode(), np.uint8)
            atomic_savez(partial_path, **arrays)
            self.journal.commit_item("sweep", files=[partial_path],
                                     chunk_next=chunk_next)

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

        sweep_t0 = time.perf_counter()
        if fused:
            with self.phase("fused_sweep") as ph:
                for ci, ex in iter_extracted(
                        source, extractor, rate=rate,
                        cache_root=self.paths.raw_cache_dir,
                        start_chunk=resume_chunk):
                    faults.fire("stats", "chunk", ci)
                    if ex.n == 0:
                        continue
                    total_rows += ex.n
                    tgt = binarized(ex)
                    if num_cols:
                        num_acc.update_fused(ex.numeric, ex.numeric_valid,
                                             tgt, ex.weight)
                        # a resumed sweep skipped chunks the piggyback
                        # correlation never saw: it takes the full pass
                        # below instead (corr_acc stays None)
                        if want_corr and not cat_cols and not resume_chunk:
                            if corr_acc is None:
                                # the first chunk's means condition the
                                # f32 sums
                                with np.errstate(invalid="ignore"):
                                    off = np.nanmean(np.where(
                                        ex.numeric_valid, ex.numeric,
                                        np.nan), axis=0)
                                corr_acc = CorrelationAccumulator(
                                    n_cols=len(num_cols),
                                    offset=np.nan_to_num(off),
                                    device=self.device, mesh=mesh)
                            corr_acc.update(np.nan_to_num(ex.numeric),
                                            ex.numeric_valid)
                    cat_update(ex, tgt)
                    if ckpt_chunks and (ci + 1) % ckpt_chunks == 0:
                        save_partial(ci + 1, total_rows)
                ph.set(rows=total_rows)
            if total_rows == 0:
                raise RuntimeError("stats: dataset is empty after "
                                   "filtering")
            if num_cols:
                num_acc.finalize_fused()
        else:
            with self.phase("pass1_moments") as ph:
                for ci, ex in iter_extracted(
                        source, extractor, rate=rate,
                        cache_root=self.paths.raw_cache_dir):
                    faults.fire("stats", "chunk", ci)
                    if ex.n == 0:
                        continue
                    total_rows += ex.n
                    if num_cols:
                        num_acc.update_moments(ex.numeric, ex.numeric_valid)
                ph.set(rows=total_rows)
            if total_rows == 0:
                raise RuntimeError("stats: dataset is empty after "
                                   "filtering")
            if num_cols:
                num_acc.finalize_range()
            # correlation rides pass 2 when only numerics take part (the
            # categorical pos-rate encodings need finished bin stats)
            if want_corr and num_cols and not cat_cols:
                corr_acc = CorrelationAccumulator(
                    n_cols=len(num_cols), offset=num_acc.moments["mean"],
                    device=self.device, mesh=mesh)
            with self.phase("pass2_histograms").set(rows=total_rows):
                for _, ex in iter_extracted(
                        source, extractor, rate=rate,
                        cache_root=self.paths.raw_cache_dir):
                    if ex.n == 0:
                        continue
                    tgt = binarized(ex)
                    if num_cols:
                        num_acc.update_histogram(ex.numeric,
                                                 ex.numeric_valid,
                                                 tgt, ex.weight)
                        if corr_acc is not None:
                            corr_acc.update(np.nan_to_num(ex.numeric),
                                            ex.numeric_valid)
                    cat_update(ex, tgt)
        with self.phase("finalize"):
            if num_cols:
                self._finalize_numeric(num_cols, num_acc, total_rows)
            self._finalize_categorical(cat_cols, cat_acc, total_rows)
        if want_corr:
            with self.phase("correlation"):
                if corr_acc is not None:  # numeric-only: rode the sweep
                    self._write_corr_matrix(
                        corr_acc.finalize(),
                        [c.columnName for c in num_cols], 0)
                else:
                    self._compute_correlation(source, extractor, rate)
        if psi_col:
            with self.phase("psi"):
                self._compute_psi(source, extractor, psi_col)
        obs.counter("stats.rows").inc(total_rows)
        obs.gauge("stats.columns").set(len(num_cols) + len(cat_cols))
        obs.gauge("stats.rows_per_sec").set(
            total_rows / max(time.perf_counter() - sweep_t0, 1e-9))
        if self.params.get("rebin"):
            self._dynamic_rebin()
        self.save_column_configs()
        if os.path.isfile(partial_path):
            try:                       # the sweep committed: drop partials
                os.remove(partial_path)
            except OSError:
                pass
        log.info("stats: %d rows, %d numeric, %d categorical columns",
                 total_rows, len(num_cols), len(cat_cols))
        return 0

    def _sweep_signature(self, source: DataSource, fused: bool,
                         ckpt_chunks: int) -> dict:
        """Inputs + config identity a resumed sweep must match."""
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
                "checkpointChunks": int(ckpt_chunks)}

    # ------------------------------------------------------------- numeric
    def _finalize_numeric(self, num_cols: List[ColumnConfig],
                          acc: NumericAccumulator, total_rows: int) -> None:
        mc = self.model_config
        # MunroPat / MunroPatI: exact data quantiles, bin counts from the
        # kept rows; otherwise the fine-histogram sketch reduced on the
        # device (finalize_sketch)
        if acc.exact:
            boundaries = acc.compute_boundaries_exact(mc.stats.binningMethod,
                                                      mc.stats.maxNumBin)
            aggs = [acc.bin_counts_exact(i, b)
                    for i, b in enumerate(boundaries)]
            pcts = [acc.percentile(i, [0.25, 0.5, 0.75])
                    for i in range(len(num_cols))]
            distinct = [acc.distinct_estimate(i)
                        for i in range(len(num_cols))]
        else:
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


    # -------------------------------------------------------------- extras
    def _compute_correlation(self, source: DataSource,
                             extractor: ChunkExtractor,
                             rate: float) -> None:
        """Pairwise-complete Pearson over every candidate: numerics by
        value, categoricals by their bin pos-rate encoding (reference
        ``CorrelationMapper``); each pair's sums count only rows valid in
        both columns."""
        num_cols = extractor.numeric_cols
        cat_cols = extractor.categorical_cols
        cols = num_cols + cat_cols
        rate_maps = {}
        for cc in cat_cols:
            cats = cc.bin_category or []
            pr = cc.columnBinning.binPosRate or []
            rate_maps[cc.columnName] = {str(c): float(pr[i])
                                        for i, c in enumerate(cats)
                                        if i < len(pr) and pr[i] is not None}
        # offsets: the column means for numerics, 0.5 for pos-rates
        num_means = [c.columnStats.mean or 0.0 for c in num_cols]
        from ..parallel.mesh import device_mesh
        acc = CorrelationAccumulator(
            n_cols=len(cols),
            offset=np.asarray(num_means + [0.5] * len(cat_cols)),
            device=self.device, mesh=device_mesh())
        miss = {m.strip().lower() for m in extractor.missing_values}
        for _, ex in iter_extracted(source, extractor, rate=rate,
                                    cache_root=self.paths.raw_cache_dir):
            if ex.n == 0:
                continue
            x = np.zeros((ex.n, len(cols)))
            v = np.zeros((ex.n, len(cols)), bool)
            if num_cols:
                x[:, :len(num_cols)] = np.nan_to_num(ex.numeric)
                v[:, :len(num_cols)] = ex.numeric_valid
            for j, cc in enumerate(cat_cols):
                # one lookup a distinct value of the chunk
                vals = np.asarray(ex.categorical[cc.columnName], object)
                uniq, inv = np.unique(vals, return_inverse=True)
                rmap = rate_maps[cc.columnName]
                enc = np.zeros(len(uniq))
                ok = np.zeros(len(uniq), bool)
                for k, val in enumerate(uniq):
                    s = str(val).strip()
                    r = rmap.get(s)
                    if r is not None and s.lower() not in miss:
                        enc[k], ok[k] = r, True
                x[:, len(num_cols) + j] = enc[inv.reshape(-1)]
                v[:, len(num_cols) + j] = ok[inv.reshape(-1)]
            acc.update(x, v)
        self._write_corr_matrix(acc.finalize(),
                                [c.columnName for c in cols], len(cat_cols))

    def _write_corr_matrix(self, corr: np.ndarray, names: List[str],
                           n_cat: int) -> None:
        path = self.paths.correlation_path
        lines = ["," + ",".join(names)]
        for i, n in enumerate(names):
            lines.append(n + "," + ",".join(
                f"{corr[i, j]:.6f}" for j in range(len(names))))
        atomic_write_text(path, "\n".join(lines) + "\n")
        log.info("correlation matrix (%d columns incl. %d categorical) -> %s",
                 len(names), n_cat, path)

    def _compute_psi(self, source: DataSource, extractor: ChunkExtractor,
                     psi_col: str) -> None:
        """PSI across the units of ``psiColumnName`` (e.g. a time bucket):
        each unit's bin distribution against the overall one, one flat
        count over (unit, column, bin) a chunk."""
        binners = {}
        for cc in self.column_configs:
            if not cc.is_candidate() or cc.num_bins() == 0:
                continue
            if cc.is_categorical():
                binners[cc.columnName] = (cc, ColumnBinner(
                    categories=cc.bin_category))
            else:
                binners[cc.columnName] = (cc, ColumnBinner(
                    boundaries=np.asarray(cc.bin_boundary)))
        col_list = list(binners.items())
        nb_list = [binner.num_bins + 1 for _, (_, binner) in col_list]
        offsets = np.concatenate([[0], np.cumsum(nb_list)]).astype(np.int64)
        total_bins = int(offsets[-1])
        unit_ids: Dict[str, int] = {}
        acc = np.zeros((0, total_bins), np.float64)   # [units, packed bins]
        rate = float(self.model_config.stats.sampleRate)
        if psi_col not in source.header:
            log.warning("psi column %s not found; skipping PSI", psi_col)
            return
        # keep_raw: the unit column rides the raw string columns, so this
        # pass parses and never reads or writes the raw cache
        for _, ex in iter_extracted(source, extractor, rate=rate,
                                    keep_raw=True):
            if ex.n == 0:
                continue
            units = np.asarray(ex.raw.data[psi_col])
            num_index = {c.columnName: i
                         for i, c in enumerate(ex.numeric_cols)}
            idx_mat = np.empty((ex.n, len(col_list)), np.int64)
            for col_i, (name, (cc, binner)) in enumerate(col_list):
                if cc.is_categorical():
                    idx = binner.bin_categorical(ex.categorical[name])
                else:
                    j = num_index[name]
                    idx = binner.bin_numeric(ex.numeric[:, j],
                                             ex.numeric_valid[:, j])
                idx_mat[:, col_i] = np.asarray(idx, np.int64) + offsets[col_i]
            for u in np.unique(units):
                unit_ids.setdefault(u, len(unit_ids))
            if len(unit_ids) > acc.shape[0]:
                acc = np.vstack([acc, np.zeros(
                    (len(unit_ids) - acc.shape[0], total_bins), np.float64)])
            uvec = np.fromiter((unit_ids[u] for u in units), np.int64,
                               count=len(units))
            flat = uvec[:, None] * total_bins + idx_mat
            counts = np.bincount(flat.ravel(),
                                 minlength=len(unit_ids) * total_bins)
            acc += counts.reshape(len(unit_ids), total_bins)
        if not unit_ids:
            return
        units_sorted = sorted(unit_ids.items(), key=lambda kv: kv[0])
        by_name = {name: ci for ci, (name, _) in enumerate(col_list)}
        for cc in self.column_configs:
            ci = by_name.get(cc.columnName)
            if ci is None:
                continue
            s, e = offsets[ci], offsets[ci + 1]
            overall = acc[:, s:e].sum(axis=0)
            vals = [psi(overall, acc[unit_ids[u], s:e])
                    for u, _ in units_sorted]
            cc.columnStats.psi = _f(np.nanmax(vals)) if vals else None
            cc.columnStats.unitStats = [
                f"{u}:{psi(overall, acc[uid, s:e]):.6f}"
                for u, uid in units_sorted]

    def _dynamic_rebin(self) -> None:
        """``stats -rebin``: IV-driven merge of adjacent value bins
        (reference ``DynamicBinningUDF`` / ``AutoDynamicBinning``), with
        ``-Dshifu.rebin.maxNumBin`` / ``-Dshifu.rebin.ivKeepRatio`` /
        ``-Dshifu.rebin.minBinInstCnt`` (``-ivr`` / ``-bic`` override the
        last two; ``-vars`` names the columns)."""
        from ..config.column_config import ns_in
        target = int(environment.get_property(
            "shifu.rebin.maxNumBin", self.model_config.stats.maxNumBin))
        ivr = self.params.get("rebin_ivr")
        iv_keep = float(ivr) if ivr is not None else \
            float(environment.get_property("shifu.rebin.ivKeepRatio", 0.95))
        bic = self.params.get("rebin_bic")
        min_inst = int(bic) if bic is not None else \
            int(environment.get_property("shifu.rebin.minBinInstCnt", 0))
        only = {v.strip() for v in
                (self.params.get("rebin_vars") or "").split(",")
                if v.strip()}
        merged_cols = 0
        for cc in self.column_configs:
            if only and not ns_in(cc.columnName, only):
                continue
            bn = cc.columnBinning
            if not bn.binCountNeg or len(bn.binCountNeg) < 4:
                continue
            neg, pos = bn.binCountNeg[:-1], bn.binCountPos[:-1]
            if cc.is_categorical():
                # categories by pos rate, so "adjacent" means something
                rate = [(p / max(p + n, 1e-9)) for p, n in zip(pos, neg)]
                order = sorted(range(len(rate)), key=lambda i: rate[i])
            else:
                order = list(range(len(neg)))
            groups = merge_adjacent_by_iv(
                np.asarray([neg[i] for i in order], np.float64),
                np.asarray([pos[i] for i in order], np.float64),
                target, iv_keep, min_inst)
            if len(groups) >= len(neg):
                continue
            merged_cols += 1
            groups = [[order[i] for i in g] for g in groups]
            if cc.is_categorical():
                bn.binCategory = [CATEGORY_GROUP_SEP.join(
                    bn.binCategory[i] for i in g) for g in groups]
            else:
                bn.binBoundary = [bn.binBoundary[g[0]] for g in groups]
            miss_n, miss_p = bn.binCountNeg[-1], bn.binCountPos[-1]
            wmiss_n, wmiss_p = bn.binWeightedNeg[-1], bn.binWeightedPos[-1]
            bn.binCountNeg = _merge_vals(bn.binCountNeg[:-1], groups) \
                + [miss_n]
            bn.binCountPos = _merge_vals(bn.binCountPos[:-1], groups) \
                + [miss_p]
            bn.binWeightedNeg = _merge_vals(bn.binWeightedNeg[:-1],
                                            groups) + [wmiss_n]
            bn.binWeightedPos = _merge_vals(bn.binWeightedPos[:-1],
                                            groups) + [wmiss_p]
            bn.length = len(groups) + 1
            neg_a = np.asarray(bn.binCountNeg, np.float64)[None, :]
            pos_a = np.asarray(bn.binCountPos, np.float64)[None, :]
            wneg_a = np.asarray(bn.binWeightedNeg, np.float64)[None, :]
            wpos_a = np.asarray(bn.binWeightedPos, np.float64)[None, :]
            cm = column_metrics(neg_a, pos_a)
            wm = column_metrics(wneg_a, wpos_a)
            tot = neg_a + pos_a
            bn.binPosRate = _fl(np.where(tot > 0, pos_a / np.maximum(tot, 1),
                                         np.nan)[0])
            bn.binCountWoe = _fl(cm.bin_woe[0])
            bn.binWeightedWoe = _fl(wm.bin_woe[0])
            st = cc.columnStats
            st.ks, st.iv, st.woe = _f(cm.ks[0]), _f(cm.iv[0]), _f(cm.woe[0])
            st.weightedKs, st.weightedIv = _f(wm.ks[0]), _f(wm.iv[0])
            st.weightedWoe = _f(wm.woe[0])
        log.info("rebin: merged bins in %d columns (target %d, ivKeep %.2f)",
                 merged_cols, target, iv_keep)


def _sig_hash(sig: dict) -> str:
    return hashlib.md5(
        json.dumps(sig, sort_keys=True).encode()).hexdigest()


def _load_partial(path: str, sig_hash: str):
    """(meta, arrays) of a mid-sweep partial, or None when missing, torn,
    or written under another input/config signature."""
    import zipfile
    try:
        data = np.load(path)
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != 1 or meta.get("sig") != sig_hash:
            return None
        return meta, {k: data[k] for k in data.files if k != "__meta__"}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def _merge_vals(vals, groups):
    return [sum(vals[i] for i in g) for g in groups]

def _f(x) -> Optional[float]:
    if x is None:
        return None
    x = float(x)
    return None if math.isnan(x) or math.isinf(x) else x


def _fl(arr) -> List[Optional[float]]:
    return [(_f(x) if x == x else None)
            for x in np.asarray(arr, dtype=np.float64)]
