"""`export` step — the port of ``shifu_tpu.pipeline.export`` (reference
``ExportModelProcessor.java:70-163``): ``pmml | baggingpmml | bagging |
columnstats | woemapping | woe | corr | spec``.

Host code, as in the reference: XML documents, CSV tables, file copies
and Java byte streams, written from the same model files and
``ColumnConfig.json`` by the same code paths, so every file equals the
reference's (a ``spec`` file's gzip header aside, which carries the time
of writing).  ``corr`` copies ``stats -correlation``'s matrix (either
package's ``stats`` writes it); without it ``corr`` fails with the
reference's message.  ``spec`` writes NN, tree
and WDL members in the reference's formats and skips a kernel SVM, which
has none; ``pmml`` refuses WDL and kernel SVM models with the
reference's messages.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import List, Optional

from .. import ioutil
from ..config.validator import ModelStep
from .processor import BasicProcessor

log = logging.getLogger(__name__)


class ExportProcessor(BasicProcessor):
    step = ModelStep.EXPORT

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None):
        super().__init__(model_set_dir, params, device="cpu")   # host step

    def process(self) -> int:
        t = (self.params.get("type") or "pmml").lower()
        os.makedirs(self.paths.export_dir, exist_ok=True)
        if t in ("pmml", "baggingpmml"):
            # pmml already walks EVERY bagged member (model0..B) — the
            # reference's separate baggingpmml path collapses into it
            # (ExportModelProcessor.java:76-84)
            return self._export_pmml()
        if t == "bagging":
            return self._export_bagging()
        if t == "columnstats":
            return self._export_columnstats()
        if t in ("woemapping", "woe"):
            return self._export_woe()
        if t == "corr":
            return self._export_corr()
        if t in ("spec", "ref", "reference"):
            return self._export_reference_spec()
        log.error("unknown export type %s", t)
        return 1

    def _export_reference_spec(self) -> int:
        """`export -t spec`: emit every trained member in the reference's
        own serialized formats — Encog-EG ``model*.nn``,
        ``BinaryDTSerializer`` ``model*.gbt``/``model*.rf`` and
        ``BinaryWDLSerializer`` ``model*.wdl`` — so the reference's
        dependency-free Java consumers (``IndependentNNModel``,
        ``IndependentTreeModel``, ``IndependentWDLModel``, ``shifu
        convert``) load them unchanged (reference model-spec layer,
        ``BinaryDTSerializer.java:60-160``)."""
        from ..eval.scorer import discover_model_paths
        from ..export import reference_spec as ref
        from ..models import load_any
        paths = discover_model_paths(self.paths.models_dir)
        if not paths:
            log.error("no models to export — run `train` first")
            return 1
        out_dir = os.path.join(self.paths.export_dir, "reference")
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for i, p in enumerate(paths):
            m = load_any(p)
            kind = type(m).__name__
            try:
                if kind == "IndependentNNModel":
                    out = os.path.join(out_dir, f"model{i}.nn")
                    ref.write_encog_nn(out, m.spec, m.params)
                elif kind == "IndependentTreeModel":
                    suffix = "gbt" if m.spec.algorithm == "GBT" else "rf"
                    out = os.path.join(out_dir, f"model{i}.{suffix}")
                    ref.write_reference_tree(out, m.spec, m.trees,
                                             self.column_configs)
                elif kind == "IndependentWDLModel":
                    out = os.path.join(out_dir, f"model{i}.wdl")
                    ref.write_reference_wdl(out, m.spec, m.params,
                                            self.column_configs)
                else:
                    log.warning("model %s (%s): no reference format; "
                                "skipped", p, kind)
                    continue
            except Exception as e:
                log.error("reference export of %s failed: %s", p, e)
                return 1
            log.info("reference spec -> %s", out)
            n += 1
        if n == 0:
            log.error("reference export: no model had a reference format")
            return 1
        log.info("reference export: %d model(s) -> %s", n, out_dir)
        return 0

    def _export_bagging(self) -> int:
        """Bundle all bagged members + an ensemble manifest into export/
        (reference EXPORT_BAGGING: one spec that scores the whole
        ensemble)."""
        import shutil

        from ..eval.scorer import discover_model_paths
        paths = discover_model_paths(self.paths.models_dir)
        if not paths:
            log.error("no models to export — run `train` first")
            return 1
        out_dir = os.path.join(self.paths.export_dir, "bagging")
        os.makedirs(out_dir, exist_ok=True)
        members = []
        for p in paths:
            shutil.copy(p, os.path.join(out_dir, os.path.basename(p)))
            members.append(os.path.basename(p))
        sel = self.model_config.evals[0].performanceScoreSelector \
            if self.model_config.evals else "mean"
        ioutil.atomic_write_json(
            os.path.join(out_dir, "ensemble.json"),
            {"modelSet": self.model_config.basic.name,
             "members": members, "scoreSelector": sel or "mean"})
        log.info("bagging export: %d member(s) -> %s", len(members), out_dir)
        return 0

    def _export_pmml(self) -> int:
        from ..export import pmml as pmml_mod
        from ..models import spec_kind
        import glob
        mc = self.model_config
        columns = [c for c in self.column_configs
                   if (c.finalSelect or c.is_force_select()) and c.is_candidate()]
        if not columns:
            columns = [c for c in self.column_configs
                       if c.is_candidate() and c.num_bins() > 0]
        paths = sorted(p for p in glob.glob(
            os.path.join(self.paths.models_dir, "model*.*"))
            if not p.endswith(".json"))
        if not paths:
            log.error("no models to export — run `train` first")
            return 1
        from ..export.pmml import PmmlUnsupportedError
        # reference `export -c`: concise PMML trims the per-bin stats
        # extensions (ShifuCLI.java:366, ModelStatsCreator isConcise)
        concise = bool(self.params.get("concise"))
        for i, mp in enumerate(paths):
            kind = spec_kind(mp)
            try:
                if kind == "tree":
                    from ..models import tree as tree_model
                    spec, trees = tree_model.load_model(mp)
                    doc = pmml_mod.tree_to_pmml(mc, columns, spec, trees,
                                                concise=concise)
                elif kind == "wdl":
                    raise PmmlUnsupportedError(
                        "WDL (embedding) models have no PMML mapping yet — "
                        "use the native .wdl spec")
                elif kind == "svm":
                    raise PmmlUnsupportedError(
                        "kernel SVM models have no PMML mapping (the "
                        "reference's PMML layer covers NN/LR/trees only) — "
                        "use the native .svm spec")
                else:
                    from ..models import nn as nn_model
                    spec, params = nn_model.load_model(mp)
                    if spec.hidden_nodes:
                        doc = pmml_mod.nn_to_pmml(mc, columns, spec, params,
                                                  concise=concise)
                    else:
                        doc = pmml_mod.lr_to_pmml(mc, columns, spec, params,
                                                  concise=concise)
            except PmmlUnsupportedError as e:
                log.error("pmml export of %s failed: %s", mp, e)
                return 1
            out = self.paths.pmml_path(i)
            pmml_mod.write_pmml(doc, out)
            log.info("pmml -> %s", out)
        return 0

    def _export_columnstats(self) -> int:
        out = os.path.join(self.paths.export_dir, "columnstats.csv")
        cols = ["columnNum", "columnName", "columnType", "columnFlag",
                "finalSelect", "max", "min", "mean", "median", "stdDev",
                "missingPercentage", "totalCount", "distinctCount", "ks",
                "iv", "woe", "weightedKs", "weightedIv", "weightedWoe", "psi",
                "skewness", "kurtosis"]
        with ioutil.atomic_open(out, newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for cc in self.column_configs:
                st = cc.columnStats
                w.writerow([cc.columnNum, cc.columnName, cc.columnType.value,
                            cc.columnFlag.value if cc.columnFlag else "",
                            cc.finalSelect, st.max, st.min, st.mean, st.median,
                            st.stdDev, st.missingPercentage, st.totalCount,
                            st.distinctCount, st.ks, st.iv, st.woe,
                            st.weightedKs, st.weightedIv, st.weightedWoe,
                            st.psi, st.skewness, st.kurtosis])
        log.info("columnstats -> %s", out)
        return 0

    def _export_woe(self) -> int:
        out = os.path.join(self.paths.export_dir, "woemapping.csv")
        with ioutil.atomic_open(out, newline="") as f:
            w = csv.writer(f)
            w.writerow(["columnNum", "columnName", "bin", "binLabel",
                        "countWoe", "weightedWoe"])
            for cc in self.column_configs:
                bn = cc.columnBinning
                if not bn.binCountWoe:
                    continue
                labels = (bn.binCategory if cc.is_categorical()
                          else _interval_labels(bn.binBoundary or []))
                labels = list(labels) + ["MISSING"]
                for i, woe in enumerate(bn.binCountWoe):
                    lab = labels[i] if i < len(labels) else f"bin{i}"
                    ww = (bn.binWeightedWoe or [None] * len(bn.binCountWoe))[i]
                    w.writerow([cc.columnNum, cc.columnName, i, lab, woe, ww])
        log.info("woemapping -> %s", out)
        return 0

    def _export_corr(self) -> int:
        src = self.paths.correlation_path
        if not os.path.isfile(src):
            log.error("no correlation matrix — run `stats -correlation` first")
            return 1
        out = os.path.join(self.paths.export_dir, "correlation.csv")
        with open(src) as fi, ioutil.atomic_open(out) as fo:
            fo.write(fi.read())
        log.info("correlation -> %s", out)
        return 0


def _interval_labels(bounds: List[float]) -> List[str]:
    labels = []
    for i, b in enumerate(bounds):
        hi = bounds[i + 1] if i + 1 < len(bounds) else float("inf")
        labels.append(f"[{b:.6g}, {hi:.6g})")
    return labels
