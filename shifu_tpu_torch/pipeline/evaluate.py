"""`eval` step — the port of ``shifu_tpu.pipeline.evaluate`` (reference
``EvalModelProcessor.java:67,159``): eval-set CRUD, streaming scoring and
the confusion / performance report.

Each eval set streams through the parse pool, the host transform
(``data/transform.py``) and the :class:`ModelRunner` on the step's
device: forests walk the bins with the ``tree_traverse`` kernel (one
launch per model per chunk on a CUDA device), NN and LR nets take the
normalized floats, same-shape nets as one stacked forward.  Outputs mirror
``PathFinder``: the ``EvalScore`` file (``tag|weight|mean|max|min|median|
model0…``, scores at ``%.3f``), ``EvalPerformance.json``,
``EvalConfusionMatrix``, ``gainchart.csv`` and ``report.html``.  The
sweep behind the report runs on the host in float64, as the reference's
does once the scores are in its score file.  A multi-class set (more than
two ``posTags``, no ``negTags``) writes ``tag|weight|predictedTag|
score_<tag>…`` at ``%.6f`` and an ``EvalPerformance.json`` with accuracy,
per-class AUC, macro AUC and the confusion matrix
(:meth:`EvalProcessor._run_one_multiclass`).

Every scored binary run also writes the post-train quality snapshot
``telemetry/posttrain.json`` (the run's score distribution and AUC), the
baseline the serving quality monitor (``obs/quality.py``) judges live
traffic against, as the reference does.  With telemetry on, the scored
chunks' bins feed the streaming drift monitor (``telemetry/drift.json``:
per-column PSI of the eval set against the training snapshot), and the
step counts ``eval.rows_scored``.  Scoring runs on one device: the
reference's multi-chip mesh waits for item 12.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import List, Optional

import numpy as np

from .. import ioutil, obs
from ..config.model_config import EvalConfig, RawSourceData
from ..config.validator import ModelStep
from ..data.parsepool import iter_extracted
from ..data.reader import DataSource
from ..eval.metrics import (evaluate_curves, evaluate_multiclass,
                            gain_chart_rows, sweep)
from ..eval.scorer import ModelRunner, Scorer
from .processor import BasicProcessor

log = logging.getLogger(__name__)

#: actions that never score, so they run on the host whatever ``device``
HOST_ACTIONS = ("list", "new_eval", "delete_eval")


class EvalProcessor(BasicProcessor):
    step = ModelStep.EVAL

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None, device=None):
        p = params or {}
        host = any(p.get(k) for k in HOST_ACTIONS) \
            or p.get("norm_eval") is not None
        super().__init__(model_set_dir, params, "cpu" if host else device)

    def process(self) -> int:
        p = self.params
        if p.get("list"):
            for ev in self.model_config.evals:
                log.info("eval set: %s (%s)", ev.name, ev.dataSet.dataPath)
            return 0
        if p.get("new_eval"):
            return self._new_eval(p["new_eval"])
        if p.get("delete_eval"):
            return self._delete_eval(p["delete_eval"])
        if p.get("norm_eval") is not None:
            return self._norm_export(p["norm_eval"] or None)
        for key in ("run_eval", "score", "perf", "confmat"):
            if p.get(key) is not None:
                return self._run(p[key] or None, action=key)
        # a bare `eval` runs every set (reference default)
        return self._run(None, action="run_eval")

    def _source(self, ds: RawSourceData) -> DataSource:
        return DataSource(self._abs(ds.dataPath), ds.dataDelimiter,
                          header_path=self._abs(ds.headerPath),
                          header_delimiter=ds.headerDelimiter)

    def _norm_export(self, name: Optional[str]) -> int:
        """`eval -norm`: write the eval set's normalized feature matrix
        (reference ``EvalModelProcessor`` runNormalize path)."""
        from ..data.transform import DatasetTransformer
        for i in self._eval_sets(name):
            ev = self.model_config.evals[i]
            tf = DatasetTransformer(self.model_config, self.column_configs,
                                    for_eval_set=i)
            out = self.paths.eval_norm_path(ev.name)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            n_rows = 0
            with ioutil.atomic_open(out, newline="") as f:
                w = csv.writer(f, delimiter="|")
                header_written = False
                for _, ex in iter_extracted(
                        self._source(ev.dataSet), tf.extractor,
                        cache_root=self.paths.raw_cache_dir):
                    tc = tf.transform_extracted(ex)
                    if tc.n == 0:
                        continue
                    if not header_written:
                        w.writerow(["tag", "weight"] + list(tf.output_names))
                        header_written = True
                    block = np.column_stack(
                        [tc.target.astype(int).astype(str),
                         tc.weight.astype(str)]
                        + [np.char.mod("%.6f", tc.x[:, j])
                           for j in range(tc.x.shape[1])])
                    w.writerows(block.tolist())
                    n_rows += tc.n
            log.info("eval %s: normalized %d rows -> %s", ev.name, n_rows,
                     out)
        return 0

    # -------------------------------------------------------------- CRUD
    def _new_eval(self, name: str) -> int:
        if any(e.name == name for e in self.model_config.evals):
            log.error("eval set %s already exists", name)
            return 1
        ev = EvalConfig(name=name, dataSet=RawSourceData())
        # the training source is the template (reference copies the
        # dataSet section on `eval -new`)
        base = self.model_config.dataSet
        for f in ("dataPath", "dataDelimiter", "headerPath",
                  "headerDelimiter", "targetColumnName", "posTags",
                  "negTags", "missingOrInvalidValues", "weightColumnName"):
            v = getattr(base, f)
            setattr(ev.dataSet, f, list(v) if isinstance(v, list) else v)
        self.model_config.evals.append(ev)
        self.save_model_config()
        log.info("created eval set %s", name)
        return 0

    def _delete_eval(self, name: str) -> int:
        before = len(self.model_config.evals)
        self.model_config.evals = [e for e in self.model_config.evals
                                   if e.name != name]
        if len(self.model_config.evals) == before:
            log.error("no eval set named %s", name)
            return 1
        self.save_model_config()
        return 0

    # --------------------------------------------------------------- run
    def _eval_sets(self, name: Optional[str]) -> List[int]:
        evals = self.model_config.evals
        if name:
            idx = [i for i, e in enumerate(evals) if e.name == name]
            if not idx:
                raise ValueError(f"no eval set named {name}")
            return idx
        return list(range(len(evals)))

    def _run(self, name: Optional[str], action: str) -> int:
        scorer = Scorer.from_dir(self.paths.models_dir,
                                 device=self.device)   # load models once
        rc = 0
        for i in self._eval_sets(name):
            rc |= self._run_one(i, action, scorer)
        return rc

    def _run_one(self, idx: int, action: str, scorer: Scorer) -> int:
        mc = self.model_config
        if mc.is_multi_class() and len(mc.dataSet.posTags) > 2:
            return self._run_one_multiclass(idx, action, scorer)
        ev = mc.evals[idx]
        runner = ModelRunner(mc, self.column_configs, scorer.models,
                             for_eval_set=idx, device=self.device)
        eval_dir = self.paths.eval_dir(ev.name)
        os.makedirs(eval_dir, exist_ok=True)

        sel = ev.performanceScoreSelector or "mean"
        all_scores, all_targets, all_weights = [], [], []
        score_path = self.paths.eval_score_path(ev.name)
        n_models = len(scorer.models)
        # streaming drift monitor: the eval set is the live distribution;
        # None (no per-chunk cost) when telemetry is off
        drift = obs.start_drift_monitor(runner.transformer.columns)
        t0 = time.perf_counter()
        with self.phase(f"score:{ev.name}") as ph, \
                ioutil.atomic_open(score_path, newline="") as sf:
            w = csv.writer(sf, delimiter="|")
            w.writerow(["tag", "weight", "mean", "max", "min", "median"]
                       + [f"model{i}" for i in range(n_models)])
            for _, ex in iter_extracted(
                    self._source(ev.dataSet), runner.transformer.extractor,
                    cache_root=self.paths.raw_cache_dir):
                out = runner.compute(ex)
                if out["n"] == 0:
                    continue
                if drift is not None:
                    drift.update(out["bins"])
                res = out["result"]
                all_scores.append(res.select(sel))
                all_targets.append(out["target"])
                all_weights.append(out["weight"])
                block = np.column_stack(
                    [out["target"].astype(int).astype(str),
                     out["weight"].astype(str)]
                    + [np.char.mod("%.3f", col) for col in
                       (res.mean, res.max, res.min, res.median)]
                    + [np.char.mod("%.3f", res.scores[:, m])
                       for m in range(n_models)])
                w.writerows(block.tolist())
            ph.set(rows=int(sum(len(s) for s in all_scores)))
        if not all_scores:
            log.error("eval %s: no records scored", ev.name)
            return 1
        scores = np.concatenate(all_scores)
        targets = np.concatenate(all_targets)
        weights = np.concatenate(all_weights)
        obs.counter("eval.rows_scored").inc(len(scores))
        obs.gauge("eval.rows_per_sec").set(
            len(scores) / max(time.perf_counter() - t0, 1e-9))
        obs.event("eval_set", eval_set=ev.name, rows=len(scores),
                  models=n_models, action=action)
        if drift is not None:
            drift.emit(path=self.paths.drift_path)
        log.info("eval %s: scored %d records (%d pos / %d neg) with %d "
                 "model(s) on %s in %.3f s", ev.name, len(scores),
                 int(targets.sum()), int((1 - targets).sum()), n_models,
                 self.device, time.perf_counter() - t0)
        if action == "score":
            # `eval -score` sorts the score file by the selected score for
            # review unless -nosort
            if not self.params.get("nosort"):
                with open(score_path) as f:
                    header = f.readline()
                    rows = f.readlines()
                order = np.argsort(-scores, kind="stable")
                with ioutil.atomic_open(score_path) as f:
                    f.write(header)
                    f.writelines(rows[i] for i in order)
            return 0

        curves = sweep(scores, targets, weights)   # one sort, two consumers
        result = evaluate_curves(curves, buckets=ev.performanceBucketNum)
        result.modelCount = n_models
        ioutil.atomic_write_json(self.paths.eval_performance_path(ev.name),
                                 result.to_dict())
        self._write_confusion(ev.name, result)
        self._write_gains(eval_dir, result)
        from ..eval.report import html_report
        ioutil.atomic_write_text(os.path.join(eval_dir, "report.html"),
                                 html_report(ev.name, curves, result))
        # training-time quality baseline: score distribution + AUC the
        # serve-path quality monitor (obs/quality) judges live traffic
        # against — last eval run wins, matching the serving artifacts
        obs.gauge(f"eval.{ev.name}.auc").set(result.areaUnderRoc)
        obs.gauge(f"eval.{ev.name}.pr_auc").set(result.areaUnderPr)
        from ..obs.quality import write_posttrain_snapshot
        write_posttrain_snapshot(self.paths.posttrain_snapshot_path,
                                 scores, auc=result.areaUnderRoc)
        log.info("eval %s: AUC %.6f weighted AUC %.6f PR-AUC %.6f",
                 ev.name, result.areaUnderRoc, result.weightedAuc,
                 result.areaUnderPr)
        return 0

    def _run_one_multiclass(self, idx: int, action: str,
                            scorer: Scorer) -> int:
        """Multi-class eval (reference ``_run_one_multiclass``): [n, K]
        class scores, argmax predicted tag, accuracy + per-class OvR AUC
        + K x K confusion (reference ``MultiClsTagPredictor`` +
        ``EvalScoreUDF`` multi-class columns)."""
        mc = self.model_config
        ev = mc.evals[idx]
        runner = ModelRunner(mc, self.column_configs, scorer.models,
                             for_eval_set=idx, device=self.device)
        os.makedirs(self.paths.eval_dir(ev.name), exist_ok=True)
        # the SAME tag resolution ChunkExtractor uses: eval-set tags first
        # — class indices in targets are positions in THIS list
        tags = list(ev.dataSet.posTags or mc.dataSet.posTags)
        k_models = scorer.n_classes()
        if k_models and len(tags) != k_models:
            raise ValueError(
                f"eval set {ev.name} lists {len(tags)} tags but the models "
                f"were trained over {k_models} classes — tag lists must "
                "match in length and order")
        all_cs, all_t, all_w = [], [], []
        score_path = self.paths.eval_score_path(ev.name)
        tag_arr = np.asarray(tags, dtype=object)
        with self.phase(f"score:{ev.name}"), \
                ioutil.atomic_open(score_path, newline="") as sf:
            w = csv.writer(sf, delimiter="|")
            w.writerow(["tag", "weight", "predictedTag"]
                       + [f"score_{t}" for t in tags])
            for _, ex in iter_extracted(
                    self._source(ev.dataSet), runner.transformer.extractor,
                    cache_root=self.paths.raw_cache_dir):
                out = runner.compute_classes(ex)
                if out["n"] == 0:
                    continue
                cs = out["class_scores"]
                block = np.column_stack(
                    [out["target"].astype(int).astype(str),
                     out["weight"].astype(str),
                     tag_arr[cs.argmax(axis=1)].astype(str)]
                    + [np.char.mod("%.6f", cs[:, k])
                       for k in range(cs.shape[1])])
                w.writerows(block.tolist())
                all_cs.append(cs)
                all_t.append(out["target"])
                all_w.append(out["weight"])
        if not all_cs:
            log.error("eval %s: no records scored", ev.name)
            return 1
        cs = np.concatenate(all_cs)
        log.info("eval %s: scored %d records over %d classes with %d "
                 "model(s) on %s", ev.name, len(cs), len(tags),
                 len(scorer.models), self.device)
        if action == "score":
            if not self.params.get("nosort"):
                # same default as the binary path: sorted for review,
                # multiclass keyed by the winning class's score
                with open(score_path) as f:
                    header = f.readline()
                    rows = f.readlines()
                order = np.argsort(-cs.max(axis=1), kind="stable")
                with ioutil.atomic_open(score_path) as f:
                    f.write(header)
                    f.writelines(rows[i] for i in order)
            return 0
        rep = evaluate_multiclass(cs, np.concatenate(all_t),
                                  np.concatenate(all_w))
        rep["tags"] = tags
        ioutil.atomic_write_json(self.paths.eval_performance_path(ev.name),
                                 rep)
        log.info("eval %s: accuracy %.6f macro OvR AUC %.6f", ev.name,
                 rep["accuracy"], rep["macroAuc"])
        return 0

    def _write_confusion(self, name: str, result) -> None:
        path = self.paths.eval_confusion_path(name)
        with ioutil.atomic_open(path, newline="") as f:
            w = csv.writer(f)
            cols = ["binLowestScore", "tp", "fp", "fn", "tn", "precision",
                    "recall", "fpr", "actionRate", "liftUnit", "weightedTp",
                    "weightedFp", "weightedFn", "weightedTn",
                    "weightedPrecision", "weightedRecall", "weightedFpr"]
            w.writerow(cols)
            for pt in result.points:
                w.writerow([getattr(pt, c) for c in cols])

    def _write_gains(self, eval_dir: str, result) -> None:
        with ioutil.atomic_open(os.path.join(eval_dir, "gainchart.csv"),
                                newline="") as f:
            rows = gain_chart_rows(result)
            if not rows:
                return
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)


# ---------------------------------------------------------- parity oracle
def score_records_offline(model_set_dir: str, records,
                          selector: str = "mean",
                          device=None) -> np.ndarray:
    """Raw JSON records through the OFFLINE norm + score pipeline — the
    oracle that ``serve``'s fused transform and the offline ``norm →
    score`` give the same scores: the same stringification
    (:func:`data.reader.record_field_str`), the same ``parse_numeric``
    missing grammar, the same ``NormalizedColumn``/``ColumnBinner`` math
    and the same ensemble reduction.  The chunk is built from the strings
    without pandas; scoring runs on ``device`` (default CUDA)."""
    from ..config import ModelConfig, load_column_configs
    from ..data.reader import RawChunk, record_field_str
    from ..data.transform import DatasetTransformer

    mc = ModelConfig.load(os.path.join(model_set_dir, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(model_set_dir,
                                           "ColumnConfig.json"))
    tf = DatasetTransformer(mc, ccs)
    names = [c.columnName for c in tf.columns]
    data = {}
    for n in names:
        col = np.empty(len(records), dtype=object)
        col[:] = [record_field_str(r.get(n)) for r in records]
        data[n] = col
    tc = tf.transform(RawChunk(columns=names, data=data))
    scorer = Scorer.from_dir(os.path.join(model_set_dir, "models"),
                             device=device)
    res = scorer.score(tc.x, bins=tc.bins)
    return np.asarray(res.select(selector), np.float32)
