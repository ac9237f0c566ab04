"""Per-step semantic validation of ModelConfig — the port's copy of
``ModelStep`` and ``shifu_tpu.config.validator.probe`` (reference
``ModelInspector.java``): each step calls ``probe(mc, step)`` before it
runs, which checks the declarative field and train#params schema of
``config/meta.py`` and the per-step rules, and raises
:class:`ValidationError` listing every problem in the reference's order."""

from __future__ import annotations

import enum
import glob
import os
from typing import List

from .errors import ErrorCode, ShifuError
from .model_config import Algorithm, ModelConfig, MultipleClassification


class ModelStep(enum.Enum):
    NEW = "NEW"
    INIT = "INIT"
    STATS = "STATS"
    NORMALIZE = "NORMALIZE"
    VARSELECT = "VARSELECT"
    TRAIN = "TRAIN"
    POSTTRAIN = "POSTTRAIN"
    EVAL = "EVAL"
    EXPORT = "EXPORT"
    REFRESH = "REFRESH"


class ValidationError(ShifuError, ValueError):
    """Coded config failure (1051); ValueError base as in the reference."""

    def __init__(self, problems: List[str]):
        self.problems = problems
        super().__init__(ErrorCode.ERROR_MODELCONFIG_NOT_VALIDATION,
                         "\n  - " + "\n  - ".join(problems))


def is_multi_class(mc: ModelConfig) -> bool:
    """``ModelConfig.is_multi_class`` of the reference."""
    return len(mc.dataSet.posTags) > 1 and not mc.dataSet.negTags


def _resolve(path: str, model_set_dir: str) -> str:
    return path if os.path.isabs(path) else os.path.join(model_set_dir, path)


def _check_data_path(path: str, model_set_dir: str, what: str,
                     problems: List[str]) -> None:
    """Local data-path existence, resolved the way the reader does (glob
    patterns included); remote schemes are refused at read time."""
    if "://" in path:
        return
    p = _resolve(path, model_set_dir)
    if not (os.path.exists(p) or glob.glob(p)):
        problems.append(f"{what} does not exist: {path}")


def _check_name_file(path: str, model_set_dir: str, what: str,
                     problems: List[str]) -> None:
    """A configured column-name file must exist."""
    if path and not os.path.isfile(_resolve(path, model_set_dir)):
        problems.append(f"{what} file does not exist: {path}")


def _check_column_conf(mc: ModelConfig, model_set_dir: str,
                       problems: List[str]) -> None:
    """Cross-list column checks: the target must not appear in meta /
    forceRemove / forceSelect, and with forceEnable the three lists must
    not overlap each other (NSColumn matching throughout)."""
    from .column_config import ns_in, read_column_name_file
    ds, vs = mc.dataSet, mc.varSelect
    target = ds.targetColumnName
    meta = read_column_name_file(ds.metaColumnNameFile, model_set_dir)
    frm = read_column_name_file(vs.forceRemoveColumnNameFile, model_set_dir)
    fsel = read_column_name_file(vs.forceSelectColumnNameFile,
                                 model_set_dir)
    if target and ns_in(target, meta):
        problems.append("the target column must not be a meta column")
    if vs.forceEnable and target and ns_in(target, frm):
        problems.append("the target column must not be force-removed")
    if vs.forceEnable and target and ns_in(target, fsel):
        problems.append("the target column must not be force-selected")
    if vs.forceEnable:
        for a, b, an, bn in ((meta, frm, "meta", "forceRemove"),
                             (meta, fsel, "meta", "forceSelect"),
                             (fsel, frm, "forceSelect", "forceRemove")):
            both = sorted(x for x in a if ns_in(x, b))
            if both:
                problems.append(
                    f"column(s) {both[:5]} appear in both {an} "
                    f"and {bn} lists")


def probe(mc: ModelConfig, step: ModelStep, model_set_dir: str = ".") -> None:
    """Raise :class:`ValidationError` listing every problem of ``mc`` for
    ``step``."""
    from .meta import (tf_ignored_param_problems, validate_config_fields,
                       validate_train_conf)
    problems: List[str] = []
    if not mc.basic.name:
        problems.append("basic.name must not be empty")
    problems.extend(validate_config_fields(mc))
    if step == ModelStep.TRAIN:
        # unknown keys (typos) are hard errors; grid-search candidate
        # lists expand per trial; TENSORFLOW trains on the NN path, so
        # TF-only params it would silently ignore are an error
        problems.extend(validate_train_conf(mc.train))
        problems.extend(tf_ignored_param_problems(mc.train))
    ds = mc.dataSet
    if step in (ModelStep.INIT, ModelStep.STATS, ModelStep.NORMALIZE,
                ModelStep.VARSELECT, ModelStep.TRAIN, ModelStep.POSTTRAIN):
        if not ds.dataPath:
            problems.append("dataSet.dataPath must be set")
        elif step == ModelStep.INIT:
            _check_data_path(ds.dataPath, model_set_dir,
                             "dataSet.dataPath", problems)
        if step == ModelStep.INIT and ds.headerPath and \
                "://" not in ds.headerPath and \
                not os.path.isfile(_resolve(ds.headerPath, model_set_dir)):
            problems.append(
                f"dataSet.headerPath does not exist: {ds.headerPath}")
        if not ds.targetColumnName:
            problems.append("dataSet.targetColumnName must be set")
        if not ds.posTags and not ds.negTags:
            problems.append("dataSet.posTags/negTags must define the "
                            "target classes")
        overlap = set(map(str, ds.posTags)) & set(map(str, ds.negTags))
        if overlap:
            problems.append(f"posTags and negTags overlap: {sorted(overlap)}")
        _check_column_conf(mc, model_set_dir, problems)
    if step == ModelStep.STATS:
        _check_name_file(ds.metaColumnNameFile, model_set_dir,
                         "dataSet.metaColumnNameFile", problems)
        _check_name_file(ds.categoricalColumnNameFile, model_set_dir,
                         "dataSet.categoricalColumnNameFile", problems)
        from .model_config import BinningAlgorithm, BinningMethod
        st = mc.stats
        per_class = (BinningMethod.EqualPositive, BinningMethod.EqualNegtive,
                     BinningMethod.WeightEqualPositive,
                     BinningMethod.WeightEqualNegative)
        if is_multi_class(mc) and st.binningMethod in per_class:
            problems.append("multi-class classification cannot use "
                            "EqualPositive/EqualNegtive binning methods")
        if is_multi_class(mc) and \
                st.binningAlgorithm != BinningAlgorithm.SPDTI:
            problems.append("only the SPDTI binning algorithm supports "
                            "multi-class classification")
    if step in (ModelStep.VARSELECT, ModelStep.TRAIN):
        # configured force/candidate files must exist (reference
        # checkVarSelect)
        vs = mc.varSelect
        if vs.forceEnable:
            for what in ("candidateColumnNameFile",
                         "forceRemoveColumnNameFile",
                         "forceSelectColumnNameFile"):
                _check_name_file(getattr(vs, what), model_set_dir,
                                 f"varSelect.{what}", problems)
        # postCorrelationMetric is an enum, and SE composes only with
        # filterBy SE (the SE stats exist only then)
        pcm = (vs.postCorrelationMetric or "").upper()
        if pcm and pcm not in ("IV", "KS", "SE"):
            problems.append("varSelect.postCorrelationMetric must be one "
                            f"of IV/KS/SE, got {vs.postCorrelationMetric!r}")
        if pcm == "SE" and vs.filterBy.name != "SE":
            problems.append("varSelect.filterBy and "
                            "varSelect.postCorrelationMetric must both be "
                            "SE (reference ModelInspector.checkVarSelect)")
    if step == ModelStep.TRAIN:
        tr = mc.train
        if tr.isCrossValidation and tr.numKFold < 2:
            problems.append("train.numKFold must be >= 2 when "
                            "isCrossValidation")
        if tr.numKFold is not None and tr.numKFold > 20:
            problems.append("train.numKFold must be <= 20")
        multiclass = is_multi_class(mc) and len(ds.posTags) > 2
        if multiclass and \
                tr.multiClassifyMethod == MultipleClassification.ONEVSALL \
                and tr.algorithm not in (Algorithm.NN, Algorithm.RF,
                                         Algorithm.GBT, Algorithm.DT):
            problems.append("'one vs all' multi-class works with "
                            "RF/GBT/DT/NN only")
        if multiclass and \
                tr.multiClassifyMethod == MultipleClassification.NATIVE \
                and tr.algorithm == Algorithm.RF:
            imp = str((tr.params or {}).get("Impurity", "entropy")).lower()
            if imp not in ("entropy", "gini"):
                problems.append("Impurity must be entropy/gini for NATIVE "
                                "multi-class RF")
        if str((tr.params or {}).get("Loss", "")).lower() == "hinge" and \
                tr.algorithm != Algorithm.SVM:
            problems.append("Loss 'hinge' is the SVM objective — use "
                            "algorithm SVM (or log/squared/absolute)")
    if step == ModelStep.EVAL:
        if not mc.evals:
            problems.append("no eval sets configured")
        for e in mc.evals:
            if not e.name:
                problems.append("eval set without a name")
            if not e.dataSet.dataPath:
                problems.append(f"eval {e.name}: dataSet.dataPath must be set")
            else:
                _check_data_path(e.dataSet.dataPath, model_set_dir,
                                 f"eval {e.name}: dataPath", problems)
            _check_name_file(e.scoreMetaColumnNameFile, model_set_dir,
                             f"eval {e.name}: scoreMetaColumnNameFile",
                             problems)
            if e.performanceBucketNum is not None and \
                    not (0 < e.performanceBucketNum <= 1000):
                problems.append(f"eval {e.name}: performanceBucketNum must "
                                "be in (0, 1000]")
    if problems:
        raise ValidationError(problems)
