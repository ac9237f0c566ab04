"""Per-step semantic validation of ModelConfig — the port's copy of
``ModelStep`` and the TRAIN rules of ``shifu_tpu.config.validator.probe``
(reference ``ModelInspector.java``).  The declarative per-field and
train#params schema (``shifu_tpu.config.meta``) is not ported yet, so a
mistyped train#params key is not caught here."""

from __future__ import annotations

import enum
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


def probe(mc: ModelConfig, step: ModelStep) -> None:
    """Raise :class:`ValidationError` listing every problem of ``mc`` for
    ``step``.  Only the TRAIN step's rules are ported."""
    problems: List[str] = []
    if not mc.basic.name:
        problems.append("basic.name must not be empty")
    if step == ModelStep.TRAIN:
        ds = mc.dataSet
        if not ds.dataPath:
            problems.append("dataSet.dataPath must be set")
        if not ds.targetColumnName:
            problems.append("dataSet.targetColumnName must be set")
        if not ds.posTags and not ds.negTags:
            problems.append("dataSet.posTags/negTags must define the "
                            "target classes")
        overlap = set(map(str, ds.posTags)) & set(map(str, ds.negTags))
        if overlap:
            problems.append(f"posTags and negTags overlap: {sorted(overlap)}")
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
    if problems:
        raise ValidationError(problems)
