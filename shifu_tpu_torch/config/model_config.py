"""ModelConfig tree — the port's copy of ``shifu_tpu.config.model_config``.

Mirrors the bean tree at reference ``container/obj/ModelConfig.java:57-95``:
``basic / dataSet / stats / varSelect / normalize / train / evals`` with the
same camelCase keys, so a model set written by either package loads in the
other.  Enum families: algorithms ``ModelTrainConf.java:43``
(NN, LR, SVM, DT, RF, GBT, TENSORFLOW, WDL), norm types
``ModelNormalizeConf.java:34-46``, binning methods/algorithms
``ModelStatsConf.java:34-51``.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import jsonbean


class SourceType(enum.Enum):
    LOCAL = "LOCAL"
    HDFS = "HDFS"
    S3 = "S3"
    GCS = "GCS"


class RunMode(enum.Enum):
    """LOCAL = single host; DIST/MAPRED = multi-device (kept for the JSON
    contract; the port's serving path does not read it)."""
    LOCAL = "local"
    DIST = "dist"
    MAPRED = "mapred"
    TPU = "tpu"


class Algorithm(enum.Enum):
    NN = "NN"
    LR = "LR"
    SVM = "SVM"
    DT = "DT"
    RF = "RF"
    GBT = "GBT"
    TENSORFLOW = "TENSORFLOW"
    WDL = "WDL"


class NormType(enum.Enum):
    """All 17 norm types of reference ``ModelNormalizeConf.java:34-46``."""
    OLD_ZSCORE = "OLD_ZSCORE"
    OLD_ZSCALE = "OLD_ZSCALE"
    ZSCORE = "ZSCORE"
    ZSCALE = "ZSCALE"
    WOE = "WOE"
    WEIGHT_WOE = "WEIGHT_WOE"
    HYBRID = "HYBRID"
    WEIGHT_HYBRID = "WEIGHT_HYBRID"
    WOE_ZSCORE = "WOE_ZSCORE"
    WOE_ZSCALE = "WOE_ZSCALE"
    WEIGHT_WOE_ZSCORE = "WEIGHT_WOE_ZSCORE"
    WEIGHT_WOE_ZSCALE = "WEIGHT_WOE_ZSCALE"
    ONEHOT = "ONEHOT"
    ZSCALE_ONEHOT = "ZSCALE_ONEHOT"
    ASIS_WOE = "ASIS_WOE"
    ASIS_PR = "ASIS_PR"
    DISCRETE_ZSCORE = "DISCRETE_ZSCORE"
    DISCRETE_ZSCALE = "DISCRETE_ZSCALE"
    ZSCALE_INDEX = "ZSCALE_INDEX"
    ZSCORE_INDEX = "ZSCORE_INDEX"
    WOE_INDEX = "WOE_INDEX"
    WOE_ZSCALE_INDEX = "WOE_ZSCALE_INDEX"

    def is_woe(self) -> bool:
        return self in (NormType.WOE, NormType.WEIGHT_WOE, NormType.WOE_ZSCORE,
                        NormType.WOE_ZSCALE, NormType.WEIGHT_WOE_ZSCORE,
                        NormType.WEIGHT_WOE_ZSCALE)

    def is_weighted(self) -> bool:
        return "WEIGHT" in self.name


class PrecisionType(enum.Enum):
    """Norm-output rounding family, reference ``NormalizeUDF.java:540-570``."""
    FLOAT7 = "FLOAT7"
    FLOAT16 = "FLOAT16"
    FLOAT32 = "FLOAT32"
    DOUBLE64 = "DOUBLE64"


class BinningMethod(enum.Enum):
    EqualNegtive = "EqualNegtive"
    EqualInterval = "EqualInterval"
    EqualPositive = "EqualPositive"
    EqualTotal = "EqualTotal"
    WeightEqualNegative = "WeightEqualNegative"
    WeightEqualInterval = "WeightEqualInterval"
    WeightEqualPositive = "WeightEqualPositive"
    WeightEqualTotal = "WeightEqualTotal"


class BinningAlgorithm(enum.Enum):
    Native = "Native"
    SPDT = "SPDT"
    SPDTI = "SPDTI"
    MunroPat = "MunroPat"
    MunroPatI = "MunroPatI"
    DynamicBinning = "DynamicBinning"


class FilterBy(enum.Enum):
    KS = "KS"
    IV = "IV"
    MIX = "MIX"
    PARETO = "PARETO"
    SE = "SE"
    ST = "ST"
    FI = "FI"
    GENETIC = "GENETIC"      # dvarsel wrapper search (core/dvarsel/)


class MultipleClassification(enum.Enum):
    NATIVE = "NATIVE"
    ONEVSALL = "ONEVSALL"
    ONEVSREST = "ONEVSREST"
    ONEVSONE = "ONEVSONE"


@dataclass
class CustomPaths:
    modelsPath: Optional[str] = None
    scorePath: Optional[str] = None
    confusionMatrixPath: Optional[str] = None
    performancePath: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelBasicConf:
    name: str = ""
    author: str = ""
    description: Optional[str] = None
    version: str = "0.1.0"
    runMode: RunMode = RunMode.LOCAL
    postTrainOn: bool = False
    customPaths: Optional[Dict[str, str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RawSourceData:
    """Reference ``container/obj/RawSourceData.java``."""
    source: SourceType = SourceType.LOCAL
    dataPath: Optional[str] = None
    validationDataPath: Optional[str] = None
    dataDelimiter: str = "|"
    headerPath: Optional[str] = None
    headerDelimiter: str = "|"
    filterExpressions: Optional[str] = None
    weightColumnName: Optional[str] = None
    targetColumnName: Optional[str] = None
    posTags: List[str] = field(default_factory=list)
    negTags: List[str] = field(default_factory=list)
    missingOrInvalidValues: List[str] = field(
        default_factory=lambda: ["", "*", "#", "?", "null", "~"])
    metaColumnNameFile: Optional[str] = None
    categoricalColumnNameFile: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelStatsConf:
    maxNumBin: int = 10
    cateMaxNumBin: int = 0
    binningMethod: BinningMethod = BinningMethod.EqualPositive
    sampleRate: float = 1.0
    sampleNegOnly: bool = False
    binningAlgorithm: BinningAlgorithm = BinningAlgorithm.SPDTI
    psiColumnName: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelVarSelectConf:
    forceEnable: bool = True
    forceSelectColumnNameFile: Optional[str] = None
    forceRemoveColumnNameFile: Optional[str] = None
    candidateColumnNameFile: Optional[str] = None
    filterEnable: bool = True
    filterNum: int = 200
    filterOutRatio: Optional[float] = None
    filterBy: FilterBy = FilterBy.KS
    postCorrelationMetric: Optional[str] = None   # IV | KS | SE (ref enum)
    autoFilterEnable: bool = False
    missingRateThreshold: float = 0.98
    correlationThreshold: float = 1.0
    minIvThreshold: float = 0.0
    minKsThreshold: float = 0.0
    params: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelNormalizeConf:
    stdDevCutOff: float = 4.0
    sampleRate: float = 1.0
    sampleNegOnly: bool = False
    normType: NormType = NormType.ZSCALE
    precisionType: PrecisionType = PrecisionType.FLOAT32
    isParquet: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelTrainConf:
    baggingNum: int = 1
    baggingWithReplacement: bool = False
    baggingSampleRate: float = 1.0
    validSetRate: float = 0.2
    numTrainEpochs: int = 100
    epochsPerIteration: int = 1
    trainOnDisk: bool = False
    isContinuous: bool = False
    isCrossValidation: bool = False
    numKFold: int = -1
    upSampleWeight: float = 1.0
    stratifiedSample: bool = False
    workerThreadCount: int = 4
    algorithm: Algorithm = Algorithm.NN
    params: Dict[str, Any] = field(default_factory=dict)
    gridConfigFile: Optional[str] = None
    multiClassifyMethod: MultipleClassification = MultipleClassification.NATIVE
    convergenceThreshold: float = 0.0
    earlyStopEnable: bool = False
    customPaths: Optional[Dict[str, str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvalConfig:
    name: str = ""
    dataSet: RawSourceData = field(default_factory=RawSourceData)
    performanceBucketNum: int = 10
    performanceScoreSelector: str = "mean"
    scoreMetaColumnNameFile: Optional[str] = None
    gsMetricName: Optional[str] = None
    customPaths: Optional[CustomPaths] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    basic: ModelBasicConf = field(default_factory=ModelBasicConf)
    dataSet: RawSourceData = field(default_factory=RawSourceData)
    stats: ModelStatsConf = field(default_factory=ModelStatsConf)
    varSelect: ModelVarSelectConf = field(default_factory=ModelVarSelectConf)
    normalize: ModelNormalizeConf = field(default_factory=ModelNormalizeConf)
    train: ModelTrainConf = field(default_factory=ModelTrainConf)
    evals: List[EvalConfig] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------ io
    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            return jsonbean.loads(cls, f.read())

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(jsonbean.dumps(self))
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return jsonbean.from_dict(cls, d)

    def to_dict(self) -> Dict[str, Any]:
        return jsonbean.to_dict(self)

    # ------------------------------------------------------------- helpers
    @property
    def model_set_name(self) -> str:
        return self.basic.name

    @property
    def algorithm(self) -> Algorithm:
        return self.train.algorithm

    def is_classification(self) -> bool:
        return bool(self.dataSet.posTags or self.dataSet.negTags)

    def is_multi_class(self) -> bool:
        return len(self.dataSet.posTags) > 1 and not self.dataSet.negTags

    def is_regression(self) -> bool:
        return not self.is_multi_class()

    def flatten_tags(self) -> List[str]:
        return list(self.dataSet.posTags) + list(self.dataSet.negTags)

    def get_eval(self, name: str) -> Optional[EvalConfig]:
        for e in self.evals:
            if e.name == name:
                return e
        return None

    @classmethod
    def create(cls, name: str, description: str = "") -> "ModelConfig":
        """Fresh config for ``shifu new`` (reference ``CreateModelProcessor``)."""
        mc = cls()
        mc.basic.name = name
        mc.basic.description = description or f"model set {name}"
        mc.dataSet.dataPath = os.path.join(".", name, "data")
        mc.evals = [EvalConfig(name="Eval1",
                               dataSet=RawSourceData(dataPath=os.path.join(".", name, "evaldata")))]
        return mc

