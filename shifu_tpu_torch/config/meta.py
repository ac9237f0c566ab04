"""Meta-driven config validation — the port's copy of
``shifu_tpu.config.meta`` (reference ``container/meta/MetaFactory.java`` +
``store/ModelConfigMeta.json``): the declarative rule tables for the
ModelConfig scalar fields (:data:`CONFIG_RULES`) and for ``train#params``
(:data:`TRAIN_PARAM_RULES`), checked by ``config/validator.py::probe`` on
every step.  UNKNOWN ``train#params`` keys are hard errors with a
did-you-mean suggestion, so a typo like ``LearningRat`` fails ``probe``
instead of silently falling back to the default.  Grid-search trials
validate individually.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .model_config import Algorithm

NN_FAMILY = ("NN", "LR", "SVM", "TENSORFLOW")
TREE_FAMILY = ("GBT", "RF", "DT")


@dataclass(frozen=True)
class Rule:
    """One key's schema: accepted kinds + constraints.

    kind: 'int' | 'float' | 'bool' | 'str' | 'list' | 'intlist' | 'strlist'
    lo/hi: numeric range (inclusive unless *_open); allowed: value set
    (case-insensitive for strings); algs: algorithms the key applies to
    (None = all).
    """
    kind: str
    lo: Optional[float] = None
    hi: Optional[float] = None
    lo_open: bool = False
    hi_open: bool = False
    allowed: Optional[Tuple[str, ...]] = None
    algs: Optional[Tuple[str, ...]] = None


_OPTIMIZERS = ("B", "Q", "R", "M", "ADAM", "SGD", "MOMENTUM", "NESTEROV",
               "RMSPROP", "ADAGRAD")
_ACTIVATIONS = ("sigmoid", "tanh", "relu", "leakyrelu", "ptanh", "swish",
                "linear", "log", "sin", "softmax")
_LOSSES = ("squared", "absolute", "log", "hinge")
_IMPURITIES = ("variance", "friedmanmse", "entropy", "gini")
_SUBSETS = ("ALL", "HALF", "SQRT", "LOG2", "ONETHIRD", "TWOTHIRDS")
_INITIALIZERS = ("xavier", "he", "lecun", "zero", "default",
                 "herandomizer", "lecunrandomizer")

# ------------------------------------------------- train#params schema
# provenance: reference ``core/dtrain/CommonConstants.java`` key constants,
# ``DTMaster.java:91`` tree init region, ``NNMaster``/``DTrainUtils`` NN
# region, ``core/dtrain/wdl/`` WDL params.
TRAIN_PARAM_RULES: Dict[str, Rule] = {
    # NN / LR family
    "Propagation": Rule("str", allowed=_OPTIMIZERS, algs=NN_FAMILY),
    "Optimizer": Rule("str", allowed=_OPTIMIZERS, algs=NN_FAMILY + ("WDL",)),
    "NumHiddenLayers": Rule("int", lo=0, hi=64, algs=NN_FAMILY),
    "NumHiddenNodes": Rule("intlist", lo=1, algs=NN_FAMILY + ("WDL",)),
    "ActivationFunc": Rule("strlist", allowed=_ACTIVATIONS,
                           algs=NN_FAMILY + ("WDL",)),
    "LearningRate": Rule("float", lo=0.0, lo_open=True, hi=100.0),
    "LearningDecay": Rule("float", lo=0.0, hi=1.0, hi_open=True,
                          algs=NN_FAMILY),
    "RegularizedConstant": Rule("float", lo=0.0,
                                algs=NN_FAMILY + ("WDL",)),
    "L2Const": Rule("float", lo=0.0, algs=NN_FAMILY + ("WDL",)),
    "L1Const": Rule("float", lo=0.0, algs=NN_FAMILY),
    "L1orL2": Rule("str", allowed=("NONE", "L1", "L2"), algs=NN_FAMILY),
    "DropoutRate": Rule("float", lo=0.0, hi=1.0, hi_open=True,
                        algs=NN_FAMILY),
    "MiniBatchs": Rule("int", lo=0, algs=NN_FAMILY + ("WDL",)),
    "WindowSize": Rule("int", lo=1, algs=NN_FAMILY + ("WDL",)),
    "WeightInitializer": Rule("str", allowed=_INITIALIZERS, algs=NN_FAMILY),
    "TmpModelEpochs": Rule("int", lo=0, algs=NN_FAMILY),
    "FixedLayers": Rule("intlist", algs=NN_FAMILY),
    "FixedBias": Rule("bool", algs=NN_FAMILY),
    "EnableEarlyStop": Rule("bool"),
    "ValidationTolerance": Rule("float", lo=0.0, algs=NN_FAMILY),
    "OutputActivationFunc": Rule("str", allowed=_ACTIVATIONS,
                                 algs=NN_FAMILY),
    # TPU matmul precision: bfloat16 inputs + f32 accumulation feed the MXU
    # at full rate (no reference analogue; Encog is f64 CPU)
    "Precision": Rule("str", allowed=("highest", "float32", "default",
                                      "bfloat16", "tensorfloat32"),
                      algs=NN_FAMILY),
    # training-precision ladder (round 12): f32 keeps today's math;
    # bf16 trains fully narrow; mixed keeps an f32 master copy in the
    # optimizer state with bf16 forward/backward ("" defers to the
    # -Dshifu.train.precision property)
    "TrainPrecision": Rule("str", allowed=("f32", "bf16", "mixed"),
                           algs=NN_FAMILY + ("WDL",)),
    "Loss": Rule("str", allowed=_LOSSES),
    # SVM (reference core/alg/SVMTrainer.java param keys)
    "Kernel": Rule("str", allowed=("linear", "rbf", "radialbasisfunction",
                                   "poly", "sigmoid"), algs=("SVM",)),
    "Gamma": Rule("float", lo=0.0, lo_open=True, algs=("SVM",)),
    "Const": Rule("float", lo=0.0, lo_open=True, algs=("SVM",)),
    "Coef0": Rule("float", algs=("SVM",)),
    "Degree": Rule("int", lo=1, hi=10, algs=("SVM",)),
    "Seed": Rule("int"),
    "CheckpointInterval": Rule("int", lo=0),
    # tree family
    "TreeNum": Rule("int", lo=1, hi=100000, algs=TREE_FAMILY),
    # trees between device-side early-stop decisions (sync-free growth:
    # errors accumulate on device and fetch in bulk)
    "EarlyStopCheckInterval": Rule("int", lo=1, hi=10000,
                                   algs=TREE_FAMILY),
    # RF same-round trees grown per batched device program (multi-tree
    # Pallas histogram grids); 0 = auto
    "TreeBatch": Rule("int", lo=0, hi=64, algs=TREE_FAMILY),
    # disk-tail super-batch: trees fed by ONE tail re-stream in streamed
    # RF (one disk pass feeds the whole batch's level histograms); 0 =
    # auto (budget-derived from shifu.tree.tailSuperBatchBytes)
    "TailTreeBatch": Rule("int", lo=0, hi=1024, algs=TREE_FAMILY),
    "MaxDepth": Rule("int", lo=1, hi=20, algs=TREE_FAMILY),
    # -1 (default) = level-wise; >0 enables the leaf-wise node budget
    # (reference DTMaster.java:129-137 MaxLeaves / isLeafWise)
    "MaxLeaves": Rule("int", lo=-1, hi=1 << 20, algs=TREE_FAMILY),
    "Impurity": Rule("str", allowed=_IMPURITIES, algs=TREE_FAMILY),
    "FeatureSubsetStrategy": Rule("str", allowed=_SUBSETS,
                                  algs=TREE_FAMILY),
    "MinInstancesPerNode": Rule("float", lo=0.0, algs=TREE_FAMILY),
    "MinInfoGain": Rule("float", lo=0.0, algs=TREE_FAMILY),
    # TENSORFLOW-only topology/resource keys (reference TF-on-YARN bridge,
    # ``TrainModelProcessor.java:395-449`` session setup): recognized so
    # they don't read as typos, but the tpu-native NN path that serves
    # algorithm=TENSORFLOW has no ps/worker topology — a TRAIN probe with
    # any of them present fails loudly (``tf_ignored_param_problems``)
    # instead of training while silently ignoring them
    "NumPS": Rule("int", lo=1, algs=("TENSORFLOW",)),
    "NumTFWorkers": Rule("int", lo=1, algs=("TENSORFLOW",)),
    "TFWorkerMemory": Rule("int", lo=1, algs=("TENSORFLOW",)),
    "TFPSMemory": Rule("int", lo=1, algs=("TENSORFLOW",)),
    # WDL family
    "EmbedColumnNum": Rule("int", lo=1, algs=("WDL",)),
    "EmbedDim": Rule("int", lo=1, algs=("WDL",)),
    "NumEmbedColumnIds": Rule("intlist", algs=("WDL",)),
    "NumEmbedOuputs": Rule("int", lo=1, algs=("WDL",)),
    "WideEnable": Rule("bool", algs=("WDL",)),
    "DeepEnable": Rule("bool", algs=("WDL",)),
    "WDLL2Reg": Rule("float", lo=0.0, algs=("WDL",)),
}


# ------------------------------------------------- ModelConfig field schema
# dotted path -> Rule; checked via attribute walk on every probe
CONFIG_RULES: Dict[str, Rule] = {
    "train.baggingNum": Rule("int", lo=1, hi=1000),
    "train.numTrainEpochs": Rule("int", lo=1, hi=1_000_000),
    "train.validSetRate": Rule("float", lo=0.0, hi=1.0, hi_open=True),
    "train.baggingSampleRate": Rule("float", lo=0.0, lo_open=True, hi=1.0),
    "train.upSampleWeight": Rule("float", lo=1.0),
    "train.convergenceThreshold": Rule("float", lo=0.0),
    "train.epochsPerIteration": Rule("int", lo=1),
    "train.workerThreadCount": Rule("int", lo=1, hi=1024),
    "stats.maxNumBin": Rule("int", lo=2, hi=32767),
    "stats.sampleRate": Rule("float", lo=0.0, lo_open=True, hi=1.0),
    "stats.binningMethod": Rule("str"),
    "normalize.stdDevCutOff": Rule("float", lo=0.0, lo_open=True),
    "normalize.sampleRate": Rule("float", lo=0.0, lo_open=True, hi=1.0),
    "varSelect.filterNum": Rule("int", lo=0),
}


def _as_number(v: Any) -> Optional[float]:
    import math
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        x = float(v)
    elif isinstance(v, str):
        try:
            x = float(v)
        except ValueError:
            return None
    else:
        return None
    return x if math.isfinite(x) else None    # 'nan'/'inf' are not values


def _check_value(key: str, v: Any, rule: Rule) -> List[str]:
    import enum
    if isinstance(v, enum.Enum):       # config enums validate by value
        v = v.value
    problems: List[str] = []

    def range_check(x: float) -> None:
        if rule.lo is not None and (x < rule.lo
                                    or (rule.lo_open and x == rule.lo)):
            op = ">" if rule.lo_open else ">="
            problems.append(f"{key} must be {op} {rule.lo:g}, got {v!r}")
        elif rule.hi is not None and (x > rule.hi
                                      or (rule.hi_open and x == rule.hi)):
            op = "<" if rule.hi_open else "<="
            problems.append(f"{key} must be {op} {rule.hi:g}, got {v!r}")

    if rule.kind in ("int", "float"):
        x = _as_number(v)
        if x is None or (rule.kind == "int" and x != int(x)):
            problems.append(f"{key} must be a {rule.kind}, got {v!r}")
        else:
            range_check(x)
    elif rule.kind == "bool":
        if not isinstance(v, bool) and str(v).lower() not in ("true", "false"):
            problems.append(f"{key} must be a boolean, got {v!r}")
    elif rule.kind == "str":
        if not isinstance(v, str):
            problems.append(f"{key} must be a string, got {v!r}")
        elif rule.allowed and str(v).lower() not in \
                tuple(a.lower() for a in rule.allowed):
            problems.append(f"{key} must be one of {list(rule.allowed)}, "
                            f"got {v!r}")
    elif rule.kind in ("intlist", "strlist"):
        if not isinstance(v, (list, tuple)):
            problems.append(f"{key} must be a list, got {v!r}")
        else:
            for e in v:
                if rule.kind == "intlist":
                    x = _as_number(e)
                    if x is None or x != int(x):
                        problems.append(f"{key} elements must be ints, "
                                        f"got {e!r}")
                        break
                    range_check(x)
                elif rule.allowed and str(e).lower() not in \
                        tuple(a.lower() for a in rule.allowed):
                    problems.append(f"{key} element {e!r} not one of "
                                    f"{list(rule.allowed)}")
                    break
    return problems


def unknown_param_problems(params: Dict[str, Any]) -> List[str]:
    """Hard errors for keys no algorithm knows, with a did-you-mean hint."""
    problems: List[str] = []
    for key in (params or {}):
        if key not in TRAIN_PARAM_RULES:
            hint = difflib.get_close_matches(key, TRAIN_PARAM_RULES, n=1,
                                             cutoff=0.6)
            suffix = f" — did you mean {hint[0]!r}?" if hint else ""
            problems.append(f"unknown train#params key {key!r}{suffix}")
    return problems


def _nn_shape_problems(params: Dict[str, Any], alg: str) -> List[str]:
    """Cross-field NN shape consistency (layers vs nodes vs activations)."""
    if alg not in NN_FAMILY:
        return []
    problems: List[str] = []
    layers = params.get("NumHiddenLayers")
    nodes = params.get("NumHiddenNodes")
    acts = params.get("ActivationFunc")
    try:
        if layers is not None and nodes is not None \
                and int(layers) != len(nodes):
            problems.append("NumHiddenLayers must equal len(NumHiddenNodes)")
        if layers is not None and acts is not None \
                and int(layers) != len(acts):
            problems.append("NumHiddenLayers must equal len(ActivationFunc)")
    except (TypeError, ValueError):
        pass    # malformed values already reported by the per-key rules
    return problems


def validate_train_params(params: Dict[str, Any],
                          algorithm: Algorithm) -> List[str]:
    """Validate one trial's train#params against the schema.  Grid-search
    list-of-candidates values must be expanded BEFORE calling (use
    :func:`validate_train_conf`, which does)."""
    problems: List[str] = list(unknown_param_problems(params))
    alg = algorithm.name
    for key, v in (params or {}).items():
        rule = TRAIN_PARAM_RULES.get(key)
        if rule is None:
            continue    # reported above
        if rule.algs is not None and alg not in rule.algs:
            problems.append(f"train#params {key!r} does not apply to "
                            f"algorithm {alg} (valid for "
                            f"{list(rule.algs)})")
            continue
        problems.extend(_check_value(f"train#params.{key}", v, rule))
    problems.extend(_nn_shape_problems(params or {}, alg))
    return problems


TF_ONLY_PARAMS = tuple(k for k, r in TRAIN_PARAM_RULES.items()
                       if r.algs == ("TENSORFLOW",))


def tf_ignored_param_problems(train_conf) -> List[str]:
    """``algorithm=TENSORFLOW`` trains the same net on the NN path — the
    TF-on-YARN-only topology/resource params would be silently ignored
    there, so their presence fails loudly, listing every offender."""
    if train_conf.algorithm != Algorithm.TENSORFLOW:
        return []
    present = sorted(k for k in (train_conf.params or {})
                     if k in TF_ONLY_PARAMS)
    if not present:
        return []
    return [f"algorithm TENSORFLOW trains on the native NN path (no "
            f"TF-on-YARN ps/worker topology) — train#params {present} "
            "would be silently ignored; remove them or use a TF-on-YARN "
            "deployment"]


def validate_train_conf(train_conf) -> List[str]:
    """Validate train#params; grid-search candidates validate individually
    without materializing the cartesian product (every rule is per-key, so
    per-axis candidate checks are exact; only the NN shape cross-check
    walks its own 3-axis product)."""
    import itertools

    from ..train import grid_search
    params = train_conf.params or {}
    alg = train_conf.algorithm
    if not grid_search.is_grid_search(params):
        return validate_train_params(params, alg)

    problems: List[str] = []
    seen = set()

    def add(ps: Sequence[str]) -> None:
        for p in ps:
            if p not in seen:
                seen.add(p)
                problems.append(p)

    def candidates(k: str, v: Any) -> list:
        if isinstance(v, list) and grid_search._is_axis(k, v):
            return list(v)
        return [v]

    for k, v in params.items():
        for c in candidates(k, v):
            add(validate_train_params({k: c}, alg))
    shape = {k: candidates(k, params[k])
             for k in ("NumHiddenLayers", "NumHiddenNodes", "ActivationFunc")
             if k in params}
    if shape:
        keys = list(shape)
        for combo in itertools.product(*(shape[k] for k in keys)):
            add(_nn_shape_problems(dict(zip(keys, combo)), alg.name))
    return problems


def validate_config_fields(mc) -> List[str]:
    """Walk :data:`CONFIG_RULES`' dotted paths over the ModelConfig tree."""
    problems: List[str] = []
    for path, rule in CONFIG_RULES.items():
        obj = mc
        for part in path.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                break
        else:
            problems.extend(_check_value(path, obj, rule))
    return problems
