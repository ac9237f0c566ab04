"""Port parity for config validation — ``shifu_tpu_torch.config.meta`` and
``config/validator.py::probe`` against ``shifu_tpu``'s.

Each scenario of ``tests/test_meta_validation.py`` becomes one
``ModelConfig.json``; both packages' ``probe`` run on it at every step,
and the ``ValidationError`` problem lists must be equal, in order (an
empty list where the step passes).  The field rules, the train#params
rules with grid candidates and the TENSORFLOW-only keys all reach
``probe`` on this path.
"""

import os

import pytest

pytestmark = pytest.mark.torch_port

STEPS = ("INIT", "STATS", "NORMALIZE", "VARSELECT", "TRAIN", "POSTTRAIN",
         "EVAL")


def _train(alg, params):
    def edit(mc):
        mc.train.algorithm = alg
        mc.train.params = params
    return edit


def _fields(**kv):
    def edit(mc):
        for path, v in kv.items():
            obj = mc
            parts = path.split("__")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            setattr(obj, parts[-1], v)
    return edit


SCENARIOS = {
    "unknown_key_with_suggestion": _train("NN", {"LearningRat": 0.1}),
    "unknown_key_without_match": _train("NN", {"Zorp": 1}),
    "known_keys_pass": _train("NN", {
        "LearningRate": 0.1, "Propagation": "ADAM",
        "NumHiddenNodes": [30, 10], "ActivationFunc": ["tanh", "relu"],
        "DropoutRate": 0.2, "MiniBatchs": 128, "Loss": "log", "Seed": 7}),
    "range_nn": _train("NN", {"LearningRate": 0.0, "DropoutRate": 1.0}),
    "range_trees": _train("GBT", {"MaxDepth": 25, "TreeNum": 0}),
    "types": _train("NN", {"MiniBatchs": 12.5, "NumHiddenNodes": 30}),
    "list_element_types": _train("NN", {"NumHiddenNodes": ["x"]}),
    "enums": _train("NN", {"Propagation": "WARP", "Loss": "huber",
                           "ActivationFunc": ["tanh", "zap"]}),
    "enum_case_insensitive": _train("RF", {"Impurity": "ENTROPY"}),
    "applicability": _train("NN", {"TreeNum": 100, "WideEnable": True}),
    "grid_trials": _train("NN", {"LearningRate": [0.1, 0.2, -1.0],
                                 "Propagation": ["ADAM", "WARP"]}),
    "grid_list_key_not_axis": _train("NN", {"NumHiddenNodes": [30, 10]}),
    "numeric_strings": _train("NN", {"LearningRate": "0.1",
                                     "MiniBatchs": "128"}),
    "nan_inf_strings": _train("NN", {"MiniBatchs": "nan",
                                     "LearningRate": "inf"}),
    "grid_shape_mismatch": _train("NN", {"NumHiddenLayers": [1, 3],
                                         "NumHiddenNodes": [[10], [10, 5]]}),
    "config_fields": _fields(train__baggingNum=0, train__validSetRate=1.0,
                             stats__maxNumBin=1),
    "bagging_sample_rate_5": _fields(train__baggingSampleRate=5.0),
    "more_fields": _fields(stats__sampleRate=0.0, normalize__stdDevCutOff=-1,
                           varSelect__filterNum=-3,
                           train__workerThreadCount=5000),
    "tf_only_params": _train("TENSORFLOW", {"LearningRate": 0.1, "NumPS": 2,
                                            "TFWorkerMemory": 2048}),
    "tf_key_on_nn": _train("NN", {"NumPS": 2}),
    "post_correlation_metric": _fields(varSelect__postCorrelationMetric="SE"),
}


def _problems(pkg, mdir, step):
    import importlib
    cfg = importlib.import_module(f"{pkg}.config.model_config")
    val = importlib.import_module(f"{pkg}.config.validator")
    mc = cfg.ModelConfig.load(os.path.join(mdir, "ModelConfig.json"))
    try:
        val.probe(mc, val.ModelStep[step], mdir)
    except val.ValidationError as e:
        return list(e.problems)
    return []


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_probe_problem_lists_equal(model_set, name):
    from shifu_tpu.config.model_config import ModelConfig
    path = os.path.join(model_set, "ModelConfig.json")
    mc = ModelConfig.load(path)
    SCENARIOS[name](mc)
    mc.save(path)
    for step in STEPS:
        ref = _problems("shifu_tpu", model_set, step)
        port = _problems("shifu_tpu_torch", model_set, step)
        assert port == ref, (name, step)
    if name == "bagging_sample_rate_5":
        assert any("baggingSampleRate" in p
                   for p in _problems("shifu_tpu_torch", model_set, "TRAIN"))


def test_meta_functions_agree_with_reference():
    from shifu_tpu.config import meta as rmeta
    from shifu_tpu.config.model_config import Algorithm, ModelTrainConf
    from shifu_tpu_torch.config import meta as pmeta
    from shifu_tpu_torch.config.model_config import Algorithm as PAlg
    from shifu_tpu_torch.config.model_config import ModelTrainConf as PConf
    assert list(pmeta.CONFIG_RULES) == list(rmeta.CONFIG_RULES)
    for k, r in rmeta.CONFIG_RULES.items():
        assert vars(pmeta.CONFIG_RULES[k]) == vars(r)
    params = {"LearningRate": [0.1] * 49 + [-1.0], "MiniBatchs": [1, 2.5]}
    assert pmeta.validate_train_conf(PConf(algorithm=PAlg.NN,
                                           params=params)) == \
        rmeta.validate_train_conf(ModelTrainConf(algorithm=Algorithm.NN,
                                                 params=params))


def test_train_dry_validates_logs_and_trains_nothing(prepared_set, tmp_path,
                                                     caplog):
    """``train -dry``: both packages probe the config, log the same plan
    line, return 0 and write no model; a config the probe refuses fails
    before the dry run."""
    import logging
    import shutil
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch.cli import main
    lines = []
    for run, name, extra in ((jmain, "ref", []),
                             (main, "port", ["--device", "cpu"])):
        d = str(tmp_path / name)
        shutil.copytree(prepared_set, d)
        shutil.rmtree(os.path.join(d, "models"), ignore_errors=True)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert run(["--dir", d, "train", "-dry", *extra]) == 0
        lines.append([r.getMessage() for r in caplog.records
                      if r.getMessage().startswith("dry run:")])
        models = os.path.join(d, "models")
        assert not os.path.isdir(models) or not os.listdir(models)
    assert lines[0] == lines[1] and len(lines[0]) == 1
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.config.validator import ValidationError
    path = os.path.join(str(tmp_path / "port"), "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.baggingSampleRate = 5.0
    mc.save(path)
    with pytest.raises(ValidationError, match="baggingSampleRate"):
        main(["--dir", str(tmp_path / "port"), "train", "-dry", "--device",
              "cpu"])


def test_jsonbean_coerces_as_the_reference():
    """The port's config loader builds one coercer a field type; a
    ColumnConfig and a ModelConfig of awkward JSON (ints in float lists,
    integral floats in int lists, nulls inside lists, booleans as
    strings, enums by name and by value in any case, unknown keys at
    every level) load to the reference's values, types included."""
    from shifu_tpu.config import jsonbean as rjb
    from shifu_tpu.config.column_config import ColumnConfig as RCC
    from shifu_tpu.config.model_config import ModelConfig as RMC
    from shifu_tpu_torch.config import jsonbean as pjb
    from shifu_tpu_torch.config.column_config import ColumnConfig as PCC
    from shifu_tpu_torch.config.model_config import ModelConfig as PMC

    def typed(x):
        if isinstance(x, dict):
            return {k: typed(v) for k, v in x.items()}
        if isinstance(x, list):
            return [typed(v) for v in x]
        return (type(x).__name__, x)

    cc = {"columnNum": 3.0, "columnName": "c", "columnType": "c",
          "columnFlag": "target", "finalSelect": "TRUE",
          "sampleValues": ["a", None], "hybridThreshold": 2,
          "columnStats": {"max": 7, "totalCount": 10.0, "unitStats": None,
                          "psi": None, "newStat": [1, 2]},
          "columnBinning": {"length": 4.0, "binBoundary": [1, 2.5, None],
                            "binCountPos": [3.0, 4, None],
                            "binCategory": ["x", "y"], "odd": {"k": 1}},
          "future": 1}
    mc = {"basic": {"name": "m", "extraKey": True},
          "dataSet": {"dataPath": "p", "posTags": ["1"]},
          "train": {"algorithm": "gbt", "baggingNum": 2.0,
                    "validSetRate": 0, "params": {"TreeNum": 3}},
          "evals": [{"name": "e", "dataSet": {"dataPath": "q"}}]}
    for rcls, pcls, doc in ((RCC, PCC, cc), (RMC, PMC, mc)):
        ref, port = rjb.from_dict(rcls, doc), pjb.from_dict(pcls, doc)
        assert typed(pjb.to_dict(port)) == typed(rjb.to_dict(ref))
