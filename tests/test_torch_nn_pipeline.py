"""The NN/LR slice end to end in each package: ``train`` then ``eval
-run`` on one prepared plane, the port through its CLI with ``--device
cpu``, the reference through its processors, each in a model set of its
own.

The plane is ``prepared_set``'s fraud CSV without its ``txn_id`` column (a
unique id whose categorical bins leak the target: with it every net
reaches zero error within four epochs), re-normalized once by the
reference.  The reference trains under ``jax.enable_x64(False)``: the
test rig's 64-bit mode (ROADMAP Queue 3, C3) would draw its initial
weights in float64, while every deployment of it, and the port, draws
them in float32 from the same threefry keys.

Tolerances: per-epoch train and validation errors (the ``%.6f`` progress
lines) within 1e-4 relative + 2e-6; per-row scores in the ``%.3f`` score
files within 5e-3 on the 0-1000 scale; AUC within ±0.005 (ROADMAP's
parity bound); multi-class accuracy within 0.005.  Model files of either
package load in the other.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

AUC_TOL = 0.005
SCORE_TOL = 5e-3
TAGS = ["t0", "t1", "t2"]


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


@pytest.fixture(scope="module")
def nn_template(tmp_path_factory, _prepared_template):
    """The prepared set with every candidate but ``txn_id`` final-selected
    and its norm plane rewritten by the reference."""
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    d = str(tmp_path_factory.mktemp("nn_pipeline") / "nnset")
    shutil.copytree(_prepared_template, d)
    path = os.path.join(d, "ColumnConfig.json")
    with open(path) as f:
        ccs = json.load(f)
    for c in ccs:
        if c.get("columnFlag") not in ("Target", "Weight", "Meta") \
                and c["columnName"] != "txn_id":
            c["finalSelect"] = True
    with open(path, "w") as f:
        json.dump(ccs, f, indent=1)
    assert NormalizeProcessor(d, params={}).run() == 0
    return d


@pytest.fixture(scope="module")
def three_class_template(tmp_path_factory):
    """A three-class set over a 1,200-row CSV (three informative numeric
    columns, an id kept out as meta), prepared by the reference with
    EqualTotal binning, as multi-class targets need."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import BinningMethod
    from shifu_tpu.pipeline.create import InitProcessor, create_new_model
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.stats import StatsProcessor
    root = str(tmp_path_factory.mktemp("nn_three_class"))
    rng = np.random.default_rng(8)
    n = 1200
    y = rng.integers(0, 3, n)
    f = [rng.normal(size=n) + (y == k) * 1.5 for k in range(3)]
    lines = ["id|f1|f2|f3|tag"] + [
        f"r{i}|{f[0][i]:.5f}|{f[1][i]:.5f}|{f[2][i]:.5f}|{TAGS[y[i]]}"
        for i in range(n)]
    csv = os.path.join(root, "mc.csv")
    with open(csv, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    meta = os.path.join(root, "meta.names")
    with open(meta, "w") as fh:
        fh.write("id\n")
    d = create_new_model("mcnn", base_dir=root)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.metaColumnNameFile = list(TAGS), [], meta
    mc.stats.binningMethod = BinningMethod.EqualTotal
    mc.evals[0].dataSet.dataPath = csv
    mc.evals[0].dataSet.dataDelimiter = "|"
    mc.save(path)
    assert InitProcessor(d).run() == 0
    assert StatsProcessor(d, params={}).run() == 0
    assert NormalizeProcessor(d, params={}).run() == 0
    return d


def _copies(template, tmp_path, algorithm, params, epochs=8, **train):
    """Two copies of ``template`` (reference, port) configured alike."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     MultipleClassification)
    out = []
    for who in ("ref", "port"):
        d = str(tmp_path / who)
        shutil.copytree(template, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm[algorithm]
        mc.train.params = dict(params)
        mc.train.numTrainEpochs = epochs
        for k, v in train.items():
            if k == "multiClassifyMethod":
                v = MultipleClassification[v]
            setattr(mc.train, k, v)
        mc.save(path)
        out.append(d)
    return out


def _ref_train(d, **params):
    from shifu_tpu.pipeline.train import TrainProcessor
    with jax.enable_x64(False):
        assert TrainProcessor(d, params=params).run() == 0


def _port_cli(d, *argv):
    from shifu_tpu_torch.cli import main
    assert main(["--dir", d, *argv, "--device", "cpu"]) == 0


def _ref_eval(d):
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    assert EvalProcessor(d, params={"run_eval": ""}).run() == 0


def _both(ref, port, *train_argv):
    _ref_train(ref, **{a.lstrip("-"): True for a in train_argv})
    _port_cli(port, "train", *train_argv)
    _ref_eval(ref)
    _port_cli(port, "eval", "-run")


def _progress(d):
    with open(os.path.join(d, "tmp", "train.progress")) as f:
        rows = [l.split() for l in f if "Epoch" in l]
    return np.array([[float(r[-4]), float(r[-1])] for r in rows])


def _perf(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalPerformance.json")) as f:
        return json.load(f)


def _scores(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalScore")) as f:
        header = f.readline().rstrip("\n").split("|")
        rows = [l.rstrip("\n").split("|") for l in f]
    cols = [i for i, h in enumerate(header)
            if h not in ("tag", "weight", "predictedTag")]
    return np.array([[float(r[i]) for i in cols] for r in rows])


def _models(d):
    return sorted(f for f in os.listdir(os.path.join(d, "models"))
                  if f.startswith("model"))


def _cross_load(ref, port):
    """Each package scores the other's model files."""
    from shifu_tpu.models import load_any as j_load
    from shifu_tpu_torch.models import load_any as p_load
    for f in _models(port):
        jm = j_load(os.path.join(port, "models", f))
        pm = p_load(os.path.join(ref, "models", f))
        x = np.zeros((4, pm.spec.input_dim), np.float32)
        assert np.asarray(jm.compute(x)).shape == \
            pm.compute(x, device="cpu").shape


def _assert_same(ref, port, multiclass=False):
    assert _models(ref) == _models(port)
    _cross_load(ref, port)
    np.testing.assert_allclose(_progress(port), _progress(ref), rtol=1e-4,
                               atol=2e-6)
    np.testing.assert_allclose(_scores(port), _scores(ref), rtol=0,
                               atol=SCORE_TOL)
    if multiclass:
        assert abs(_perf(port)["accuracy"] - _perf(ref)["accuracy"]) \
            <= 0.005
        return
    assert abs(_perf(port)["areaUnderRoc"] - _perf(ref)["areaUnderRoc"]) \
        <= AUC_TOL
    assert _perf(port)["areaUnderRoc"] > 0.75


NN = {"NumHiddenNodes": [6], "ActivationFunc": ["tanh"],
      "Propagation": "R"}
ADAM = {"NumHiddenNodes": [6], "ActivationFunc": ["relu"],
        "Propagation": "ADAM", "LearningRate": 0.05, "MiniBatchs": 400,
        "Loss": "log"}

BINARY = {
    "nn_rprop": ("NN", NN, {}),
    "lr": ("LR", {"Propagation": "ADAM", "LearningRate": 0.1}, {}),
    "nn_bagged": ("NN", NN, {"baggingNum": 3}),
    "nn_kfold_minibatch": ("NN", ADAM, {"isCrossValidation": True,
                                        "numKFold": 3}),
    "tensorflow_alias": ("TENSORFLOW", NN, {}),
}


@pytest.mark.parametrize("case", sorted(BINARY))
def test_binary_set_matches_reference(nn_template, tmp_path, case):
    alg, params, train = BINARY[case]
    ref, port = _copies(nn_template, tmp_path, alg, params, **train)
    _both(ref, port)
    _assert_same(ref, port)
    ext = "lr" if alg == "LR" else "nn"
    n = train.get("baggingNum", train.get("numKFold", 1))
    assert _models(port) == [f"model{i}.{ext}" for i in range(n)]


def test_grid_search_picks_the_same_best_trial(nn_template, tmp_path):
    params = dict(ADAM, LearningRate=[0.01, 0.05], RegularizedConstant=[
        0.0, 0.01])
    ref, port = _copies(nn_template, tmp_path, "NN", params)
    _both(ref, port)
    reports = []
    for d in (ref, port):
        with open(os.path.join(d, "tmp", "grid_search.json")) as f:
            reports.append(json.load(f))
    assert [(r["trial"], r["params"]) for r in reports[0]] == \
        [(r["trial"], r["params"]) for r in reports[1]]
    np.testing.assert_allclose([r["validError"] for r in reports[1]],
                               [r["validError"] for r in reports[0]],
                               rtol=1e-4)
    _assert_same(ref, port)


@pytest.mark.parametrize("method", ["ONEVSALL", "NATIVE"])
def test_multiclass_set_matches_reference(three_class_template, tmp_path,
                                          method):
    ref, port = _copies(three_class_template, tmp_path, "NN", NN,
                        multiClassifyMethod=method)
    _both(ref, port)
    _assert_same(ref, port, multiclass=True)
    assert _perf(port)["accuracy"] > 0.6
    n = 3 if method == "ONEVSALL" else 1
    assert _models(port) == [f"model{i}.nn" for i in range(n)]


def test_continuous_training_grows_the_saved_net(nn_template, tmp_path):
    """A second train with ``isContinuous`` and a wider layer fits each
    saved member into the new shape (``fit_params_into``) in both."""
    from shifu_tpu_torch.config import ModelConfig
    ref, port = _copies(nn_template, tmp_path, "NN", NN, epochs=4)
    _ref_train(ref)
    _port_cli(port, "train")
    for d in (ref, port):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.isContinuous = True
        mc.train.params = dict(NN, NumHiddenNodes=[9])
        mc.save(path)
    _both(ref, port)
    _assert_same(ref, port)
    from shifu_tpu_torch.models.nn import load_model
    spec, params = load_model(os.path.join(port, "models", "model0.nn"))
    assert spec.hidden_nodes == [9]


def test_shuffle_trains_on_permuted_rows(nn_template, tmp_path):
    ref, port = _copies(nn_template, tmp_path, "NN", NN, epochs=4)
    _both(ref, port, "-shuffle")
    _assert_same(ref, port)


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_narrow_precision_auc_within_the_pinned_bound(nn_template, tmp_path,
                                                      precision):
    """The reference's precision contract (``tests/test_mixed_precision.py``,
    ``EPS_AUC`` 0.01): the port's ``TrainPrecision`` run scores within
    0.01 AUC of its f32 run, and writes float32 model files."""
    base = {"NumHiddenNodes": [16], "ActivationFunc": ["relu"],
            "LearningRate": 0.01, "Propagation": "ADAM", "MiniBatchs": 512}
    aucs = []
    for i, params in enumerate((base, dict(base, TrainPrecision=precision))):
        _, d = _copies(nn_template, tmp_path / str(i), "NN", params)
        _port_cli(d, "train")
        _port_cli(d, "eval", "-run")
        aucs.append(_perf(d)["areaUnderRoc"])
    assert aucs[0] > 0.7
    assert abs(aucs[0] - aucs[1]) <= 0.01
    from shifu_tpu_torch.models.nn import load_model
    _, params = load_model(os.path.join(d, "models", "model0.nn"))
    assert params[0]["w"].dtype == torch.float32


@pytest.mark.parametrize("algorithm,argv,item", [
    ("WDL", ["-Dshifu.wdl.shardTables=on"], "item 12"),
    ("WDL", ["-Dshifu.train.streaming=on", "-Dshifu.dcn.elastic=true"],
     "item 12"),
    ("NN", ["-Dshifu.train.streaming=on", "-Dshifu.dcn.elastic=true"],
     "item 12"),
    ("LR", ["-Dshifu.train.memoryBudgetBytes=1000",
            "-Dshifu.dcn.elastic=true"], "item 12")])
def test_unported_paths_raise_naming_their_item(nn_template, tmp_path,
                                                monkeypatch, algorithm, argv,
                                                item):
    """Row-sharded WDL tables are ported: ``-Dshifu.wdl.shardTables=on``
    on one process trains and writes the replicated run's model files
    byte for byte.  The elastic combine (``-Dshifu.dcn.elastic``) is
    ported: with a controller id and no coordinator the streamed WDL, NN
    and LR train through the step board (a close record an epoch and one
    for the closing eval) and write their model."""
    from shifu_tpu_torch.cli import main
    from shifu_tpu_torch.config import environment
    replicated, d = _copies(nn_template, tmp_path, algorithm, {})
    if "-Dshifu.wdl.shardTables=on" in argv:
        try:
            assert main(["--dir", replicated, "train", "--device",
                         "cpu"]) == 0
            assert main([*argv, "--dir", d, "train", "--device",
                         "cpu"]) == 0
        finally:
            environment.reset_for_tests()
        assert _models(d) == _models(replicated) == ["model0.wdl"]
        for f in _models(d):
            with open(os.path.join(d, "models", f), "rb") as a, \
                    open(os.path.join(replicated, "models", f), "rb") as b:
                assert a.read() == b.read()
        return
    if "-Dshifu.dcn.elastic=true" not in argv:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 {item}"):
            main([*argv, "--dir", d, "train", "--device", "cpu"])
        assert _models(d) == []
        return
    monkeypatch.delenv("SHIFU_COORDINATOR", raising=False)
    monkeypatch.setenv("SHIFU_PROCESS_ID", "0")
    assert main([*argv, "--dir", d, "train", "--device", "cpu"]) == 0
    steps = os.path.join(d, "telemetry", "steps")
    assert any(f.startswith("close-") for f in os.listdir(steps))
    assert _models(d) != []


def test_eval_score_perf_and_confmat_on_an_lr_set(nn_template, tmp_path):
    """``eval -score -nosort`` writes the reference's score file (same rows,
    scores within SCORE_TOL); ``-perf`` and ``-confmat`` score the same set
    to the same AUC as ``-run``."""
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    ref, port = _copies(nn_template, tmp_path, "LR",
                        {"Propagation": "ADAM", "LearningRate": 0.1})
    _ref_train(ref)
    _port_cli(port, "train")
    assert EvalProcessor(ref, params={"score": "", "nosort": True}).run() \
        == 0
    _port_cli(port, "eval", "-score", "-nosort")
    np.testing.assert_allclose(_scores(port), _scores(ref), rtol=0,
                               atol=SCORE_TOL)
    _port_cli(port, "eval", "-run")
    auc = _perf(port)["areaUnderRoc"]
    for action in ("-perf", "-confmat"):
        os.remove(os.path.join(port, "evals", "Eval1",
                               "EvalPerformance.json"))
        _port_cli(port, "eval", action)
        assert _perf(port)["areaUnderRoc"] == auc
    assert os.path.isfile(os.path.join(port, "evals", "Eval1",
                                       "EvalConfusionMatrix"))
