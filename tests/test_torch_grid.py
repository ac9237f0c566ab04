"""Port parity for tree grid search: ``train/grid_search.py`` (the
cartesian expansion, the stackable groups, the ``gridConfigFile``
parser), ``config/meta.py::validate_train_params`` and
``TrainProcessor._trials`` against ``shifu_tpu`` (equal exactly: the same
pure Python), the grid trials of one structure trained together equal to
single runs inside the port (bit for bit), and ``TrainProcessor`` of both
packages (the port on ``device="cpu"``) on copies of the prepared fraud
model set with list-valued ``train#params``.

Tolerances: trials, groups, problems and the best trial's index equal;
the grid report's valid errors within rtol 1e-5 (C4); the best trial's
forest with equal split features and left masks (``MinInfoGain 1e-3``,
C9) and leaves within rtol 1e-5.
"""

import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

GRID = {"TreeNum": 3, "MaxDepth": [2, 3], "Loss": "log",
        "LearningRate": [0.1, 0.3], "MinInfoGain": 1e-3}

PARAMS = [
    {"TreeNum": 5, "MaxDepth": 4},
    {"TreeNum": [5, 10], "MaxDepth": [3, 4], "LearningRate": 0.1},
    {"NumHiddenNodes": [10, 5], "ActivationFunc": ["tanh", "tanh"],
     "LearningRate": [0.1, 0.2]},
    {"NumHiddenNodes": [[10], [20, 5]], "Propagation": ["ADAM", "R"],
     "LearningRate": [0.1, 0.5]},
    {"MinInstancesPerNode": [1, 5], "Seed": [0, 1], "MaxDepth": [3, 5],
     "Impurity": "entropy"}]


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


@pytest.mark.parametrize("params", PARAMS)
def test_expansion_and_groups_match_the_reference(params):
    from shifu_tpu.train import grid_search as j_gs
    from shifu_tpu_torch.train import grid_search as gs
    assert gs.is_grid_search(params) == j_gs.is_grid_search(params)
    trials = gs.expand(params)
    assert trials == j_gs.expand(params)
    assert gs.stackable_groups(trials) == j_gs.stackable_groups(trials)
    assert gs.tree_stackable_groups(trials) == \
        j_gs.tree_stackable_groups(trials)


def test_grid_config_file_and_report_match_the_reference(tmp_path):
    from shifu_tpu.train import grid_search as j_gs
    from shifu_tpu_torch.train import grid_search as gs
    path = tmp_path / "grid.conf"
    path.write_text("# trials\nTreeNum:5;MaxDepth:3\n\n"
                    "TreeNum:8; Impurity:gini;NumHiddenNodes:[4, 2]\n"
                    "LearningRate:0.2;Loss:log;\n")
    assert gs.load_grid_config(str(path)) == \
        j_gs.load_grid_config(str(path))
    path.write_text("TreeNum=5\n")
    for mod in (gs, j_gs):
        with pytest.raises(ValueError, match="expected <name>:<value>"):
            mod.load_grid_config(str(path))
    errs = [0.3, 0.1, 0.2, 0.1]
    trials = [{"a": i} for i in range(4)]
    order = gs.rank_and_report(str(tmp_path / "p"), errs, trials)
    assert order == j_gs.rank_and_report(str(tmp_path / "r"), errs, trials)
    assert json.load(open(tmp_path / "p" / "grid_search.json")) == \
        json.load(open(tmp_path / "r" / "grid_search.json"))


@pytest.mark.parametrize("alg,params", [
    ("GBT", {"TreeNum": 5, "MaxDepth": 30, "Impurity": "variance"}),
    ("GBT", {"TreeNm": 5, "LearningRate": 0.0}),
    ("RF", {"FeatureSubsetStrategy": "HALF", "Propagation": "ADAM"}),
    ("NN", {"NumHiddenLayers": 2, "NumHiddenNodes": [3],
            "ActivationFunc": ["tanh", "relu"], "DropoutRate": 1.0}),
    ("RF", {"TreeNum": "7", "MinInfoGain": "nan", "Seed": 1.5}),
    ("GBT", {"Loss": "hinge", "MaxLeaves": -1, "EnableEarlyStop": "yes"})])
def test_validate_train_params_matches_the_reference(alg, params):
    from shifu_tpu.config.meta import validate_train_params as j_validate
    from shifu_tpu.config.model_config import Algorithm as JAlgorithm
    from shifu_tpu_torch.config.meta import validate_train_params
    from shifu_tpu_torch.config.model_config import Algorithm
    assert validate_train_params(params, Algorithm[alg]) == \
        j_validate(params, JAlgorithm[alg])


def _processors(d):
    from shifu_tpu.pipeline.train import TrainProcessor as JTrain
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    port, ref = TrainProcessor(d, device="cpu"), JTrain(d)
    port.setup()
    ref.setup()
    return port, ref


@pytest.mark.parametrize("lines,params", [
    ("MaxDepth:3\nMaxDepth:4;LearningRate:0.3\n",
     {"TreeNum": 4, "LearningRate": [0.1, 0.2]}),
    ("TreeNum:4\nTreeNum:4\nImpurity:friedmanmse\n", {"MaxDepth": 3})])
def test_trials_match_the_reference(prepared_set, lines, params):
    """File trials merge over the expanded list-valued params, exact
    duplicates drop, each trial validates."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    conf = os.path.join(prepared_set, "grid.conf")
    with open(conf, "w") as f:
        f.write(lines)
    path = os.path.join(prepared_set, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.gridConfigFile = "grid.conf"
    mc.save(path)
    port, ref = _processors(prepared_set)
    trials = port._trials(dict(params))
    assert trials == ref._trials(dict(params)) and len(trials) > 1
    mc.train.gridConfigFile = None
    mc.save(path)
    port, ref = _processors(prepared_set)
    assert port._trials(dict(params)) == ref._trials(dict(params))


def test_invalid_grid_file_trial_raises_as_the_reference(prepared_set):
    from shifu_tpu.config.validator import ValidationError as JError
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.config.validator import ValidationError
    with open(os.path.join(prepared_set, "grid.conf"), "w") as f:
        f.write("MaxDepth:3\nMaxDepht:4\nTreeNum:0\n")
    path = os.path.join(prepared_set, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.gridConfigFile = "grid.conf"
    mc.save(path)
    port, ref = _processors(prepared_set)
    with pytest.raises(ValidationError) as got:
        port._trials({"TreeNum": 3})
    with pytest.raises(JError) as want:
        ref._trials({"TreeNum": 3})
    assert got.value.problems == want.value.problems
    assert any("trial 2" in p and "MaxDepht" in p
               for p in got.value.problems)


def test_stacked_trials_equal_single_runs():
    """Grid trials differing in LearningRate, MinInstancesPerNode and
    MinInfoGain grow side by side (one grow_forest a round) and each
    equals ``train_gbt`` with its settings bit for bit."""
    from shifu_tpu_torch.train.dt_trainer import (DTSettings, train_gbt,
                                                  train_gbt_bagged)
    from shifu_tpu_torch.train.sampling import validation_split
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 7, size=(900, 5)).astype(np.uint8)
    y = (rng.random(900) < 1 / (1 + np.exp(-(bins[:, 0] - 3.0)))) \
        .astype(np.float32)
    w = np.ones(900, np.float32)
    s = DTSettings(n_trees=3, depth=3, loss="log", seed=0)
    trials = [s, replace(s, learning_rate=0.4),
              replace(s, min_instances=200.0, min_gain=0.05)]
    vmask = validation_split(900, s.valid_rate, s.seed)
    tw = np.repeat((w * ~vmask)[None], 3, axis=0)
    vw = np.repeat((w * vmask)[None], 3, axis=0)
    stacked = train_gbt_bagged(bins, y, tw, vw, 8, None, trials,
                               device="cpu")
    for t, rb in zip(trials, stacked):
        r1 = train_gbt(bins, y, w, 8, None, t, device="cpu")
        for a, b in zip(r1.trees, rb.trees):
            assert a.split_feat.tobytes() == b.split_feat.tobytes()
            assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
        assert rb.history == r1.history
    assert len({r.valid_error for r in stacked}) == 3


@pytest.fixture(scope="module")
def grid_sets(tmp_path_factory, _prepared_template):
    from shifu_tpu.pipeline.train import TrainProcessor as JTrain
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    root = tmp_path_factory.mktemp("torch_grid")
    out = {}
    for pkg in ("ref", "port"):
        d = str(root / pkg)
        shutil.copytree(_prepared_template, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.GBT
        mc.train.params = dict(GRID)
        mc.save(path)
        proc = JTrain(d, params={}) if pkg == "ref" else \
            TrainProcessor(d, params={}, device="cpu")
        assert proc.run() == 0
        out[pkg] = d
    return out


def test_grid_search_matches_the_reference(grid_sets):
    from shifu_tpu_torch.models.tree import load_model
    reports = [json.load(open(os.path.join(grid_sets[pkg], "tmp",
                                           "grid_search.json")))
               for pkg in ("port", "ref")]
    got, want = reports
    assert len(got) == len(want) == 4
    assert [r["trial"] for r in got] == [r["trial"] for r in want]
    assert [r["params"] for r in got] == [r["params"] for r in want]
    np.testing.assert_allclose([r["validError"] for r in got],
                               [r["validError"] for r in want], rtol=1e-5)
    models = [sorted(f for f in os.listdir(os.path.join(grid_sets[pkg],
                                                        "models"))
                     if f.startswith("model")) for pkg in ("port", "ref")]
    assert models[0] == models[1] == ["model0.gbt"]
    (gs, gt), (ws, wt) = [load_model(os.path.join(grid_sets[pkg], "models",
                                                  "model0.gbt"))
                          for pkg in ("port", "ref")]
    assert gs.to_json() == ws.to_json()
    assert gs.depth == got[0]["params"]["MaxDepth"]
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a.split_feat, b.split_feat)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    progress = open(os.path.join(grid_sets["port"], "tmp",
                                 "train.progress")).read()
    assert all(f"Trial [{i}] Tree #3" in progress for i in range(4))
