"""Port parity for bagged and k-fold tree members: the sampling masks of
``train/sampling.py`` and ``_tree_member_masks`` against ``shifu_tpu``
(equal exactly: the same numpy generators from the same seeds), the
bagged trainers against single runs inside the port (bit for bit) and
against ``shifu_tpu``'s vmapped trainers, and ``TrainProcessor`` of both
packages (the port on ``device="cpu"``) on copies of the prepared fraud
model set with ``baggingNum`` and ``isCrossValidation``.

Tolerances: split features and left masks equal, with ``MinInfoGain
1e-3`` on GBT so that no split rides on f32 noise (C9); leaves and
``train.progress`` errors within rtol 1e-5 (C4: f32 sums in another
order); the RF k-fold held-out error within rtol 1e-5.
"""

import logging
import os
import re
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

GBT = {"TreeNum": 3, "MaxDepth": 3, "Loss": "log", "LearningRate": 0.1,
       "MinInfoGain": 1e-3}
RF = {"TreeNum": 3, "MaxDepth": 3, "Impurity": "entropy", "Loss": "log",
      "FeatureSubsetStrategy": "HALF", "MinInfoGain": 1e-3, "TreeBatch": 2}


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


# ------------------------------------------------------------- sampling
@pytest.mark.parametrize("kw", [
    dict(bags=1, valid_rate=0.2),
    dict(bags=4, valid_rate=0.1, sample_rate=0.7),
    dict(bags=3, valid_rate=0.2, sample_rate=0.8, replacement=True),
    dict(bags=2, valid_rate=0.3, stratified=True),
    dict(bags=5, valid_rate=0.0, kfold=5)])
def test_member_masks_match_the_reference(kw):
    from shifu_tpu.train import sampling as j_sampling
    from shifu_tpu_torch.train import sampling
    n = 997
    targets = (np.random.default_rng(1).random(n) < 0.3).astype(np.float32)
    bags = kw.pop("bags")
    for seed in (0, 7):
        got = sampling.member_masks(n, bags, targets=targets, seed=seed,
                                    **kw)
        want = j_sampling.member_masks(n, bags, targets=targets, seed=seed,
                                       **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(sampling.kfold_assignment(n, 4, 3),
                          j_sampling.kfold_assignment(n, 4, 3))


def _member_mask_configs(d):
    from shifu_tpu.config import ModelConfig as JModelConfig
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.baggingSampleRate = 0.8
    mc.train.baggingWithReplacement = True
    mc.save(path)
    return mc, JModelConfig.load(path)


@pytest.mark.parametrize("bags,kfold,rf_like,distinct", [
    (3, -1, False, True), (3, -1, False, False), (3, -1, True, True),
    (1, 4, False, True), (1, 4, True, True)])
def test_tree_member_masks_match_the_reference(prepared_set, bags, kfold,
                                               rf_like, distinct):
    from shifu_tpu.train.dt_trainer import _tree_member_masks as j_masks
    from shifu_tpu_torch.train.dt_trainer import _tree_member_masks
    mc, jmc = _member_mask_configs(prepared_set)
    y = (np.random.default_rng(2).random(500) < 0.4).astype(np.float32)
    got = _tree_member_masks(mc, 500, bags, kfold, rf_like, y, 5, distinct)
    want = j_masks(jmc, 500, bags, kfold, rf_like, y, 5, distinct)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ------------------------------------------------------------- trainers
def _tree_data(n=1200, c=6, n_bins=8, seed=3):
    """The reference grid test's plane: y follows columns 0 and 1."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, c)).astype(np.int32)
    logit = (bins[:, 0] - 3) * 0.8 + (bins[:, 1] == 2) * 1.5 - 0.5
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 3, size=n).astype(np.float32)
    return bins.astype(np.uint8), y, w


def _assert_bits(a, b):
    assert a.split_feat.tobytes() == b.split_feat.tobytes()
    assert a.left_mask.tobytes() == b.left_mask.tobytes()
    assert a.leaf_value.tobytes() == b.leaf_value.tobytes()


def _gbt_members():
    from shifu_tpu_torch.train.dt_trainer import DTSettings
    s = DTSettings(n_trees=4, depth=3, loss="log", learning_rate=0.1,
                   feature_subset="HALF", min_gain=1e-3, seed=0)
    return [s, replace(s, seed=1),
            replace(s, seed=2, learning_rate=0.3, min_instances=20.0)]


def test_gbt_bagged_members_equal_single_runs():
    """Each member of one ``train_gbt_bagged`` call (one grow_forest a
    round over the three members) equals ``train_gbt`` on its weights and
    settings bit for bit: trees, errors and init score."""
    from shifu_tpu_torch.train.dt_trainer import (train_gbt,
                                                  train_gbt_bagged)
    from shifu_tpu_torch.train.sampling import validation_split
    bins, y, w = _tree_data()
    members = _gbt_members()
    vm = [validation_split(len(y), s.valid_rate, s.seed) for s in members]
    tw = np.stack([w * ~v for v in vm])
    vw = np.stack([w * v for v in vm])
    bagged = train_gbt_bagged(bins, y, tw, vw, 8, None, members,
                              device="cpu")
    for s, rb in zip(members, bagged):
        r1 = train_gbt(bins, y, w, 8, None, s, device="cpu")
        assert len(r1.trees) == len(rb.trees) == 4
        for a, b in zip(r1.trees, rb.trees):
            _assert_bits(a, b)
        assert rb.history == r1.history
        assert rb.spec_kwargs == r1.spec_kwargs
        assert np.array_equal(rb.feature_importance, r1.feature_importance)
    assert bagged[0].history != bagged[2].history


def test_rf_bagged_members_equal_single_runs():
    from shifu_tpu_torch.train.dt_trainer import (DTSettings, train_rf,
                                                  train_rf_bagged)
    bins, y, w = _tree_data()
    s = DTSettings(n_trees=5, depth=3, impurity="entropy", loss="log",
                   feature_subset="HALF", seed=1, tree_batch=2)
    members = [s, replace(s, seed=2, bagging_rate=0.6)]
    w_m = np.stack([w, w * (np.arange(len(w)) % 3 > 0)])
    bagged = train_rf_bagged(bins, y, w_m, 8, None, members, device="cpu")
    for s_b, w_b, rb in zip(members, w_m, bagged):
        r1 = train_rf(bins, y, w_b, 8, None, s_b, device="cpu")
        for a, b in zip(r1.trees, rb.trees):
            _assert_bits(a, b)
        assert rb.history == r1.history


def _assert_close_forests(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.split_feat, b.split_feat)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


def test_bagged_trainers_match_the_reference():
    """The port's bagged GBT and RF against ``shifu_tpu``'s vmapped
    multi-forest trainers on the same members and weights."""
    from shifu_tpu.train import dt_trainer as jdt
    from shifu_tpu_torch.train import dt_trainer as pdt
    bins, y, w = _tree_data()
    rng = np.random.default_rng(4)
    vmask = rng.random((3, len(y))) < 0.2
    tw, vw = w * ~vmask, w * vmask
    members = _gbt_members()
    j_members = [jdt.DTSettings(**{k: getattr(s, k) for k in (
        "n_trees", "depth", "loss", "learning_rate", "feature_subset",
        "min_gain", "min_instances", "seed")}) for s in members]
    got = pdt.train_gbt_bagged(bins, y, tw, vw, 8, None, members,
                               device="cpu")
    want = jdt.train_gbt_bagged(bins.astype(np.int32), y, tw, vw, 8, None,
                                j_members)
    for g, r in zip(got, want):
        _assert_close_forests(g.trees, r.trees)
        np.testing.assert_allclose(g.history, r.history, rtol=1e-5)
        assert g.spec_kwargs["init_score"] == r.spec_kwargs["init_score"]
    s = pdt.DTSettings(n_trees=3, depth=3, impurity="entropy", loss="log",
                       min_gain=1e-3, seed=1)
    js = jdt.DTSettings(n_trees=3, depth=3, impurity="entropy", loss="log",
                        min_gain=1e-3, seed=1)
    w_m = np.stack([w, w * ~vmask[0]])
    got = pdt.train_rf_bagged(bins, y, w_m, 8, None,
                              [s, replace(s, seed=2)], device="cpu")
    want = jdt.train_rf_bagged(bins.astype(np.int32), y, w_m, 8, None,
                               [js, replace(js, seed=2)])
    for g, r in zip(got, want):
        _assert_close_forests(g.trees, r.trees)
        np.testing.assert_allclose(g.history, r.history, rtol=1e-5)


# ------------------------------------------------------------- pipeline
def _configure(d, algorithm, params, **train):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm[algorithm]
    mc.train.params = dict(params)
    for k, v in train.items():
        setattr(mc.train, k, v)
    mc.save(path)


def _train(pkg, d, **params):
    if pkg == "ref":
        from shifu_tpu.pipeline.train import TrainProcessor as JTrain
        assert JTrain(d, params=params).run() == 0
    else:
        from shifu_tpu_torch.pipeline.train import TrainProcessor
        assert TrainProcessor(d, params=params, device="cpu").run() == 0


CASES = {"gbt_bagged": ("GBT", GBT, dict(baggingNum=3)),
         "gbt_kfold": ("GBT", GBT, dict(isCrossValidation=True,
                                        numKFold=3)),
         "rf_kfold": ("RF", RF, dict(isCrossValidation=True, numKFold=3))}


@pytest.fixture(scope="module")
def sets(tmp_path_factory, _prepared_template):
    """{(package, case): model set dir}, trained once per module; the
    ``saved ... valid errors`` log line of each run rides along."""
    root = tmp_path_factory.mktemp("torch_bagging")
    out = {}
    for case, (alg, params, train) in CASES.items():
        for pkg in ("ref", "port"):
            d = str(root / f"{pkg}_{case}")
            shutil.copytree(_prepared_template, d)
            _configure(d, alg, params, **train)
            lines = []
            handler = logging.Handler()
            handler.emit = lambda r: lines.append(r.getMessage())
            logging.getLogger().addHandler(handler)
            level = logging.getLogger().level
            logging.getLogger().setLevel(logging.INFO)
            try:
                _train(pkg, d)
            finally:
                logging.getLogger().removeHandler(handler)
                logging.getLogger().setLevel(level)
            errs = [ln for ln in lines if "valid errors" in ln]
            out[pkg, case] = (d, errs[-1])
    return out


def _models(d):
    from shifu_tpu_torch.models.tree import load_model
    mdir = os.path.join(d, "models")
    return {f: load_model(os.path.join(mdir, f))
            for f in sorted(os.listdir(mdir)) if f.startswith("model")}


def _progress(d):
    text = open(os.path.join(d, "tmp", "train.progress")).read()
    return re.findall(r"(Bag \[\d+\]) Tree #\d+ Train Error: (\S+) "
                      r"Validation Error: (\S+)", text)


@pytest.mark.parametrize("case", list(CASES))
def test_members_match_the_reference(sets, case):
    (d_got, _), (d_want, _) = sets["port", case], sets["ref", case]
    got, want = _models(d_got), _models(d_want)
    ext = CASES[case][0].lower()
    assert sorted(got) == sorted(want) == [f"model{i}.{ext}"
                                           for i in range(3)]
    for name in got:
        assert got[name][0].to_json() == want[name][0].to_json()
        _assert_close_forests(got[name][1], want[name][1])
    p_got, p_want = _progress(d_got), _progress(d_want)
    assert [p[0] for p in p_got] == [p[0] for p in p_want]
    assert len(p_got) == 9
    np.testing.assert_allclose(np.asarray([p[1:] for p in p_got], float),
                               np.asarray([p[1:] for p in p_want], float),
                               rtol=1e-5)


def test_bagged_gbt_members_differ(sets):
    """Bags draw their own validation splits (``distinct``): three
    different forests from one config."""
    models = _models(sets["port", "gbt_bagged"][0])
    leaves = [np.concatenate([t.leaf_value for t in trees])
              for _, trees in models.values()]
    assert not np.array_equal(leaves[0], leaves[1])
    assert not np.array_equal(leaves[1], leaves[2])


def test_rf_kfold_held_out_error_matches_the_reference(sets):
    """RF k-fold scores each fold's forest on its held-out rows (the mean
    vote): the logged valid errors agree within rtol 1e-5, and the port's
    equal the held-out error recomputed from its saved forests."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.ops.tree import predict_forest
    from shifu_tpu_torch.train.sampling import kfold_assignment

    def logged(line):
        return np.asarray(re.search(r"valid errors \[(.*)\]",
                                    line).group(1).split(", "), float)
    (d, line), (_, j_line) = sets["port", "rf_kfold"], sets["ref", "rf_kfold"]
    np.testing.assert_allclose(logged(line), logged(j_line), rtol=1e-5)
    plane = Shards.open(os.path.join(d, "tmp", "CleanedData")).load_all()
    bins, y, w = plane["bins"], plane["y"], plane["w"]
    fold = kfold_assignment(len(y), 3, 0)
    for i, (_, trees) in enumerate(_models(d).values()):
        rows = fold == i
        vote = predict_forest(trees, torch.from_numpy(
            bins[rows].astype(np.int32))).numpy()
        p = np.clip(vote, 1e-9, 1 - 1e-9)
        per = -(y[rows] * np.log(p) + (1 - y[rows]) * np.log(1 - p))
        want = (per * w[rows]).sum() / w[rows].sum()
        assert logged(line)[i] == pytest.approx(want, rel=2e-6)


def test_each_package_loads_the_others_member_files(sets):
    from shifu_tpu.models.tree import load_model as j_load_model
    from shifu_tpu_torch.models.tree import load_model
    for case in ("gbt_bagged", "rf_kfold"):
        for pkg, loader in (("port", j_load_model), ("ref", load_model)):
            d = sets[pkg, case][0]
            for name, (spec, own) in _models(d).items():
                other_spec, trees = loader(os.path.join(d, "models", name))
                assert other_spec.to_json() == spec.to_json()
                for a, b in zip(trees, own):
                    _assert_bits(a, b)


def test_early_stop_members_train_one_by_one(prepared_set):
    """With ``earlyStopEnable`` GBT members run ``train_gbt`` one by one
    (a per-run decision loop): each bag equals a single run on its
    member weights."""
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.train.dt_trainer import (_tree_member_masks,
                                                  settings_from_params,
                                                  train_gbt)
    _configure(prepared_set, "GBT", dict(GBT, TreeNum=4), baggingNum=2,
               earlyStopEnable=True)
    _train("port", prepared_set)
    mc = ModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    shards = Shards.open(os.path.join(prepared_set, "tmp", "CleanedData"))
    plane = shards.load_all()
    by_num = {c.columnNum: c for c in load_column_configs(
        os.path.join(prepared_set, "ColumnConfig.json"))}
    cols = [by_num[cn] for cn in shards.schema["columnNums"]]
    cat = np.array([c.is_categorical() for c in cols])
    n_bins = max(c.num_bins() + 1 for c in cols)
    y, w = plane["y"], plane["w"]
    tw, vw = _tree_member_masks(mc, len(y), 2, -1, False, y, 0, True)
    base = settings_from_params(mc.train.params, mc.train, Algorithm.GBT)
    for b, (_, trees) in enumerate(_models(prepared_set).values()):
        res = train_gbt(plane["bins"], y, w * (tw[b] + vw[b] > 0), n_bins,
                        cat, replace(base, seed=b), device="cpu")
        assert len(res.trees) == len(trees)
        for a, t in zip(res.trees, trees):
            _assert_bits(a, t)
