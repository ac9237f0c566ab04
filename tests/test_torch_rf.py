"""Port parity for the Random Forest / decision-tree training slice:
``ops.tree.grow_forest`` against per-tree ``grow_tree`` and against the
reference's ``grow_forest_jit`` on the same bags, ``TrainProcessor`` of
``shifu_tpu`` and of ``shifu_tpu_torch`` (``device="cpu"``) on two copies
of the prepared fraud model set with ``train.algorithm`` RF and DT, the
files both packages read and write (``models/model0.rf``/``.dt``, the
forest checkpoint), resume, and the tree batch.

Tolerances: ``train.progress`` errors within 1e-5 relative (f32 sums in
another order), leaf values within 1e-6 (they are ratios of exact bag
counts), AUC within 0.005.  As for GBT (ROADMAP Queue 3, C9), splits
whose gain is f32 rounding noise may go either way between the packages,
so the structure is pinned on the prepared set with a gain floor
(``MinInfoGain 1e-3``) and, at the ops level, on a plane whose target
follows three columns with well-separated gains.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

RF = {"TreeNum": 10, "MaxDepth": 5, "Impurity": "entropy",
      "FeatureSubsetStrategy": "TWOTHIRDS", "MinInstancesPerNode": 1,
      "MinInfoGain": 1e-3, "Loss": "squared", "TreeBatch": 4,
      "CheckpointInterval": 8}
DT = {"MaxDepth": 5, "Impurity": "gini", "MinInfoGain": 1e-3}


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _copy(template, root, name, alg, params):
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    d = str(root / name)
    shutil.copytree(template, d)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.algorithm = Algorithm[alg]
    mc.train.params = dict(params)
    mc.save(os.path.join(d, "ModelConfig.json"))
    return d


def _set_params(d, params):
    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.params = dict(params)
    mc.save(os.path.join(d, "ModelConfig.json"))


def _train_ref(d, **params):
    from shifu_tpu.pipeline.train import TrainProcessor
    assert TrainProcessor(d, params=params).run() == 0


def _train_port(d, **params):
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    assert TrainProcessor(d, params=params, device="cpu").run() == 0


@pytest.fixture(scope="module")
def sets(tmp_path_factory, _prepared_template):
    """{(package, algorithm): model set dir}, trained once per module."""
    root = tmp_path_factory.mktemp("torch_rf")
    out = {}
    for pkg, train in (("ref", _train_ref), ("port", _train_port)):
        for alg, params in (("RF", RF), ("DT", DT)):
            d = _copy(_prepared_template, root, f"{pkg}_{alg}", alg, params)
            train(d)
            out[pkg, alg] = d
    return out


def _forest(d, name="models/model0.rf"):
    from shifu_tpu_torch.models.tree import load_model
    return load_model(os.path.join(d, name))


def _progress(d):
    text = open(os.path.join(d, "tmp", "train.progress")).read()
    return np.array([[float(a), float(b)] for a, b in re.findall(
        r"Train Error: (\S+) Validation Error: (\S+)", text)])


def _plane(d):
    from shifu_tpu_torch.data.shards import Shards
    data = Shards.open(os.path.join(d, "tmp", "CleanedData")).load_all()
    return data["bins"], data["y"]


def _auc(score, y):
    _, inv, cnt = np.unique(score, return_inverse=True, return_counts=True)
    rank = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
    pos = y > 0.5
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((rank[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def _assert_same_forest(got, want, bits=False):
    (gs, gt), (ws, wt) = got, want
    assert gs.to_json() == ws.to_json()
    assert len(gt) == len(wt) == ws.n_trees
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a.split_feat, b.split_feat)
        np.testing.assert_array_equal(a.left_mask, b.left_mask)
        if bits:
            assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
        else:
            np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                       atol=1e-6)


# ---------------------------------------------------------------- ops
def _separated(n=4000, c=10, b=16, seed=0):
    """Bins, y with well-separated gains on columns 1, 4 and the
    categorical column 6, and one Poisson bag per tree."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(np.uint8)
    effect = rng.normal(0, 1.5, size=b)
    logit = 2.0 * (bins[:, 1] > 9) - 1.5 * (bins[:, 4] < 5) \
        + effect[bins[:, 6]] - 0.3
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    cat = np.zeros(c, bool)
    cat[6] = True
    return bins, y, cat, rng


@pytest.mark.parametrize("impurity", ["entropy", "gini"])
@pytest.mark.parametrize("max_leaves", [0, 12])
def test_grow_forest_equals_grow_tree_per_tree(impurity, max_leaves):
    from shifu_tpu_torch.ops import tree as tt
    bins, y, cat, rng = _separated(seed=1)
    bags = rng.poisson(1.0, size=(5, len(y))).astype(np.float32)
    stats = torch.from_numpy(np.stack([bags, bags * y], axis=2))
    fa = torch.from_numpy(rng.random((5, bins.shape[1])) < 0.7)
    b, ct = torch.from_numpy(bins), torch.from_numpy(cat)
    forest = tt.grow_forest(b, stats, ct, fa, 16, 6, impurity, 1.0, 0.0,
                            max_leaves)
    assert len(forest) == 5
    for t in range(5):
        one = tt.grow_tree(b, stats[t], ct, fa[t], 16, 6, impurity, 1.0, 0.0,
                           max_leaves)
        for x, z in zip(forest[t], one):
            assert torch.equal(x, z), t


@pytest.mark.parametrize("impurity", ["entropy", "gini"])
def test_same_bags_grow_the_reference_forest(impurity):
    """Given the same bags, the port's grow_forest and the reference's
    grow_forest_jit choose the same splits and masks, route every row to
    the same leaf, and agree on leaves within 1e-6."""
    import jax.numpy as jnp
    from shifu_tpu.ops import tree as jt
    from shifu_tpu_torch.ops import tree as tt
    bins, y, cat, rng = _separated(seed=2)
    bags = rng.poisson(1.0, size=(4, len(y))).astype(np.float32)
    stats = np.stack([bags, bags * y], axis=2).astype(np.float32)
    fa = rng.random((4, bins.shape[1])) < 0.8
    want = jt.grow_forest_jit(jnp.asarray(bins), jnp.asarray(stats),
                              jnp.asarray(cat), jnp.asarray(fa), 16, 5,
                              impurity, 20.0, 0.5)
    got = tt.grow_forest(torch.from_numpy(bins), torch.from_numpy(stats),
                         torch.from_numpy(cat), torch.from_numpy(fa), 16, 5,
                         impurity, 20.0, 0.5)
    splits = 0
    for t in range(4):
        sf, lm, lv, fi, lg = (x.numpy() for x in got[t])
        np.testing.assert_array_equal(sf, np.asarray(want[0][t]))
        np.testing.assert_array_equal(lm, np.asarray(want[1][t]))
        np.testing.assert_allclose(lv, np.asarray(want[2][t]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(fi, np.asarray(want[3][t]), rtol=1e-5)
        np.testing.assert_array_equal(lg, np.asarray(want[4][t]))
        splits += int((sf >= 0).sum())
    assert splits >= 20


# ---------------------------------------------------------- train CLI
def test_rf_train_matches_the_reference(sets):
    """The same forest (splits and masks equal, leaves within 1e-6), the
    same progress errors and AUC within 0.005."""
    from shifu_tpu.models.tree import IndependentTreeModel as JModel
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    _assert_same_forest(_forest(sets["port", "RF"]),
                        _forest(sets["ref", "RF"]))
    p_got, p_want = _progress(sets["port", "RF"]), _progress(sets["ref", "RF"])
    assert p_got.shape == p_want.shape == (10, 2)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-5)
    trees = _forest(sets["ref", "RF"])[1]
    assert sum(int((t.split_feat >= 0).sum()) for t in trees) >= 20
    bins, y = _plane(sets["ref", "RF"])
    path = "models/model0.rf"
    got = IndependentTreeModel.load(os.path.join(sets["port", "RF"], path)) \
        .compute(bins, device="cpu")[:, 0]
    want = np.asarray(JModel.load(os.path.join(sets["ref", "RF"], path))
                      .compute(np.asarray(bins, np.int32))).reshape(-1)
    assert abs(_auc(got, y) - _auc(want, y)) <= 0.005
    assert _auc(got, y) > 0.6


def test_rf_train_writes_the_reference_files(sets):
    for pkg in ("ref", "port"):
        d = sets[pkg, "RF"]
        ck = os.path.join(d, "tmp", "checkpoints", "forest_ckpt.npz")
        for f in ("models/model0.rf", "tmp/train.progress",
                  "tmp/feature_importance.json", "tmp/journal/TRAIN.json",
                  "tmp/profile.json"):
            assert os.path.isfile(os.path.join(d, f)), (pkg, f)
        assert os.path.isfile(ck) and os.path.isfile(ck + ".meta.json")
        assert not os.path.exists(ck + ".scores.npz")       # GBT only
    metas = [json.load(open(os.path.join(
        sets[pkg, "RF"], "tmp", "checkpoints", "forest_ckpt.npz.meta.json")))
        for pkg in ("port", "ref")]
    assert metas[0]["trees_done"] == metas[1]["trees_done"] == 10
    np.testing.assert_allclose(metas[0]["history"], metas[1]["history"],
                               rtol=1e-5)
    _assert_same_forest(_forest(sets["port", "RF"],
                                "tmp/checkpoints/forest_ckpt.npz"),
                        _forest(sets["ref", "RF"],
                                "tmp/checkpoints/forest_ckpt.npz"))
    fis = [json.load(open(os.path.join(sets[pkg, "RF"], "tmp",
                                       "feature_importance.json")))
           for pkg in ("port", "ref")]
    assert list(fis[0]) == list(fis[1])
    np.testing.assert_allclose(list(fis[0].values()), list(fis[1].values()),
                               rtol=1e-4, atol=1e-6)
    with open(os.path.join(sets["port", "RF"], "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    assert all(p in phases for p in ("train/upload", "train/grow",
                                     "train/checkpoint"))


def test_each_package_loads_the_others_rf_model(sets):
    from shifu_tpu.models.tree import load_model as j_load_model
    from shifu_tpu_torch.models.tree import load_model
    for d_from, loader in ((sets["port", "RF"], j_load_model),
                           (sets["ref", "RF"], load_model)):
        spec, trees = loader(os.path.join(d_from, "models/model0.rf"))
        own_spec, own = _forest(d_from)
        assert spec.to_json() == own_spec.to_json()
        assert spec.algorithm == "RF" and len(trees) == 10
        for a, b in zip(trees, own):
            np.testing.assert_array_equal(a.split_feat, b.split_feat)
            np.testing.assert_array_equal(a.left_mask, b.left_mask)
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_dt_trains_one_unbagged_tree_like_the_reference(sets):
    """DT: one tree over every row (no bag, so no out-of-bag vote and a
    0 validation error), saved as model0.dt and scored as the mean over
    its one tree, by both packages alike."""
    from shifu_tpu.models.tree import IndependentTreeModel as JModel
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    name = "models/model0.dt"
    _assert_same_forest(_forest(sets["port", "DT"], name),
                        _forest(sets["ref", "DT"], name))
    spec, trees = _forest(sets["port", "DT"], name)
    assert spec.algorithm == "DT" and len(trees) == 1
    p_got, p_want = _progress(sets["port", "DT"]), _progress(sets["ref", "DT"])
    assert p_got.shape == (1, 2) and p_got[0, 1] == 0.0
    np.testing.assert_allclose(p_got, p_want, rtol=1e-5)
    bins, _ = _plane(sets["ref", "DT"])
    path = os.path.join(sets["port", "DT"], name)
    got = IndependentTreeModel.load(path).compute(bins, device="cpu")
    want = np.asarray(JModel.load(path).compute(np.asarray(bins, np.int32)))
    np.testing.assert_allclose(got.reshape(-1), want.reshape(-1), rtol=1e-6)
    node = np.zeros(len(bins), np.int64)          # walk the one tree by hand
    t = trees[0]
    for _ in range(t.depth):
        f = t.split_feat[node]
        left = t.left_mask[node, bins[np.arange(len(bins)), np.maximum(f, 0)]]
        node = np.where(f >= 0, np.where(left, 2 * node + 1, 2 * node + 2),
                        node)
    np.testing.assert_array_equal(got[:, 0], t.leaf_value[node])


# --------------------------------------------------------------- resume
def test_rf_resume_is_bit_identical(sets, tmp_path, _prepared_template,
                                    monkeypatch):
    """8 trees, then `train -resume` to 10: the restored trees replay
    their bags through one forest walk (B4's plain version here) and the
    finished forest is the uninterrupted one, bit for bit."""
    from shifu_tpu_torch.ops import tree_quant as tq
    d = _copy(_prepared_template, tmp_path, "resume", "RF",
              dict(RF, TreeNum=8))
    _train_port(d)
    _set_params(d, RF)
    walks = []
    real = tq.predict_forest_quant_ref
    monkeypatch.setattr(tq, "predict_forest_quant_ref",
                        lambda *a: walks.append(a[0].shape) or real(*a))
    _train_port(d, resume=True)
    assert walks == [(8, 63)]               # 8 restored depth-5 trees
    _assert_same_forest(_forest(d), _forest(sets["port", "RF"]), bits=True)
    assert _progress(d).shape == (2, 2)
    np.testing.assert_array_equal(_progress(d), _progress(sets["port", "RF"])[8:])
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        assert "train/replay" in json.load(f)["TRAIN"]["phases_s"]


def test_port_resumes_the_reference_checkpoint(sets, tmp_path,
                                               _prepared_template):
    """shifu_tpu writes an 8-tree RF checkpoint; the port's `train
    -resume` re-draws the 8 bags on the same threefry stream and grows
    the 2 trees shifu_tpu grows uninterrupted."""
    from shifu_tpu_torch.cli import main
    d = _copy(_prepared_template, tmp_path, "ref_resume", "RF",
              dict(RF, TreeNum=8))
    _train_ref(d)
    _set_params(d, RF)
    assert main(["--dir", d, "train", "-resume", "--device", "cpu"]) == 0
    _assert_same_forest(_forest(d), _forest(sets["ref", "RF"]))
    np.testing.assert_allclose(_progress(d), _progress(sets["ref", "RF"])[8:],
                               rtol=1e-5)


# ---------------------------------------------------------- tree batch
@pytest.mark.parametrize("env", [None, "1"])
def test_tree_batch_8_equals_tree_batch_1(env, monkeypatch):
    """Growing 10 trees in a batch of 8 plus 2 single trees (or, with
    SHIFU_TREE_BATCH=1, all one by one) gives the forest, errors and
    importance of TreeBatch 1 bit for bit."""
    from shifu_tpu_torch.train import dt_trainer as dt
    bins, y, cat, rng = _separated(n=3000, seed=3)
    w = rng.integers(1, 4, size=len(y)).astype(np.float32)
    runs = []
    for tb in (8, 1):
        if env:
            monkeypatch.setenv("SHIFU_TREE_BATCH", env)
        settings = dt.DTSettings(n_trees=10, depth=6, impurity="entropy",
                                 feature_subset="TWOTHIRDS", tree_batch=tb,
                                 seed=11, bagging_rate=0.8)
        assert dt._effective_tree_batch(settings) == int(env or tb)
        runs.append(dt.train_rf(bins, y, w, 16, cat, settings,
                                device="cpu"))
    a, b = runs
    assert len(a.trees) == len(b.trees) == 10 and a.history == b.history
    np.testing.assert_array_equal(a.feature_importance, b.feature_importance)
    for x, z in zip(a.trees, b.trees):
        assert x.split_feat.tobytes() == z.split_feat.tobytes()
        assert x.left_mask.tobytes() == z.left_mask.tobytes()
        assert x.leaf_value.tobytes() == z.leaf_value.tobytes()


# ------------------------------------------------- Poisson rate >= 10
def test_rf_at_bagging_rate_12_grows_the_reference_forest():
    """A bagging rate of 12 draws each tree's bag through jax's rejection
    sampler: the port's ``train_rf`` grows the reference's forest (splits
    and masks equal, leaves within 1e-6, the same out-of-bag errors within
    1e-5 relative; C4).  The CLI cannot reach such a rate, since
    ``probe`` holds ``baggingSampleRate`` to (0, 1]."""
    import jax
    from shifu_tpu.train import dt_trainer as jdt
    from shifu_tpu_torch.train import dt_trainer as dt
    bins, y, cat, rng = _separated(n=3000, seed=4)
    w = np.ones(len(y), np.float32)
    kw = dict(n_trees=4, depth=5, impurity="entropy", feature_subset="ALL",
              tree_batch=2, seed=5, bagging_rate=12.0, min_gain=1e-3)
    with jax.enable_x64(False):
        want = jdt.train_rf(bins, y, w, 16, cat, jdt.DTSettings(**kw))
    got = dt.train_rf(bins, y, w, 16, cat, dt.DTSettings(**kw),
                      device="cpu")
    assert len(got.trees) == len(want.trees) == 4
    for a, b in zip(got.trees, want.trees):
        np.testing.assert_array_equal(a.split_feat, np.asarray(b.split_feat))
        np.testing.assert_array_equal(a.left_mask, np.asarray(b.left_mask))
        np.testing.assert_allclose(a.leaf_value, np.asarray(b.leaf_value),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.history, float),
                               np.asarray(want.history, float), rtol=1e-5)
