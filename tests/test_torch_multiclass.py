"""Port parity for multi-class trees and multi-class eval: the native
multi-class split scan and growth (``ops.tree`` with per-class stat
channels) against ``shifu_tpu.ops.tree``, the node-index walk of
class-distribution leaves, and ``TrainProcessor`` / ``EvalProcessor`` of
both packages (the port on ``device="cpu"``) on copies of one three-class
model set: a native RF, a one-vs-all GBT, a one-vs-all GBT with two bags
each, their model files read across packages, and ``-resume`` of a
one-vs-all run.

Tolerances: split features and left masks equal (the set's classes are
separated by three columns, and a gain floor keeps noise splits out, C9;
the bagged one-vs-all case grows depth-2 trees, since at depth 3 one of
its nodes has two thresholds whose gains tie within f32 rounding, which
the reference's 8-device test mesh sums in another order and the port on
one device does not, C4: at depth 3 the port equals the reference run
on one device, ``test_bagged_ova_at_depth_3_matches_one_device``); leaves
and ``train.progress`` errors within rtol 1e-5 (C4: f32 sums in another
order); eval accuracy and confusion matrix equal, class scores within
1e-5, per-class AUC within 0.005 (the repo's AUC tolerance).
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

TAGS = ["alpha", "beta", "gamma"]
RF = {"TreeNum": 4, "MaxDepth": 4, "Impurity": "entropy",
      "MinInfoGain": 1e-3, "TreeBatch": 2}
GBT = {"TreeNum": 4, "MaxDepth": 3, "Loss": "log", "LearningRate": 0.2,
       "MinInfoGain": 1e-3}


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _three_class_set(root) -> str:
    """A three-class model set over a 1,500-row CSV (three informative
    numeric columns, a noisy categorical hint, an id column kept out as
    meta), scaffolded with ``shifu_tpu``'s ``new`` and prepared with its
    ``init``, ``stats`` (EqualTotal, as multi-class targets need) and
    ``norm``."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import BinningMethod
    from shifu_tpu.pipeline.create import InitProcessor, create_new_model
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.stats import StatsProcessor
    rng = np.random.default_rng(5)
    n = 1500
    y = rng.integers(0, 3, n)
    f = [rng.normal(size=n) + (y == k) * 2.2 for k in range(3)]
    kind = np.asarray(["low", "mid", "high"])[y]
    flip = rng.random(n) < 0.1
    kind[flip] = rng.choice(["low", "mid", "high"], flip.sum())
    tag = np.asarray(TAGS)[y]
    lines = ["id|f1|f2|f3|kind|tag"] + [
        f"r{i}|{f[0][i]:.5f}|{f[1][i]:.5f}|{f[2][i]:.5f}|{kind[i]}|{tag[i]}"
        for i in range(n)]
    csv = os.path.join(str(root), "mc.csv")
    with open(csv, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    meta = os.path.join(str(root), "meta.names")
    with open(meta, "w") as fh:
        fh.write("id\n")
    d = create_new_model("mctest", base_dir=str(root))
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.metaColumnNameFile = list(TAGS), [], meta
    mc.stats.binningMethod = BinningMethod.EqualTotal
    mc.train.baggingNum = 1
    mc.evals[0].dataSet.dataPath = csv
    mc.evals[0].dataSet.dataDelimiter = "|"
    mc.save(path)
    assert InitProcessor(d).run() == 0
    assert StatsProcessor(d, params={}).run() == 0
    assert NormalizeProcessor(d, params={}).run() == 0
    return d


def _configure(d, algorithm, params, bags=1, method="NATIVE"):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     MultipleClassification)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm[algorithm]
    mc.train.params = dict(params)
    mc.train.baggingNum = bags
    mc.train.multiClassifyMethod = MultipleClassification[method]
    mc.save(path)


def _train(pkg, d, **params):
    if pkg == "ref":
        from shifu_tpu.pipeline.train import TrainProcessor as JTrain
        assert JTrain(d, params=params).run() == 0
    else:
        from shifu_tpu_torch.pipeline.train import TrainProcessor
        assert TrainProcessor(d, params=params, device="cpu").run() == 0


def _eval(pkg, d, **params):
    params = params or {"run_eval": "Eval1"}
    if pkg == "ref":
        from shifu_tpu.pipeline.evaluate import EvalProcessor as JEval
        assert JEval(d, params=params).run() == 0
    else:
        from shifu_tpu_torch.pipeline.evaluate import EvalProcessor
        assert EvalProcessor(d, params=params, device="cpu").run() == 0


CASES = {"native": ("RF", RF, 1, "NATIVE"),
         "ova": ("GBT", GBT, 1, "NATIVE"),       # GBT routes to OVA
         "ova_bagged": ("GBT", dict(GBT, TreeNum=3, MaxDepth=2), 2,
                        "ONEVSALL")}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """{(package, case): model set dir}, trained and evaluated once per
    module from one prepared three-class set."""
    root = tmp_path_factory.mktemp("torch_multiclass")
    template = _three_class_set(root)
    out = {"template": template}
    for case, (alg, params, bags, method) in CASES.items():
        for pkg in ("ref", "port"):
            d = str(root / f"{pkg}_{case}")
            shutil.copytree(template, d)
            _configure(d, alg, params, bags, method)
            _train(pkg, d)
            _eval(pkg, d)
            out[pkg, case] = d
    return out


def _models(d):
    from shifu_tpu_torch.models.tree import load_model
    mdir = os.path.join(d, "models")
    return {f: load_model(os.path.join(mdir, f))
            for f in sorted(os.listdir(mdir)) if f.startswith("model")}


def _progress(d):
    text = open(os.path.join(d, "tmp", "train.progress")).read()
    return np.array([[float(a), float(b)] for a, b in re.findall(
        r"Train Error: (\S+) Validation Error: (\S+)", text)])


def _perf(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalPerformance.json")) as f:
        return json.load(f)


def _scores(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalScore")) as f:
        rows = [line.rstrip("\n").split("|") for line in f]
    return rows[0], np.asarray(rows[1:], dtype=object)


@pytest.mark.parametrize("case,files", [
    ("native", ["model0.rf"]),
    ("ova", ["model0.gbt", "model1.gbt", "model2.gbt"]),
    ("ova_bagged", [f"model{i}.gbt" for i in range(6)])])
def test_multiclass_forests_match_the_reference(sets, case, files):
    got, want = _models(sets["port", case]), _models(sets["ref", case])
    assert sorted(got) == sorted(want) == files
    for name in files:
        (gs, gt), (ws, wt) = got[name], want[name]
        assert gs.extra == ws.extra and gs.extra["n_classes"] == 3
        assert gs.algorithm == ws.algorithm and len(gt) == len(wt)
        assert gs.init_score == pytest.approx(ws.init_score, rel=1e-6)
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a.split_feat, b.split_feat)
            np.testing.assert_array_equal(a.left_mask, b.left_mask)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=1e-6)
    p_got, p_want = _progress(sets["port", case]), \
        _progress(sets["ref", case])
    assert p_got.shape == p_want.shape and len(p_got) >= 4
    np.testing.assert_allclose(p_got, p_want, rtol=1e-5, atol=1e-7)


def test_bagged_ova_at_depth_3_matches_one_device(sets, tmp_path):
    """The bagged one-vs-all case at depth 3, where the test mesh's
    shard-by-shard sums flip one tied threshold: the reference trained in
    a process of its own on one CPU device (``xla_force_host_platform_
    device_count=1``) grows the port's forests, split for split.  The
    leaves are held within rtol 1e-5; the values that inner nodes carry
    are not compared here: at the near-tie node the f32 sums of the two
    packages still differ by more than 1e-5 of its value (C4)."""
    alg, params, bags, method = CASES["ova_bagged"]
    dirs = {}
    for pkg in ("ref", "port"):
        dirs[pkg] = d = str(tmp_path / pkg)
        shutil.copytree(sets["template"], d)
        _configure(d, alg, dict(params, MaxDepth=3), bags, method)
    _train("port", dirs["port"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    code = ("import sys, jax; assert len(jax.devices()) == 1; "
            "from shifu_tpu.pipeline.train import TrainProcessor; "
            "sys.exit(TrainProcessor(sys.argv[1], params={}).run())")
    subprocess.run([sys.executable, "-c", code, dirs["ref"]], env=env,
                   check=True, timeout=300)
    got, want = _models(dirs["port"]), _models(dirs["ref"])
    assert sorted(got) == sorted(want) == [f"model{i}.gbt" for i in range(6)]
    for name in got:
        (gs, gt), (ws, wt) = got[name], want[name]
        assert gs.extra == ws.extra and len(gt) == len(wt) == 3
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a.split_feat, b.split_feat)
            np.testing.assert_array_equal(a.left_mask, b.left_mask)
            leaf = a.split_feat < 0
            np.testing.assert_allclose(a.leaf_value[leaf],
                                       b.leaf_value[leaf], rtol=1e-5,
                                       atol=1e-6)
    assert all((t.split_feat[3:7] >= 0).any()      # depth 3 is grown
               for _, trees in got.values() for t in trees)
    np.testing.assert_allclose(_progress(dirs["port"]),
                               _progress(dirs["ref"]), rtol=1e-5, atol=1e-7)


def test_native_forest_has_class_distribution_leaves(sets):
    (spec, trees), = _models(sets["port", "native"]).values()
    assert "class_index" not in spec.extra
    for t in trees:
        assert t.leaf_value.shape == (31, 3)
        leaf = t.split_feat < 0
        sums = t.leaf_value[leaf].sum(axis=1)
        np.testing.assert_allclose(sums[sums > 0], 1.0, rtol=1e-5)
    ova = _models(sets["port", "ova_bagged"])
    by_class = {}
    for name, (spec, _) in ova.items():
        by_class.setdefault(spec.extra["class_index"], []).append(name)
    assert {k: len(v) for k, v in by_class.items()} == {0: 2, 1: 2, 2: 2}


@pytest.mark.parametrize("case", list(CASES))
def test_multiclass_eval_matches_the_reference(sets, case):
    got, want = _perf(sets["port", case]), _perf(sets["ref", case])
    assert got["nClasses"] == want["nClasses"] == 3
    assert got["tags"] == want["tags"] == TAGS
    assert got["accuracy"] == want["accuracy"] > 0.8
    assert got["confusionMatrix"] == want["confusionMatrix"]
    assert got["classCounts"] == want["classCounts"]
    np.testing.assert_allclose(got["perClassAuc"], want["perClassAuc"],
                               atol=0.005)
    assert abs(got["macroAuc"] - want["macroAuc"]) <= 0.005
    (h_got, s_got), (h_want, s_want) = _scores(sets["port", case]), \
        _scores(sets["ref", case])
    assert h_got == h_want == ["tag", "weight", "predictedTag"] + [
        f"score_{t}" for t in TAGS]
    assert np.array_equal(s_got[:, :3], s_want[:, :3])
    np.testing.assert_allclose(s_got[:, 3:].astype(float),
                               s_want[:, 3:].astype(float), atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_scores_the_others_multiclass_models(sets, case):
    """The port's scorer on the reference's model files and the
    reference's on the port's give the class scores of the package that
    wrote them, within 1e-5."""
    from shifu_tpu.eval.scorer import Scorer as JScorer
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.eval.scorer import Scorer
    bins = Shards.open(os.path.join(sets["template"], "tmp",
                                    "CleanedData")).load_all()["bins"]
    for d in (sets["port", case], sets["ref", case]):
        mdir = os.path.join(d, "models")
        port = Scorer.from_dir(mdir, device="cpu")
        ref = JScorer.from_dir(mdir)
        assert port.n_classes() == ref.n_classes() == 3
        got = port.score_classes(None, bins)
        want = ref.score_classes(np.zeros((len(bins), 1), np.float32),
                                 bins.astype(np.int32))
        assert got.shape == (len(bins), 3)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_eval_score_sorts_by_the_top_class_unless_nosort(sets, tmp_path):
    d = str(tmp_path / "score")
    shutil.copytree(sets["port", "ova"], d)
    _eval("port", d, score="Eval1", nosort=True)
    _, unsorted = _scores(d)
    _eval("port", d, score="Eval1")
    _, ranked = _scores(d)
    top = ranked[:, 3:].astype(float).max(axis=1)
    assert np.all(np.diff(top) <= 0)
    assert sorted(map(tuple, ranked)) == sorted(map(tuple, unsorted))


def test_ova_resume_restarts_at_the_first_unfinished_class(sets, tmp_path):
    """A one-vs-all run that lost class 2's model resumes at class 2:
    classes 0 and 1 stay untouched, class 2 equals the uninterrupted
    run's bit for bit."""
    d = str(tmp_path / "resume")
    shutil.copytree(sets["port", "ova"], d)
    mdir = os.path.join(d, "models")
    os.remove(os.path.join(mdir, "model2.gbt"))
    kept = {f: os.path.getmtime(os.path.join(mdir, f))
            for f in ("model0.gbt", "model1.gbt")}
    _train("port", d, resume=True)
    for f, mtime in kept.items():
        assert os.path.getmtime(os.path.join(mdir, f)) == mtime
    (gs, got), = [_models(d)["model2.gbt"]]
    ws, want = _models(sets["port", "ova"])["model2.gbt"]
    assert gs.to_json() == ws.to_json()
    for a, b in zip(got, want):
        assert a.split_feat.tobytes() == b.split_feat.tobytes()
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
    assert "Class 2 Tree #1" in open(os.path.join(
        d, "tmp", "train.progress")).read()


def test_ova_resume_restores_the_interrupted_class_checkpoint(sets,
                                                              tmp_path):
    """Class 1 interrupted after 2 of 4 trees (its ``forest_ckpt_c1``
    checkpoint kept, its model gone): ``-resume`` continues it from the
    checkpoint to the uninterrupted forest, bit for bit."""
    from shifu_tpu_torch.models.tree import load_model
    d = str(tmp_path / "ckpt")
    shutil.copytree(sets["template"], d)
    _configure(d, "GBT", dict(GBT, TreeNum=2, CheckpointInterval=2))
    _train("port", d)
    ck = os.path.join(d, "tmp", "checkpoints", "forest_ckpt_c1.npz")
    assert load_model(ck)[0].n_trees == 2
    _configure(d, "GBT", dict(GBT, CheckpointInterval=2))
    for k in (1, 2):
        os.remove(os.path.join(d, "models", f"model{k}.gbt"))
    _train("port", d, resume=True)
    for k in (1, 2):
        (gs, got) = _models(d)[f"model{k}.gbt"]
        (ws, want) = _models(sets["port", "ova"])[f"model{k}.gbt"]
        assert gs.to_json() == ws.to_json()
        for a, b in zip(got, want):
            assert a.split_feat.tobytes() == b.split_feat.tobytes()
            assert a.leaf_value.tobytes() == b.leaf_value.tobytes()


@pytest.mark.parametrize("change,match", [
    ({"bags": 2}, "bagging with NATIVE"),
    ({"params": dict(RF, MaxDepth=[3, 4])}, "grid search"),
    ({"kfold": 3}, "k-fold")])
def test_multiclass_members_raise_as_the_reference(sets, tmp_path, change,
                                                   match):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.validator import ValidationError
    d = str(tmp_path / "bad")
    shutil.copytree(sets["template"], d)
    _configure(d, "RF", change.get("params", RF), change.get("bags", 1))
    if "kfold" in change:
        mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
        mc.train.isCrossValidation, mc.train.numKFold = True, 3
        mc.save(os.path.join(d, "ModelConfig.json"))
    with pytest.raises(ValidationError, match=match):
        _train("port", d)


# ------------------------------------------------------------- ops level
def _class_hist(seed, nodes=4, c=5, b=9, k=3):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 6, size=(nodes, c, b, k)).astype(np.float32)
    h[rng.random((nodes, c, b)) < 0.2] = 0.0
    return h


@pytest.mark.parametrize("impurity,has_cat", [("entropy", True),
                                              ("gini", True),
                                              ("entropy", False)])
def test_multiclass_best_splits_match_the_reference(impurity, has_cat):
    import jax.numpy as jnp
    from shifu_tpu.ops.tree import best_splits as j_best_splits
    from shifu_tpu_torch.ops.tree import best_splits
    h = _class_hist(3)
    cat = np.array([False, True, False, True, False])
    fa = np.array([True, True, False, True, True])
    got = best_splits(torch.from_numpy(h), torch.from_numpy(cat),
                      torch.from_numpy(fa), impurity, 2.0, 0.0, has_cat, 3)
    want = j_best_splits(jnp.asarray(h), jnp.asarray(cat), jnp.asarray(fa),
                         impurity, 2.0, 0.0, 3, has_cat)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].shape == (4, 3)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6)


def test_leaf_values_from_raw_match_the_reference():
    import jax.numpy as jnp
    from shifu_tpu.ops.tree import leaf_values_from_raw as j_leaf
    from shifu_tpu_torch.ops.tree import leaf_values_from_raw
    sums = np.random.default_rng(1).integers(0, 9, (3, 8)).astype(np.float32)
    sums[:, 2] = 0.0                                     # an empty node
    for k in (0, 3):
        got = leaf_values_from_raw(torch.from_numpy(sums[:2] if not k
                                                    else sums), k)
        want = j_leaf(jnp.asarray(sums[:2] if not k else sums), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multiclass_forest_batch_equals_sequential_trees():
    """``grow_forest`` over per-class channels: each tree equal to its
    ``grow_tree`` bit for bit (the batched B2 path's contract)."""
    from shifu_tpu_torch.ops.tree import grow_forest, grow_tree
    rng = np.random.default_rng(2)
    n, c, b = 800, 4, 6
    y = rng.integers(0, 3, n)
    bins = torch.from_numpy(rng.integers(0, b, size=(n, c)).astype(np.uint8))
    bins[:, 0] = torch.from_numpy((y * 2).astype(np.uint8))
    stats = torch.from_numpy(np.stack([
        rng.poisson(1.0, n)[:, None] * np.eye(3)[y] for _ in range(3)
    ]).astype(np.float32))
    cat = torch.tensor([False, False, True, False])
    fa = torch.from_numpy(rng.random((3, c)) < 0.8)
    fa[:, 0] = True
    batch = grow_forest(bins, stats, cat, fa, b, 3, "gini", 1.0, 0.0,
                        n_classes=3)
    for t in range(3):
        one = grow_tree(bins, stats[t], cat, fa[t], b, 3, "gini", 1.0, 0.0,
                        n_classes=3)
        for x, z in zip(batch[t], one):
            assert torch.equal(x, z)
    assert batch[0][2].shape == (15, 3)


def test_predict_forest_matches_the_reference():
    """The mean vote of a forest mixing two depths, binary and
    class-distribution leaves, against ``shifu_tpu.ops.tree``."""
    from shifu_tpu.ops.tree import predict_forest as j_predict_forest
    from shifu_tpu_torch.ops.tree import TreeArrays, predict_forest
    rng = np.random.default_rng(4)
    n_bins, c = 8, 5
    bins = rng.integers(0, n_bins, size=(60, c)).astype(np.uint8)
    for shape in ((), (3,)):
        trees = []
        for depth in (2, 3, 3):
            k = (1 << (depth + 1)) - 1
            sf = rng.integers(0, c, size=k).astype(np.int32)
            sf[(1 << depth) - 1:] = -1
            trees.append(TreeArrays(
                split_feat=sf, left_mask=rng.random((k, n_bins)) < 0.5,
                leaf_value=rng.random((k,) + shape).astype(np.float32),
                depth=depth))
        for weights in (None, [0.5, 0.25, 0.25]):
            got = predict_forest(trees, torch.from_numpy(bins),
                                 weights).numpy()
            want = j_predict_forest(trees, bins, weights)
            assert got.shape == want.shape == (60,) + shape
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
