"""Port parity for the GBT training slice as a whole: ``TrainProcessor`` of
``shifu_tpu`` and of ``shifu_tpu_torch`` (``device="cpu"``) on two copies
of the prepared fraud model set, plus the files both packages read and
write: ``models/model0.gbt``, ``tmp/checkpoints/forest_ckpt.npz`` with its
``.scores.npz`` and ``.meta.json``, and the wire plane.

Tolerances: ``train.progress`` errors within 1e-5 relative, leaf values
within rtol 1e-5 (and 1e-6 absolute: an internal node's mean gradient is
a cancelling sum near 0), feature importance within 1e-4 of the largest.
With the fixture's default ``MinInfoGain 0`` most nodes below level 1
split on gains that are f32 rounding noise (~1e-7 against node scores of
~1e3, ROADMAP Queue 3, C4), which the two packages round differently; so
the full structural equality is pinned with ``MinInfoGain 1e-3``, above
the noise and far below every real gain (one split per tree there), and
on a synthetic model set the port's own savers write, whose target
follows three columns with well-separated gains (dozens of splits); the
default run pins levels 0-1, the errors and the importance.
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

BASE = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log", "LearningRate": 0.1}
SEPARATED = dict(BASE, MinInfoGain=1e-3)


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _copy(template, root, name, params):
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    d = str(root / name)
    shutil.copytree(template, d)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = dict(params)
    mc.save(os.path.join(d, "ModelConfig.json"))
    return d


def _train_ref(d, **params):
    from shifu_tpu.pipeline.train import TrainProcessor
    assert TrainProcessor(d, params=params).run() == 0


def _train_port(d, **params):
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    assert TrainProcessor(d, params=params, device="cpu").run() == 0


def _synthetic_set(root, name, n=3000, seed=0):
    """A model set written with the port's own savers: 6 numeric columns
    of 16 bins plus a categorical one of 11 categories, the wire plane of
    N rows, y from a logit on three columns, integer weights."""
    from shifu_tpu_torch.config import (ColumnConfig, ModelConfig,
                                        save_column_configs)
    from shifu_tpu_torch.config.column_config import ColumnFlag, ColumnType
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data.spill import WireWriter, wire_dir
    from shifu_tpu_torch.ioutil import atomic_write_json
    rng = np.random.default_rng(seed)
    d = str(root / name)
    os.makedirs(d)
    mc = ModelConfig()
    mc.basic.name = name
    mc.dataSet.dataPath = os.path.join(d, "unused.csv")
    mc.dataSet.targetColumnName = "tag"
    mc.dataSet.posTags, mc.dataSet.negTags = ["1"], ["0"]
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = dict(BASE, MinInstancesPerNode=10, MinInfoGain=0.5)
    mc.save(os.path.join(d, "ModelConfig.json"))
    ccs, nb = [], []
    for j in range(7):
        cc = ColumnConfig(columnNum=j, columnName=f"c{j}", finalSelect=True)
        if j < 6:
            cc.columnBinning.binBoundary = [float("-inf")] + list(
                np.arange(1.0, 16.0))
        else:
            cc.columnType = ColumnType.C
            cc.columnBinning.binCategory = [f"v{k}" for k in range(11)]
        cc.columnBinning.length = cc.num_bins() + 1
        cc.columnStats.mean, cc.columnStats.stdDev = 0.0, 1.0
        nb.append(cc.num_bins() + 1)
        ccs.append(cc)
    ccs.append(ColumnConfig(columnNum=7, columnName="tag",
                            columnType=ColumnType.C,
                            columnFlag=ColumnFlag.Target))
    save_column_configs(ccs, os.path.join(d, "ColumnConfig.json"))
    bins = (rng.integers(0, 1 << 16, size=(n, 7))
            % np.asarray(nb)).astype(np.uint8)
    effect = rng.normal(0, 1.5, size=nb[6])
    logit = 2.0 * (bins[:, 1] > 9) - 1.5 * (bins[:, 4] < 5) \
        + effect[bins[:, 6]] - 0.3
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    clean = os.path.join(d, "tmp", "CleanedData")
    keys = ("bins", "y", "w")
    sig = {"norm": f"synthetic-{seed}"}
    ww = WireWriter(wire_dir(clean, keys), keys,
                    {"bins": np.uint8, "y": np.float32, "w": np.float32},
                    {"bins": (7,)}, sig)
    for r0 in range(0, n, 1024):
        ww.append({"bins": bins[r0:r0 + 1024], "y": y[r0:r0 + 1024],
                   "w": w[r0:r0 + 1024]})
    ww.finish()
    names = [f"c{j}" for j in range(7)]
    atomic_write_json(os.path.join(clean, "schema.json"), {
        "outputNames": names, "columnNums": list(range(7)),
        "columnNames": names, "normType": "ZSCALE",
        "numShards": -(-n // 1024), "numRows": n,
        "shardRows": [min(1024, n - r0) for r0 in range(0, n, 1024)],
        "binsDtype": "uint8", "width": 7, "wire": True,
        "wireKeys": list(keys), "wireSignature": sig})
    return d


@pytest.fixture(scope="module")
def sets(tmp_path_factory, _prepared_template):
    """{(package, plane): model set dir}, trained once per module: the
    prepared fixture with the default params ("base") and with a gain
    floor ("sep"), and a synthetic plane of well-separated gains
    ("syn")."""
    root = tmp_path_factory.mktemp("torch_train")
    out = {}
    for pkg, train in (("ref", _train_ref), ("port", _train_port)):
        for pname, params in (("base", BASE), ("sep", SEPARATED)):
            d = _copy(_prepared_template, root, f"{pkg}_{pname}", params)
            train(d)
            out[pkg, pname] = d
        d = _synthetic_set(root, f"{pkg}_syn")
        train(d)
        out[pkg, "syn"] = d
    return out


def _forest(d, name="models/model0.gbt"):
    from shifu_tpu_torch.models.tree import load_model
    return load_model(os.path.join(d, name))


def _progress(d):
    text = open(os.path.join(d, "tmp", "train.progress")).read()
    return np.array([[float(a), float(b)] for a, b in re.findall(
        r"Train Error: (\S+) Validation Error: (\S+)", text)])


def _fi(d):
    with open(os.path.join(d, "tmp", "feature_importance.json")) as f:
        return json.load(f)


def _assert_same_forest(got, want, levels=None):
    (gs, gt), (ws, wt) = got, want
    assert gs.to_json() == ws.to_json()
    assert len(gt) == len(wt) == ws.n_trees
    nodes = (1 << levels) - 1 if levels else None
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a.split_feat[:nodes],
                                      b.split_feat[:nodes])
        if levels is None:
            np.testing.assert_array_equal(a.left_mask, b.left_mask)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=1e-6)


def _assert_same_errors_and_fi(d_got, d_want):
    p_got, p_want = _progress(d_got), _progress(d_want)
    assert p_got.shape == p_want.shape == (5, 2)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-5)
    fi_got, fi_want = _fi(d_got), _fi(d_want)
    assert set(fi_got) == set(fi_want)
    top = max(fi_want.values())
    for k, v in fi_want.items():
        assert abs(fi_got[k] - v) <= 1e-4 * top, k
    assert max(fi_got, key=fi_got.get) == max(fi_want, key=fi_want.get)


@pytest.mark.parametrize("plane,min_splits", [("sep", 5), ("syn", 25)])
def test_separated_gains_grow_the_reference_forest(sets, plane, min_splits):
    _assert_same_forest(_forest(sets["port", plane]),
                        _forest(sets["ref", plane]))
    _assert_same_errors_and_fi(sets["port", plane], sets["ref", plane])
    trees = _forest(sets["ref", plane])[1]
    assert sum(int((t.split_feat >= 0).sum()) for t in trees) >= min_splits


def test_default_params_agree_above_the_noise_splits(sets):
    """The base parameters: levels 0-1 split alike, and errors and
    importance agree; deeper noise splits may differ (C4)."""
    _assert_same_forest(_forest(sets["port", "base"]),
                        _forest(sets["ref", "base"]), levels=2)
    _assert_same_errors_and_fi(sets["port", "base"], sets["ref", "base"])


def test_train_writes_the_reference_files(sets):
    for pkg in ("ref", "port"):
        d = sets[pkg, "sep"]
        ck = os.path.join(d, "tmp", "checkpoints", "forest_ckpt.npz")
        for f in (ck, ck + ".scores.npz", ck + ".meta.json",
                  os.path.join(d, "tmp", "journal", "TRAIN.json"),
                  os.path.join(d, "tmp", "profile.json")):
            assert os.path.isfile(f), (pkg, f)
        with open(os.path.join(d, "tmp", "journal", "TRAIN.json")) as f:
            assert json.load(f)["status"] == "complete"
        with open(os.path.join(d, "tmp", "profile.json")) as f:
            assert "TRAIN" in json.load(f)
    metas = [json.load(open(os.path.join(
        sets[pkg, "sep"], "tmp", "checkpoints", "forest_ckpt.npz.meta.json")))
        for pkg in ("port", "ref")]
    assert metas[0]["trees_done"] == metas[1]["trees_done"] == 5
    assert metas[0]["seed"] == metas[1]["seed"]
    np.testing.assert_allclose(metas[0]["history"], metas[1]["history"],
                               rtol=1e-5)
    scores = [np.load(os.path.join(sets[pkg, "sep"], "tmp", "checkpoints",
                                   "forest_ckpt.npz.scores.npz"))
              for pkg in ("port", "ref")]
    assert int(scores[0]["trees_done"]) == int(scores[1]["trees_done"]) == 5
    np.testing.assert_allclose(scores[0]["f"], scores[1]["f"], rtol=1e-5,
                               atol=1e-6)


def test_each_package_loads_the_others_model_and_checkpoint(sets):
    from shifu_tpu.models.tree import load_model as j_load_model
    from shifu_tpu_torch.models.tree import load_model
    for d_from, loader in ((sets["port", "sep"], j_load_model),
                           (sets["ref", "sep"], load_model)):
        for name in ("models/model0.gbt",
                     "tmp/checkpoints/forest_ckpt.npz"):
            spec, trees = loader(os.path.join(d_from, name))
            own_spec, own = _forest(d_from, name)
            assert spec.to_json() == own_spec.to_json()
            for a, b in zip(trees, own):
                np.testing.assert_array_equal(a.split_feat, b.split_feat)
                np.testing.assert_array_equal(a.left_mask, b.left_mask)
                np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_port_resume_finishes_the_reference_forest(sets, tmp_path,
                                                   _prepared_template):
    """shifu_tpu writes a 3-tree checkpoint; the port's `train -resume`
    with TreeNum 5 grows the forest shifu_tpu grows uninterrupted."""
    from shifu_tpu_torch.cli import main
    d = _copy(_prepared_template, tmp_path, "resume",
              dict(SEPARATED, TreeNum=3, CheckpointInterval=3))
    _train_ref(d)
    _copy_params(d, SEPARATED)
    assert main(["--dir", d, "train", "-resume", "--device", "cpu"]) == 0
    _assert_same_forest(_forest(d), _forest(sets["ref", "sep"]))
    np.testing.assert_allclose(_progress(d)[-2:],
                               _progress(sets["ref", "sep"])[-2:],
                               rtol=1e-5)


def _copy_params(d, params):
    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.params = dict(params)
    mc.save(os.path.join(d, "ModelConfig.json"))


def test_port_resume_is_bit_identical(sets, tmp_path, _prepared_template):
    d = _copy(_prepared_template, tmp_path, "resume",
              dict(BASE, TreeNum=2, CheckpointInterval=2))
    _train_port(d)
    _copy_params(d, BASE)
    _train_port(d, resume=True)
    (gs, got), (ws, want) = _forest(d), _forest(sets["port", "base"])
    assert gs.to_json() == ws.to_json()
    for a, b in zip(got, want):
        assert a.split_feat.tobytes() == b.split_feat.tobytes()
        assert a.left_mask.tobytes() == b.left_mask.tobytes()
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()


@pytest.mark.parametrize("how", ["resume_without_scores", "continuous"])
def test_restored_trees_replay_to_the_uninterrupted_forest(
        sets, tmp_path, _prepared_template, monkeypatch, how):
    """Without a per-row score sidecar (lost, or continuous training from
    the saved model) the restored trees replay through the forest walk
    (B4's plain version on the CPU) in one batched call; the finished
    forest is bit-identical to the uninterrupted one."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.ops import tree_quant as tq
    d = _copy(_prepared_template, tmp_path, how,
              dict(BASE, TreeNum=2, CheckpointInterval=2))
    _train_port(d)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.params = dict(BASE)
    if how == "continuous":
        mc.train.isContinuous = True
        shutil.rmtree(os.path.join(d, "tmp", "checkpoints"))
    else:
        os.remove(os.path.join(d, "tmp", "checkpoints",
                               "forest_ckpt.npz.scores.npz"))
    mc.save(os.path.join(d, "ModelConfig.json"))
    walks = []
    real = tq.predict_forest_quant_ref
    monkeypatch.setattr(tq, "predict_forest_quant_ref",
                        lambda *a: walks.append(a[0].shape) or real(*a))
    _train_port(d, resume=how != "continuous")
    assert walks == [(2, 31)]               # 2 restored trees, one walk
    (gs, got), (ws, want) = _forest(d), _forest(sets["port", "base"])
    assert gs.to_json() == ws.to_json()
    for a, b in zip(got, want):
        assert a.split_feat.tobytes() == b.split_feat.tobytes()
        assert a.left_mask.tobytes() == b.left_mask.tobytes()
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        assert "train/replay" in json.load(f)["TRAIN"]["phases_s"]


def test_profile_splits_the_train_phase(sets):
    """`tmp/profile.json` splits the port's train phase into the upload,
    the chunks and the checkpoints, which fit inside it."""
    with open(os.path.join(sets["port", "sep"], "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    parts = ("train/upload", "train/grow", "train/checkpoint")
    assert all(phases[p] >= 0.0 for p in parts)
    assert "train/replay" not in phases
    assert sum(phases[p] for p in parts) <= phases["train"] + 0.003


def test_train_raises_without_cuda_unless_cpu_is_asked(monkeypatch,
                                                       prepared_set):
    from shifu_tpu_torch.cli import build_parser, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert build_parser().parse_args(["train"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dir", prepared_set, "train"])
    assert not os.path.isfile(os.path.join(prepared_set, "tmp", "journal",
                                           "TRAIN.json"))


@pytest.mark.parametrize("change,match", [
    ({"algorithm": "RF"}, "RF training"),
    ({"params": dict(BASE, TreeNum=[2, 3])}, "grid search"),
    ({"prop": "shifu.train.streaming=on"}, "streamed"),
    ({"baggingNum": 2}, "bagged GBT")])
def test_unported_paths_raise_naming_their_roadmap_item(prepared_set,
                                                        change, match):
    from shifu_tpu_torch.cli import main
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    mc = ModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    mc.train.algorithm = Algorithm[change.get("algorithm", "GBT")]
    mc.train.params = change.get("params", dict(BASE))
    mc.train.baggingNum = change.get("baggingNum", 1)
    mc.save(os.path.join(prepared_set, "ModelConfig.json"))
    argv = ["--dir", prepared_set, "train", "--device", "cpu"]
    if "prop" in change:
        argv.insert(0, "-D" + change["prop"])
    with pytest.raises(NotImplementedError, match=match) as ei:
        main(argv)
    assert "ROADMAP Queue 1" in str(ei.value)


def test_wire_writer_rewrites_the_reference_plane_byte_for_byte(
        _prepared_template, tmp_path):
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.spill import MANIFEST, WireWriter, wire_dir
    clean = os.path.join(_prepared_template, "tmp", "CleanedData")
    shards = Shards.open(clean)
    assert shards.is_wire and shards.num_rows == 4000
    keys = shards.schema["wireKeys"]
    src = wire_dir(clean, keys)
    with open(os.path.join(src, MANIFEST)) as f:
        man = json.load(f)
    dst = wire_dir(str(tmp_path), keys)
    w = WireWriter(dst, keys, {k: np.dtype(man["dtypes"][k]) for k in keys},
                   {k: tuple(man["shapes"][k]) for k in keys},
                   shards.schema["wireSignature"])
    for part in shards.iter_shards():
        w.append(part)
    w.finish()
    for k in keys:
        with open(os.path.join(src, k + ".raw"), "rb") as a, \
                open(os.path.join(dst, k + ".raw"), "rb") as b:
            assert a.read() == b.read(), k
    with open(os.path.join(dst, MANIFEST)) as f:
        assert json.load(f) == man
    data = shards.load_all()
    assert data["bins"].dtype == np.dtype(shards.schema["binsDtype"])
    assert data["bins"].shape == (4000, len(shards.schema["columnNums"]))


@pytest.mark.parametrize("case,code", [("no_plane", "STEP_PRECONDITION"),
                                       ("torn_norm", "TORN_ARTIFACT")])
def test_train_preconditions_match_the_reference(prepared_set, case, code):
    """`train` without the norm step's plane, or after a norm run that
    never committed, fails in setup with the reference's coded error."""
    from shifu_tpu.config.errors import ShifuError as JShifuError
    from shifu_tpu.pipeline.train import TrainProcessor as JTrain
    from shifu_tpu_torch.config.errors import ShifuError
    from shifu_tpu_torch.pipeline.journal import StepJournal
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    tmp = os.path.join(prepared_set, "tmp")
    if case == "no_plane":
        for sub in ("CleanedData", "NormalizedData"):
            os.remove(os.path.join(tmp, sub, "schema.json"))
    else:
        StepJournal(os.path.join(tmp, "journal", "NORMALIZE.json"),
                    "NORMALIZE", prepared_set).open_run()
    with pytest.raises(JShifuError) as want:
        JTrain(prepared_set, params={}).run()
    with pytest.raises(ShifuError) as got:
        TrainProcessor(prepared_set, params={}, device="cpu").run()
    assert got.value.error_code.name == want.value.error_code.name \
        == f"ERROR_{code}"
    assert got.value.error_code.code == want.value.error_code.code


def test_early_stop_decider_matches_reference():
    from shifu_tpu.train.early_stop import GBTEarlyStopDecider as JDecider
    from shifu_tpu_torch.train.early_stop import GBTEarlyStopDecider
    rng = np.random.default_rng(4)
    for _ in range(20):
        errs = np.cumsum(rng.normal(0.0, 0.01, size=60)) + 1.0
        want, got = JDecider(), GBTEarlyStopDecider()
        assert [got.add(float(e)) for e in errs] == \
            [want.add(float(e)) for e in errs]


def test_early_stop_inside_a_chunk_keeps_the_per_tree_forest():
    """Random labels overfit, so validation error rises and the stop
    fires mid-chunk; checking every 8 trees keeps exactly the forest and
    history of checking after every tree."""
    from shifu_tpu_torch.train import dt_trainer as dt
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 16, size=(2000, 6)).astype(np.uint8)
    y = (rng.random(2000) < 0.5).astype(np.float32)
    w = np.ones(2000, np.float32)
    runs = [dt.train_gbt(bins, y, w, 16, None, dt.DTSettings(
        n_trees=40, depth=6, loss="log", learning_rate=0.5, early_stop=True,
        early_stop_check=check, valid_rate=0.3), device="cpu")
        for check in (1, 8)]
    (a, b) = runs
    assert len(a.trees) == len(b.trees) < 40 and len(a.trees) % 8 != 0
    assert a.history == b.history
    np.testing.assert_array_equal(a.feature_importance, b.feature_importance)
    for x, z in zip(a.trees, b.trees):
        assert x.split_feat.tobytes() == z.split_feat.tobytes()
        assert x.leaf_value.tobytes() == z.leaf_value.tobytes()
