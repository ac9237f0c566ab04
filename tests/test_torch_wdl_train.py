"""The WDL trainer (``shifu_tpu_torch.train.wdl_trainer``) and the WDL set
end to end against ``shifu_tpu`` on the CPU: resident and streamed
training, resume, the bf16 rung, ``train`` → ``eval -run`` → ``export``
→ ``serve`` through the CLI, the grid search and ``combo``.

The reference's WDL modules are reached through
``test_torch_wdl.reference_wdl`` (the scoped C1 shim, under
``jax.enable_x64(False)``), with ``shard=False`` where a trainer takes it.
The model set is ``prepared_set``'s plane without its ``txn_id`` column
(a unique id that leaks the target), re-normalized once by the
reference, as ``tests/test_torch_nn_pipeline.py`` does.

Tolerances: per-epoch train and validation errors rtol 1e-4 (+2e-6 on the
``%.6f`` progress lines); the bf16 and mixed rungs rtol 5e-3 (one bf16
rounding a step, in another order); AUC ±0.005; served scores within 1e-3
of ``eval``'s on the 0-1000 scale; the exported spec within rtol 1e-5 of
the native model; resume bit-identical.
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
from shifu_tpu_torch.models import wdl as P
from shifu_tpu_torch.train import wdl_trainer as PT
from shifu_tpu_torch.train.nn_trainer import TrainSettings

from test_torch_wdl import _one_torch_thread, reference_wdl  # noqa: F401

pytestmark = pytest.mark.torch_port

AUC_TOL = 0.005
CARDS = [5, 9, 40]


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _planes(n=600, seed=0):
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(n, 4)).astype(np.float32)
    xc = np.stack([rng.integers(0, c, n) for c in CARDS],
                  axis=1).astype(np.int32)
    logit = xn[:, 0] - 0.5 * xn[:, 1] + (xc[:, 0] == 2) * 1.5 \
        - (xc[:, 2] % 3 == 0)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return xn, xc, y, w


def _settings(cls, **kw):
    base = dict(optimizer="ADAM", learning_rate=0.01, l2=1e-3, epochs=6,
                batch_size=0, seed=3)
    base.update(kw)
    return cls(**base)


# ------------------------------------------------------------- trainers
@pytest.mark.parametrize("batch,precision", [
    (0, "f32"), (64, "f32"), (0, "bf16"), (64, "mixed")])
def test_resident_training_matches_the_reference(batch, precision):
    """2 bags; full batch or minibatches of 64 (a multiple of the
    reference mesh's data axis)."""
    from shifu_tpu.train.nn_trainer import TrainSettings as RS
    xn, xc, y, w = _planes()
    with reference_wdl() as R:
        rs = R.wdl.WDLModelSpec(numeric_dim=4, cat_cardinalities=CARDS,
                                embed_dim=3, hidden_nodes=[8, 4])
        ref = R.trainer.train_wdl_ensemble(
            xn, xc, y, w, rs, _settings(RS, batch_size=batch,
                                        precision=precision),
            bags=2, shard=False)
        ref_params = [jax.tree_util.tree_map(np.asarray, p)
                      for p in ref.params]
    ps = P.WDLModelSpec.from_json(rs.to_json())
    got = PT.train_wdl_ensemble(
        xn, xc, y, w, ps, _settings(TrainSettings, batch_size=batch,
                                    precision=precision),
        bags=2, device="cpu")
    rtol = 1e-4 if precision == "f32" else 5e-3
    np.testing.assert_allclose(np.array(got.history),
                               np.array(ref.history), rtol=rtol)
    np.testing.assert_allclose(got.valid_errors, ref.valid_errors, rtol=rtol)
    assert got.epochs_run == ref.epochs_run == 6
    for g, r in zip(got.params, ref_params):
        cols = P.columns_of(ps, g)
        assert cols["embed"][0].dtype == np.float32
        for a, b in zip(cols["embed"], r["embed"]):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=0, atol=50 * rtol)


def test_resume_is_bit_identical(tmp_path):
    """3 minibatch epochs, then ``resume`` to 6, equal an uninterrupted 6
    bit for bit: params, best errors and history."""
    xn, xc, y, w = _planes()
    ps = P.WDLModelSpec(numeric_dim=4, cat_cardinalities=CARDS, embed_dim=3,
                        hidden_nodes=[8, 4])

    def run(epochs, resume, ckpt):
        s = _settings(TrainSettings, batch_size=64, epochs=epochs,
                      checkpoint_dir=str(ckpt), checkpoint_every=1,
                      resume=resume)
        return PT.train_wdl_ensemble(xn, xc, y, w, ps, s, bags=2,
                                     device="cpu")

    whole = run(6, False, tmp_path / "a")
    run(3, False, tmp_path / "b")
    resumed = run(6, True, tmp_path / "b")
    assert resumed.history == whole.history[3:]
    np.testing.assert_array_equal(resumed.valid_errors, whole.valid_errors)
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    for a, b in zip(resumed.params, whole.params):
        for x, z in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, z)


def test_sharded_tables_and_elastic_raise_naming_item_12(tmp_path):
    """Row-sharded tables are ported: on one rank ``shard=True`` trains
    the replicated run's params and errors bit for bit, in RAM and
    streamed.  The elastic combine: a single controller's streamed WDL (a
    quorum of itself, f32 transport) trains the plain streamed run's
    params bit for bit, with replicated and with sharded tables, one close
    record an epoch and one for the closing sweep."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import mask_fn_from_settings
    from shifu_tpu_torch.ioutil import atomic_savez, atomic_write_json
    from shifu_tpu_torch.parallel import elastic as el
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    xn, xc, y, w = _planes(64)
    ps = P.WDLModelSpec(numeric_dim=4, cat_cardinalities=CARDS)
    rep, sh = (PT.train_wdl_ensemble(xn, xc, y, w, ps,
                                     _settings(TrainSettings), shard=shard,
                                     device="cpu") for shard in (False, True))
    for a, b in zip(tree_leaves(rep.params), tree_leaves(sh.params)):
        assert torch.equal(a, b)
    assert rep.history == sh.history
    for name, arrays in (("norm", {"x": xn, "y": y, "w": w}),
                         ("clean", {"bins": xc})):
        d = str(tmp_path / name)
        os.makedirs(d)
        atomic_savez(os.path.join(d, "part-00000.npz"), **arrays)
        atomic_write_json(os.path.join(d, "schema.json"), {
            "outputNames": [f"c{i}" for i in range(4)],
            "columnNums": list(range(4)), "numRows": 64})
    settings = _settings(TrainSettings, epochs=3)
    mask_fn = mask_fn_from_settings(1, valid_rate=0.25, seed=3)

    def run(elastic, shard=None):
        planes = PT.ZippedPlanes(Shards.open(str(tmp_path / "norm")),
                                 Shards.open(str(tmp_path / "clean")), 32)
        return PT.train_wdl_streamed(planes, ps, settings, 1, mask_fn,
                                     [0, 1, 2, 3], [0, 1, 2],
                                     elastic=elastic, shard=shard,
                                     device="cpu")
    plain = run(None)
    for shard in (None, True):
        ctx = el.ElasticContext(str(tmp_path / f"job{shard}"), "ctrl-0",
                                cfg=el.ElasticConfig(quorum_frac=1.0,
                                                     step_timeout_ms=60000),
                                heartbeat=False).start()
        elas = run(ctx, shard)
        for a, b in zip(tree_leaves(plain.params),
                        tree_leaves(elas.params)):
            assert torch.equal(a, b)
        assert plain.history == elas.history
        assert ctx.board.last_closed_step() == settings.epochs


# ------------------------------------------------------------ model sets
@pytest.fixture(scope="module")
def wdl_template(tmp_path_factory, _prepared_template):
    """The prepared set with every candidate but ``txn_id`` final-selected,
    its planes rewritten by the reference."""
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    d = str(tmp_path_factory.mktemp("wdl_pipeline") / "wdlset")
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


def _copies(template, tmp_path, params, epochs=4, bags=2):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    out = []
    for who in ("ref", "port"):
        d = str(tmp_path / who)
        shutil.copytree(template, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.WDL
        mc.train.params = {"NumHiddenNodes": [8, 4], "EmbedColumnNum": 3,
                           "LearningRate": 0.01, **params}
        mc.train.numTrainEpochs = epochs
        mc.train.baggingNum = bags
        mc.save(path)
        out.append(d)
    return out


def _ref(d, *steps, props=None):
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    for k, v in (props or {}).items():
        j_environment.set_property(k, v)
    with reference_wdl():
        for step in steps:
            if step == "train":
                assert TrainProcessor(d, params={}).run() == 0
            else:
                assert EvalProcessor(d, params={"run_eval": ""}).run() == 0


def _port(d, *argv, props=None):
    """The port's CLI; the steps that compute take ``--device cpu``."""
    from shifu_tpu_torch.cli import main
    defs = [f"-D{k}={v}" for k, v in (props or {}).items()]
    dev = [] if argv[0] == "export" else ["--device", "cpu"]
    return main([*defs, "--dir", d, *argv, *dev])


def _progress(d):
    with open(os.path.join(d, "tmp", "train.progress")) as f:
        rows = [l.split() for l in f if "Epoch" in l]
    return np.array([[float(r[-4]), float(r[-1])] for r in rows])


def _auc(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalPerformance.json")) as f:
        return json.load(f)["areaUnderRoc"]


def test_cli_train_eval_export_serve_match_the_reference(wdl_template,
                                                         tmp_path):
    """Minibatch WDL, 2 bags: progress, AUC, the model files, the spec
    export re-read, and the served scores."""
    ref, port = _copies(wdl_template, tmp_path, {"MiniBatchs": 256})
    _ref(ref, "train", "eval")
    assert _port(port, "train") == 0
    assert _port(port, "eval", "-run") == 0
    np.testing.assert_allclose(_progress(port), _progress(ref), rtol=1e-4,
                               atol=2e-6)
    assert len(_progress(port)) == 4
    assert abs(_auc(port) - _auc(ref)) <= AUC_TOL
    assert _auc(port) > 0.7
    models = sorted(os.listdir(os.path.join(port, "models")))
    assert models == sorted(os.listdir(os.path.join(ref, "models"))) == \
        ["model0.wdl", "model1.wdl"]
    # each package loads the other's files
    from shifu_tpu_torch.models import load_any
    m = load_any(os.path.join(ref, "models", "model0.wdl"))
    assert m.spec.extra["cat_col_idx"] and m.spec.extra["num_feat_idx"]
    with reference_wdl():
        from shifu_tpu.models import load_any as j_load
        jm = j_load(os.path.join(port, "models", "model0.wdl"))
        assert jm.spec.to_json() == m.spec.to_json()
    # export -t spec re-reads to the native model's scores
    from shifu_tpu_torch.models.reference_import import load_reference_wdl
    assert _port(port, "export", "-t", "spec") == 0
    spec2, params2, _ = load_reference_wdl(
        os.path.join(port, "export", "reference", "model0.wdl"))
    native = load_any(os.path.join(port, "models", "model0.wdl"))
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(64, native.spec.numeric_dim)).astype(np.float32)
    xc = rng.integers(0, 5, size=(64, len(native.spec.cat_cardinalities)))
    np.testing.assert_allclose(
        P.IndependentWDLModel(spec2, params2).compute(xn, xc, device="cpu"),
        native.compute(xn, xc, device="cpu"), rtol=1e-5, atol=1e-7)
    # PMML has no WDL mapping, in either package
    assert _port(port, "export", "-t", "pmml") == 1
    # the served scores equal eval's
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.serve.scorer import AOTScorer
    models = [load_any(os.path.join(port, "models", f))
              for f in ("model0.wdl", "model1.wdl")]
    aot = AOTScorer(models, device="cpu", buckets=(8, 64))
    x = rng.normal(size=(100, aot.n_features)).astype(np.float32)
    bins = rng.integers(0, 6, size=(100, aot.n_bins_cols)).astype(np.int32)
    want = Scorer(models, device="cpu").score(x, bins).scores
    np.testing.assert_allclose(aot.score_batch(x, bins), want, rtol=0,
                               atol=1e-3)
    # the serving copies: ``sharded`` (one device: a shard of one) scores
    # the replicated copy bit for bit; ``hot`` with 2 head rows scores
    # every row whose ids are all head ids as the replicated copy
    got = aot.score_batch(x, bins)
    environment.set_property("shifu.wdl.serveCopy", "sharded")
    sharded = AOTScorer(models, device="cpu", buckets=(8, 64))
    assert sharded.score_batch(x, bins).tobytes() == got.tobytes()
    environment.set_property("shifu.wdl.serveCopy", "hot")
    environment.set_property("shifu.wdl.serveHotRows", "2")
    hot = AOTScorer(models, device="cpu", buckets=(8, 64)) \
        .score_batch(x, bins)
    cf = models[0].spec.extra["cat_col_idx"]
    head = (bins[:, cf] < 2).all(axis=1)
    assert head.any() and not np.array_equal(hot, got)
    np.testing.assert_array_equal(hot[head], got[head])


def test_streamed_training_matches_the_reference(wdl_template, tmp_path):
    """Full batch over windows of 512 rows (8 windows of the 4,000-row
    plane); then a 2 + 2 resume equals the uninterrupted run."""
    props = {"shifu.train.streaming": "on", "shifu.train.windowRows": "512"}
    ref, port = _copies(wdl_template, tmp_path, {"MiniBatchs": 0})
    _ref(ref, "train", props=props)
    assert _port(port, "train", props=props) == 0
    got, want = _progress(port), _progress(ref)
    assert len(got) == len(want) == 5      # 4 epochs + the closing sweep
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-6)
    # resume: 2 epochs, then 2 more from the checkpoint
    d2 = str(tmp_path / "resume")
    shutil.copytree(port, d2)
    shutil.rmtree(os.path.join(d2, "tmp", "checkpoints"),
                  ignore_errors=True)
    from shifu_tpu_torch.config import ModelConfig
    mc_path = os.path.join(d2, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.params = {**mc.train.params, "CheckpointInterval": 1}
    mc.train.numTrainEpochs = 2
    mc.save(mc_path)
    assert _port(d2, "train", props=props) == 0
    mc.train.numTrainEpochs = 4
    mc.save(mc_path)
    assert _port(d2, "train", "-resume", props=props) == 0
    np.testing.assert_array_equal(_progress(d2), got[2:])
    for f in ("model0.wdl", "model1.wdl"):
        a, b = (np.load(os.path.join(d, "models", f)) for d in (port, d2))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_grid_search_matches_the_reference(wdl_template, tmp_path):
    ref, port = _copies(wdl_template, tmp_path,
                        {"EmbedColumnNum": [2, 4], "MiniBatchs": 512},
                        epochs=3, bags=1)
    _ref(ref, "train")
    assert _port(port, "train") == 0
    np.testing.assert_allclose(_progress(port), _progress(ref), rtol=1e-4,
                               atol=2e-6)
    reports = [json.load(open(os.path.join(d, "tmp", "grid_search.json")))
               for d in (ref, port)]
    assert [t["params"] for t in reports[0]] == \
        [t["params"] for t in reports[1]]
    assert os.listdir(os.path.join(port, "models")) == ["model0.wdl"]


def test_hashed_plan_matches_the_reference(wdl_template, tmp_path):
    """``-Dshifu.wdl.hashBuckets=3``: ``country`` (6 bins with the missing
    one) hashes, ``channel`` (4) does not; the saved plans are equal and
    the sets train alike."""
    props = {"shifu.wdl.hashBuckets": "3"}
    ref, port = _copies(wdl_template, tmp_path, {"MiniBatchs": 512},
                        epochs=2, bags=1)
    _ref(ref, "train", props=props)
    assert _port(port, "train", props=props) == 0
    specs = [json.loads(bytes(np.load(os.path.join(
        d, "models", "model0.wdl"))["__spec__"]).decode())
        for d in (ref, port)]
    assert specs[0] == specs[1]
    assert specs[1]["extra"]["hash_buckets"] == 3
    assert specs[1]["cat_cardinalities"] == [3, 3]
    np.testing.assert_allclose(_progress(port), _progress(ref), rtol=1e-4,
                               atol=2e-6)


def test_plane_indices_match_the_reference(wdl_template):
    from shifu_tpu.config import load_column_configs as j_load
    from shifu_tpu_torch.config import load_column_configs
    from shifu_tpu_torch.data.shards import Shards
    schema = Shards.open(os.path.join(wdl_template, "tmp",
                                      "NormalizedData")).schema
    path = os.path.join(wdl_template, "ColumnConfig.json")
    with reference_wdl() as R:
        want = R.trainer.plane_indices(schema, j_load(path))
    got = PT.plane_indices(schema, load_column_configs(path))
    assert got == want
    assert got[1] and got[0]


def test_combo_with_wdl_and_svm_members_matches_the_reference(wdl_template,
                                                               tmp_path):
    """``combo`` WDL:SVM run and eval in each package: the assembled and
    per-member AUCs within ±0.005.  The SVM member is the linear one (a
    kernel SVM over the 4,000-row plane is
    ``tests/test_torch_svm.py``'s, on fewer rows, for time)."""
    from shifu_tpu.pipeline.combo import run_combo as j_combo
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.pipeline.combo import run_combo
    out = []
    for who in ("ref", "port"):
        d = str(tmp_path / who)
        shutil.copytree(wdl_template, d)
        mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
        mc.train.params = {"NumHiddenNodes": [8], "ActivationFunc": ["relu"],
                           "EmbedColumnNum": 3, "MiniBatchs": 512,
                           "LearningRate": 0.01, "Kernel": "linear",
                           "Propagation": "ADAM"}
        mc.train.numTrainEpochs = 3
        mc.save(os.path.join(d, "ModelConfig.json"))
        out.append(d)
    ref, port = out
    with reference_wdl():
        assert j_combo(ref, "new", "WDL:SVM") == 0
        assert j_combo(ref, "run", None) == 0
        assert j_combo(ref, "eval", None) == 0
    assert run_combo(port, "new", "WDL:SVM") == 0
    assert run_combo(port, "run", None, device="cpu") == 0
    assert run_combo(port, "eval", None, device="cpu") == 0
    got, want = (json.load(open(os.path.join(d, "ComboEval.Eval1.json")))
                 for d in (port, ref))
    assert got["members"] == want["members"] == ["WDL", "SVM"]
    assert abs(got["areaUnderRoc"] - want["areaUnderRoc"]) <= AUC_TOL
    for g, w in zip(got["memberAuc"], want["memberAuc"]):
        assert abs(g["areaUnderRoc"] - w["areaUnderRoc"]) <= AUC_TOL, (g, w)
