"""Port parity for the ``eval`` step: ``EvalProcessor`` of ``shifu_tpu``
and of ``shifu_tpu_torch`` (``device="cpu"``) over one ``models/``
directory, trained by the reference on the prepared fraud model set
(GBT, TreeNum 5, MaxDepth 4), each on its own copy of the set.

Tolerances: per-row scores within 1e-3 on the 0–1000 scale after parsing
the ``%.3f`` score file (the f32 GBT link of per-tree sums taken in
another order differs by an ulp, which can move the third decimal by one);
``tag`` and ``weight`` columns equal; ``areaUnderRoc``, ``weightedAuc``
and ``areaUnderPr`` within ±0.005 (ROADMAP's parity bound; the measured
difference is 0 on this fixture, asserted below the bound at 1e-9); the
confusion matrix's and gain chart's count columns equal and their score
thresholds within 1e-3.  Also covered: ``-score`` (sorted and
``-nosort``), ``-norm`` export, ``-new``/``-delete`` on
``ModelConfig.json``, the CLI, ``score_records_offline`` against the
reference's and against the port's serving path, the host sweep, gain
chart and HTML report on synthetic scores with ties, and the parts that
are not ported raising with their ROADMAP item.
"""

import csv
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))

pytestmark = pytest.mark.torch_port

SCORE_TOL = 1e-3 + 1e-9     # 0-1000 scale, %.3f files, parsed
AUC_TOL = 0.005
COUNTS = ("tp", "fp", "fn", "tn")
EVAL = os.path.join("evals", "Eval1")


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


@pytest.fixture(scope="module")
def trained_set(tmp_path_factory, _prepared_template):
    """The prepared set with a GBT the reference trained (read-only)."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("torch_eval") / "gbtset")
    shutil.copytree(_prepared_template, d)
    mc_path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                       "LearningRate": 0.1}
    mc.save(mc_path)
    assert TrainProcessor(d, params={}).run() == 0
    return d


@pytest.fixture
def pair(trained_set, tmp_path):
    """Two copies of the trained set: (ref, port)."""
    dirs = []
    for name in ("ref", "port"):
        dirs.append(str(tmp_path / name))
        shutil.copytree(trained_set, dirs[-1])
    return dirs


def _eval_ref(d, **params):
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    return EvalProcessor(d, params=params).run()


def _eval_port(d, **params):
    from shifu_tpu_torch.pipeline.evaluate import EvalProcessor
    return EvalProcessor(d, params=params, device="cpu").run()


def _score_file(d):
    with open(os.path.join(d, EVAL, "EvalScore")) as f:
        rows = list(csv.reader(f, delimiter="|"))
    return rows[0], np.asarray(rows[1:], dtype=object)


def _assert_same_scores(ref, port):
    head, a = _score_file(ref)
    head_p, b = _score_file(port)
    assert head_p == head == ["tag", "weight", "mean", "max", "min",
                              "median", "model0"]
    assert len(a) == len(b) > 3500
    np.testing.assert_array_equal(b[:, :2], a[:, :2])      # tag, weight
    diff = np.abs(b[:, 2:].astype(float) - a[:, 2:].astype(float))
    assert diff.max() <= SCORE_TOL
    return a


def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_eval_run_matches_reference(pair):
    ref, port = pair
    assert _eval_ref(ref, run_eval="") == 0
    assert _eval_port(port, run_eval="") == 0
    _assert_same_scores(ref, port)
    with open(os.path.join(ref, EVAL, "EvalPerformance.json")) as f:
        want = json.load(f)
    with open(os.path.join(port, EVAL, "EvalPerformance.json")) as f:
        got = json.load(f)
    for k in ("areaUnderRoc", "weightedAuc", "areaUnderPr"):
        d = abs(got[k] - want[k])
        assert d <= AUC_TOL and d < 1e-9, (k, got[k], want[k], d)
    assert 0.8 < got["areaUnderRoc"] < 1.0
    for k in ("recordCount", "posCount", "negCount", "modelCount"):
        assert got[k] == want[k], k
    assert len(got["performance"]) == len(want["performance"]) == 10
    for g, w in zip(got["performance"], want["performance"]):
        assert {k: g[k] for k in COUNTS} == {k: w[k] for k in COUNTS}
    conf_r = _csv_rows(os.path.join(ref, EVAL, "EvalConfusionMatrix"))
    conf_p = _csv_rows(os.path.join(port, EVAL, "EvalConfusionMatrix"))
    assert len(conf_p) == len(conf_r) == 10
    for g, w in zip(conf_p, conf_r):
        assert g.keys() == w.keys()
        for k in g:
            if k == "binLowestScore":
                assert abs(float(g[k]) - float(w[k])) <= SCORE_TOL
            else:                  # counts and the rates made from them
                assert g[k] == w[k], k
    gain_r = _csv_rows(os.path.join(ref, EVAL, "gainchart.csv"))
    gain_p = _csv_rows(os.path.join(port, EVAL, "gainchart.csv"))
    assert len(gain_p) == len(gain_r) == 10
    for g, w in zip(gain_p, gain_r):
        assert abs(float(g.pop("score")) - float(w.pop("score"))) \
            <= SCORE_TOL
        assert g == w
    with open(os.path.join(port, EVAL, "report.html")) as f:
        html = f.read()
    assert "<svg" in html and f"{got['areaUnderRoc']:.6f}" in html


@pytest.mark.parametrize("nosort", [False, True])
def test_eval_score_order_matches_reference(pair, nosort):
    ref, port = pair
    assert _eval_ref(ref, score="", nosort=nosort) == 0
    assert _eval_port(port, score="", nosort=nosort) == 0
    a = _assert_same_scores(ref, port)
    mean = a[:, 2].astype(float)
    assert (np.all(np.diff(mean) <= 0)) != nosort
    assert not os.path.exists(os.path.join(port, EVAL,
                                           "EvalPerformance.json"))


def test_eval_norm_export_matches_reference(pair):
    ref, port = pair
    assert _eval_ref(ref, norm_eval="") == 0
    assert _eval_port(port, norm_eval="Eval1") == 0
    with open(os.path.join(ref, EVAL, "EvalNormalized")) as f:
        want = f.read()
    with open(os.path.join(port, EVAL, "EvalNormalized")) as f:
        assert f.read() == want
    assert want.count("\n") > 3500


def test_eval_new_delete_list_match_reference(pair):
    ref, port = pair
    for d, run in ((ref, _eval_ref), (port, _eval_port)):
        assert run(d, new_eval="Holdout") == 0
        assert run(d, new_eval="Holdout") == 1            # exists already
        assert run(d, list=True) == 0
    with open(os.path.join(ref, "ModelConfig.json")) as f:
        want = json.load(f)["evals"]
    with open(os.path.join(port, "ModelConfig.json")) as f:
        got = json.load(f)["evals"]
    assert got == want and [e["name"] for e in got] == ["Eval1", "Holdout"]
    assert got[1]["dataSet"]["dataPath"] == got[0]["dataSet"]["dataPath"]
    for d, run in ((ref, _eval_ref), (port, _eval_port)):
        assert run(d, delete_eval="Holdout") == 0
        assert run(d, delete_eval="Holdout") == 1
    with open(os.path.join(ref, "ModelConfig.json")) as f:
        want = json.load(f)["evals"]
    with open(os.path.join(port, "ModelConfig.json")) as f:
        assert json.load(f)["evals"] == want


def test_eval_cli_matches_reference(pair):
    from shifu_tpu_torch import cli
    ref, port = pair
    assert _eval_ref(ref, run_eval="Eval1") == 0
    assert cli.main(["--dir", port, "eval", "-run", "Eval1",
                     "--device", "cpu"]) == 0
    _assert_same_scores(ref, port)
    assert cli.main(["--dir", port, "eval", "-new", "Other"]) == 0
    with pytest.raises(ValueError, match="no eval set named Nope"):
        cli.main(["--dir", port, "eval", "-run", "Nope", "--device", "cpu"])


def _records(d, n=300):
    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        recs = [dict(r) for _, r in zip(range(n),
                                        csv.DictReader(f, delimiter="|"))]
    rng = np.random.default_rng(5)
    for r in recs:
        roll = rng.random()
        if roll < 0.2 and r.get("amount"):
            r["amount"] = float(r["amount"])
        elif roll < 0.25:
            r.pop("velocity", None)
        elif roll < 0.3:
            r["country"] = "ZZ"
    return recs


def test_score_records_offline_matches_reference_and_serve(trained_set):
    """The port's offline oracle against the reference's, and the port's
    serving path (its fused transform, in float64 as the reference's
    oracle contract is stated) against the port's oracle."""
    from shifu_tpu.pipeline.evaluate import score_records_offline as j_score
    from shifu_tpu_torch.pipeline.evaluate import score_records_offline
    from shifu_tpu_torch.serve import ServeServer
    recs = _records(trained_set)
    got = score_records_offline(trained_set, recs, device="cpu")
    want = j_score(trained_set, recs)
    assert got.dtype == np.float32 and got.shape == (len(recs),)
    assert np.max(np.abs(got - want)) <= 1e-4
    served = ServeServer(trained_set, device="cpu", dtype=torch.float64)
    scores = np.asarray(served.score_raw(recs)["scores"], np.float32)
    np.testing.assert_array_equal(scores, got)
    for sel in ("max", "model0"):
        np.testing.assert_array_equal(
            score_records_offline(trained_set, recs, selector=sel,
                                  device="cpu"), got)


def test_multiclass_eval_raises_item_6(pair):
    """Multi-class eval, no longer raising (it was ROADMAP item 6): the
    trained forest stamped as three one-vs-all members (``class_index``
    0-2, each with its own prior) over three tags, scored by both
    packages; accuracy and confusion matrix equal, per-class AUC within
    AUC_TOL (the third class has no rows: NaN in both), class scores
    within 1e-5 in the ``%.6f`` score files."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.models.tree import load_model, save_model
    for d in pair:
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.dataSet.posTags, mc.dataSet.negTags = ["bad", "good", "meh"], []
        mc.evals[0].dataSet.posTags, mc.evals[0].dataSet.negTags = [], []
        mc.save(path)
        mdir = os.path.join(d, "models")
        spec, trees = load_model(os.path.join(mdir, "model0.gbt"))
        for k in range(3):
            spec.extra = {"class_index": k, "n_classes": 3}
            spec.init_score = -0.4 + 0.3 * k
            save_model(os.path.join(mdir, f"model{k}.gbt"), spec, trees)
    ref, port = pair
    assert _eval_ref(ref, run_eval="") == 0
    assert _eval_port(port, run_eval="") == 0
    got, want = [json.load(open(os.path.join(d, EVAL,
                                             "EvalPerformance.json")))
                 for d in (port, ref)]
    assert got["nClasses"] == want["nClasses"] == 3
    assert got["accuracy"] == want["accuracy"]
    assert got["confusionMatrix"] == want["confusionMatrix"]
    assert got["classCounts"] == want["classCounts"]
    np.testing.assert_allclose(got["perClassAuc"], want["perClassAuc"],
                               atol=AUC_TOL, equal_nan=True)
    assert np.isnan(got["perClassAuc"][2])
    (head, a), (head_p, b) = _score_file(ref), _score_file(port)
    assert head_p == head == ["tag", "weight", "predictedTag",
                              "score_bad", "score_good", "score_meh"]
    np.testing.assert_array_equal(b[:, :3], a[:, :3])
    np.testing.assert_allclose(b[:, 3:].astype(float),
                               a[:, 3:].astype(float), atol=1e-5)


def test_eval_with_telemetry_writes_drift_and_counters(pair, tmp_path):
    """With telemetry on, eval's streaming drift monitor writes the eval
    set's per-column PSI to ``telemetry/drift.json`` (within 1e-6 of the
    reference's) and the trace counts the same ``eval.rows_scored`` and
    AUC gauge."""
    from shifu_tpu import obs as jobs
    from shifu_tpu_torch import obs
    from torch_port import shifted_source
    rows = 0
    for d in pair:
        rows = shifted_source(d, str(tmp_path / "src"))
    try:
        jobs.set_enabled(True)
        assert _eval_ref(pair[0], run_eval="") == 0
        obs.set_enabled(True)
        assert _eval_port(pair[1], run_eval="") == 0
    finally:
        jobs.reset_for_tests()
        obs.reset_for_tests()
    docs, metrics = [], []
    for d in pair:
        with open(os.path.join(d, "telemetry", "drift.json")) as f:
            docs.append(json.load(f))
        with open(os.path.join(d, "telemetry", "trace.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        metrics.append({r["name"]: r.get("value") for r in recs
                        if r["kind"] == "metric" and r["name"] in (
                            "eval.rows_scored", "eval.Eval1.auc")})
    ref, port = docs
    assert port["rows"] == ref["rows"] == rows
    for col, v in ref["columns"].items():
        assert abs(port["columns"][col] - v) <= 1e-6, col
    assert metrics[1]["eval.rows_scored"] == metrics[0]["eval.rows_scored"]
    assert abs(metrics[1]["eval.Eval1.auc"]
               - metrics[0]["eval.Eval1.auc"]) <= 0.005


def test_eval_run_warns_that_no_posttrain_snapshot_is_written(pair,
                                                              caplog):
    """``eval -run`` writes ``telemetry/posttrain.json`` (the serving
    quality monitor's baseline) on every scored run, as the reference
    does, and no longer warns that it does not: the two snapshots agree
    on rows and AUC (eval's +-0.005)."""
    from shifu_tpu.obs.quality import load_posttrain_snapshot
    ref, port = pair
    with caplog.at_level("WARNING",
                         logger="shifu_tpu_torch.pipeline.evaluate"):
        assert _eval_port(port, run_eval="") == 0
    warned = [r for r in caplog.records if r.levelname == "WARNING"]
    assert not warned
    assert _eval_ref(ref, run_eval="") == 0
    got, want = load_posttrain_snapshot(port), load_posttrain_snapshot(ref)
    assert got is not None and want is not None
    assert got["kind"] == "posttrain" and got["rows"] == want["rows"]
    assert abs(got["auc"] - want["auc"]) <= 0.005


def test_eval_scores_on_cuda_by_default_and_crud_on_the_host(pair,
                                                             monkeypatch):
    """``eval`` scores on CUDA unless told otherwise (raising without
    it); the actions that score nothing run on the host."""
    from shifu_tpu_torch import cli
    port = pair[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args(["eval"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--dir", port, "eval", "-run"])
    assert cli.main(["--dir", port, "eval", "-new", "Other"]) == 0
    assert cli.main(["--dir", port, "eval", "-list"]) == 0
    assert cli.main(["--dir", port, "norm"]) == 0


@pytest.mark.parametrize("seed,n,levels", [(0, 2000, 0), (1, 500, 37),
                                           (2, 50, 3)])
def test_metrics_match_reference(seed, n, levels):
    """The host sweep and report on scores with and without ties (a score
    grid of ``levels`` values; 0 = continuous), weighted, at 10 and 7
    buckets: every field equal, gain-chart rows and the HTML equal."""
    from shifu_tpu.eval import metrics as jm
    from shifu_tpu.eval.report import html_report as j_html
    from shifu_tpu_torch.eval import metrics as pm
    from shifu_tpu_torch.eval.report import html_report
    rng = np.random.default_rng(seed)
    s = rng.random(n) * 1000.0
    if levels:
        s = np.round(s / 1000.0 * levels) * (1000.0 / levels)
    y = (rng.random(n) < s / 1000.0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    for buckets in (10, 7):
        got = pm.evaluate_scores(s.astype(np.float32), y, w, buckets)
        want = jm.evaluate_scores(s.astype(np.float32), y, w, buckets)
        assert got.to_dict() == want.to_dict()
        assert pm.gain_chart_rows(got) == jm.gain_chart_rows(want)
    curves, j_curves = pm.sweep(s, y, w), jm.sweep(s, y, w)
    assert html_report("e", curves, pm.evaluate_curves(curves)) == \
        j_html("e", j_curves, jm.evaluate_curves(j_curves))
    degenerate = pm.evaluate_scores(s, np.ones(n), w).to_dict()
    assert degenerate == jm.evaluate_scores(s, np.ones(n), w).to_dict()
    assert degenerate["areaUnderRoc"] is None


@pytest.mark.parametrize("step", ["EVAL", "NORMALIZE"])
def test_probe_rules_match_reference(trained_set, step):
    """The EVAL rules (eval sets named, data present, bucket count in
    range) and NORMALIZE's data-set rules list the reference's problems."""
    from shifu_tpu.config import ModelConfig as JModelConfig
    from shifu_tpu.config.validator import ModelStep as JStep
    from shifu_tpu.config.validator import ValidationError as JError
    from shifu_tpu.config.validator import probe as j_probe
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.validator import (ModelStep,
                                                  ValidationError, probe)
    path = os.path.join(trained_set, "ModelConfig.json")
    got, want = ModelConfig.load(path), JModelConfig.load(path)
    for mc, check, steps in ((got, probe, ModelStep),
                             (want, j_probe, JStep)):
        check(mc, steps[step], trained_set)                 # valid as is
        mc.evals[0].performanceBucketNum = 0
        mc.evals[0].dataSet.dataPath = "no/such/file.csv"
        mc.evals.append(type(mc.evals[0])())
        mc.dataSet.targetColumnName = None
    with pytest.raises(ValidationError) as e:
        probe(got, ModelStep[step], trained_set)
    with pytest.raises(JError) as je:
        j_probe(want, JStep[step], trained_set)
    assert e.value.problems == je.value.problems
    assert len(e.value.problems) == (4 if step == "EVAL" else 1)
