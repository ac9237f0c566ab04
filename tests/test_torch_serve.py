"""Port parity for the serving slice as a whole: a GBT model set trained by
``shifu_tpu`` (prepared_set -> TrainProcessor, TreeNum 5, MaxDepth 4)
served by ``shifu_tpu.serve.ServeServer`` and by
``shifu_tpu_torch.serve.ServeServer(device="cpu")``.

Scores are the f32 GBT link of per-tree sums, taken in another order by
each package, so they agree within 1e-4 on the 0–1000 scale; errors and
generations agree exactly.  Also covered: the port's HTTP front end on an
ephemeral port, its CLI selfcheck against the reference CLI's, and the
model file read byte for byte across packages.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

TOL = 1e-4          # 0-1000 scale: f32 tree sums in another order


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


@pytest.fixture(scope="module")
def gbt_set(tmp_path_factory, _prepared_template):
    """One GBT model set trained by the reference, shared by this module
    (read-only: every server below keeps its state in memory)."""
    import shutil

    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("torch_serve") / "gbtset")
    shutil.copytree(_prepared_template, d)
    mc_path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                       "LearningRate": 0.1}
    mc.save(mc_path)
    assert TrainProcessor(d, params={}).run() == 0
    assert os.path.isfile(os.path.join(d, "models", "model0.gbt"))
    return d


def _records(d, n=200):
    """Raw records from the model set's own CSV, with JSON-typed numbers,
    missing fields, junk strings, unknown categories and one malformed
    record."""
    import csv

    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        recs = [dict(r) for _, r in zip(range(n),
                                        csv.DictReader(f, delimiter="|"))]
    rng = np.random.default_rng(3)
    for i, r in enumerate(recs):
        roll = rng.random()
        if roll < 0.2 and r.get("amount"):
            r["amount"] = float(r["amount"])
        elif roll < 0.25:
            r.pop("velocity", None)
        elif roll < 0.3:
            r["age_days"] = "n/a"
        elif roll < 0.35:
            r["country"] = "ZZ"
    recs[17] = ["not", "an", "object"]
    return recs


def _servers(d, **kw):
    from shifu_tpu.serve import ServeServer as JServeServer
    from shifu_tpu_torch.serve import ServeServer
    return (ServeServer(d, key="gbt", device="cpu", dtype=torch.float64,
                        **kw),
            JServeServer(d, key="gbt", **kw))


def test_score_raw_matches_reference(gbt_set):
    server, jserver = _servers(gbt_set, buckets=(1, 8, 64))
    recs = _records(gbt_set)
    got, want = server.score_raw(recs), jserver.score_raw(recs)
    assert got["errors"] == want["errors"] and len(got["errors"]) == 1
    assert got["generation"] == want["generation"] == 0
    g = [s is None for s in got["scores"]]
    assert g == [s is None for s in want["scores"]] and g[17]
    a = np.asarray([s for s in got["scores"] if s is not None])
    b = np.asarray([s for s in want["scores"] if s is not None])
    assert np.max(np.abs(a - b)) <= TOL
    assert 0.0 < a.min() and a.max() < 1000.0


def test_prebinned_rows_match_reference(gbt_set):
    from shifu_tpu.serve.transform import FusedTransform as JFusedTransform
    server, jserver = _servers(gbt_set, buckets=(1, 8, 64))
    jtf = JFusedTransform.from_dir(gbt_set)
    packed, _, _ = jtf.parse_records(
        [r for r in _records(gbt_set, 100) if isinstance(r, dict)])
    import jax
    _, bins = jax.jit(jtf.apply_device)(packed)
    scorer = server.registry.get("gbt")
    bins = np.asarray(bins)[:, :scorer.n_bins_cols]
    rows = np.zeros((len(bins), scorer.n_features), np.float32)
    got = server.score(rows, bins)
    want = jserver.score(rows, bins)
    assert got.shape == want.shape == (len(bins),)
    assert np.max(np.abs(got - want)) <= TOL
    assert server.status()["needs_bins"] is True
    assert jserver.status()["n_features"] == scorer.n_features


def test_oversize_batch_chunks_through_top_rung(gbt_set):
    server, _ = _servers(gbt_set, buckets=(1, 8))
    recs = [r for r in _records(gbt_set, 40) if isinstance(r, dict)]
    whole = server.score_raw(recs)["scores"]
    parts = [s for i in range(0, len(recs), 5)
             for s in server.score_raw(recs[i:i + 5])["scores"]]
    assert np.asarray(whole).tobytes() == np.asarray(parts).tobytes()
    st = server.status()
    assert st["bucket_counts"] and set(st["bucket_counts"]) <= {"1", "8"}


def test_http_front_end_scores_and_reports_health(gbt_set):
    from http.server import ThreadingHTTPServer

    from shifu_tpu_torch.serve.server import _make_handler
    server, jserver = _servers(gbt_set, buckets=(1, 8, 64), max_delay_ms=1.0)
    server.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(req, timeout=30))
    try:
        recs = _records(gbt_set, 30)
        doc = post({"records": recs})
        want = jserver.score_raw(recs)
        assert doc["errors"] == want["errors"]
        for s, w in zip(doc["scores"], want["scores"]):
            assert (s is None) == (w is None)
            assert s is None or abs(s - w) <= TOL + 5e-7  # 6-decimal reply
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"records": [17, None]})
        assert ei.value.code == 400
        health = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=30))
        assert health["accepts_raw"] is True and health["state"] == "serving"
        assert health["device"] == "cpu" and health["buckets"] == [1, 8, 64]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_cli_selfcheck_matches_reference_cli(gbt_set, capsys):
    from shifu_tpu.cli import main as j_cli_main
    from shifu_tpu_torch.cli import main as cli_main
    args = ["--dir", gbt_set, "-Dshifu.serve.buckets=1,4,16", "serve",
            "--selfcheck", "4"]
    assert cli_main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_cli_main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("selfcheck_rows", "buckets", "needs_bins", "accepts_raw",
              "n_features", "models", "generation"):
        assert got[k] == want[k], k
    # the heads are rounded to 4 decimals: one rounding step of slack
    assert np.max(np.abs(np.subtract(got["scores_head"],
                                     want["scores_head"]))) <= TOL + 1e-4
    assert got["device"] == "cpu" and got["buckets"] == [1, 4, 16]


def test_reference_model_file_loads_byte_for_byte(gbt_set):
    from shifu_tpu.models.tree import load_model as j_load_model
    from shifu_tpu.ops.tree_quant import stack_forest_quant as j_stack
    from shifu_tpu_torch.models import load_any
    from shifu_tpu_torch.models.tree import forest_from_numpy, load_model
    path = os.path.join(gbt_set, "models", "model0.gbt")
    spec, trees = load_model(path)
    jspec, jtrees = j_load_model(path)
    assert spec.to_json() == jspec.to_json()
    for t, jt in zip(trees, jtrees):
        for f in ("split_feat", "left_mask", "leaf_value"):
            a, b = getattr(t, f), getattr(jt, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    model = forest_from_numpy(jspec.to_json(),
                              *[np.asarray(a) for a in j_stack(jtrees)])
    loaded = load_any(path)
    for got, want in zip(model.quant_arrays(torch.device("cpu")),
                         loaded.quant_arrays(torch.device("cpu"))):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_port_saver_writes_what_the_reference_reads(gbt_set, tmp_path):
    from shifu_tpu.models.tree import IndependentTreeModel as JModel
    from shifu_tpu_torch.models.tree import load_model, save_model
    spec, trees = load_model(os.path.join(gbt_set, "models", "model0.gbt"))
    out = str(tmp_path / "model0.gbt")
    save_model(out, spec, trees)
    n_cols = 1 + max(int(t.split_feat.max()) for t in trees)
    bins = np.random.default_rng(0).integers(
        0, spec.n_bins, size=(64, n_cols)).astype(np.uint8)
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    got = IndependentTreeModel.load(out).compute(bins, device="cpu")
    want = JModel.load(out).compute(bins)
    assert got.shape == want.shape == (64, 1)
    assert np.max(np.abs(got - want)) <= TOL / 1000.0


def test_eval_scorer_matches_reference(gbt_set):
    """The tree-only eval ``Scorer`` over a models dir: per-model scaled
    scores and the row aggregates."""
    from shifu_tpu.eval.scorer import Scorer as JScorer
    from shifu_tpu_torch.eval.scorer import Scorer, discover_model_paths
    from shifu_tpu.eval.scorer import discover_model_paths as j_discover
    models_dir = os.path.join(gbt_set, "models")
    assert discover_model_paths(models_dir) == j_discover(models_dir)
    scorer = Scorer.from_dir(models_dir, device="cpu")
    n_cols = 1 + max(int(t.split_feat.max())
                     for m in scorer.models for t in m.trees)
    bins = np.random.default_rng(1).integers(
        0, 40, size=(50, n_cols)).astype(np.int32)
    got = scorer.score(None, bins)
    want = JScorer.from_dir(models_dir).score(
        np.zeros((50, 0), np.float32), bins)
    assert got.scores.shape == want.scores.shape == (50, 1)
    for f in ("scores", "mean", "max", "min", "median"):
        assert np.max(np.abs(getattr(got, f) - getattr(want, f))) <= TOL


def test_unported_model_kinds_raise_clearly(tmp_path):
    from shifu_tpu_torch.models import load_any
    path = str(tmp_path / "model0.nn")
    np.savez(path, __spec__=np.frombuffer(
        json.dumps({"kind": "nn"}).encode(), np.uint8))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_any(path + ".npz")
