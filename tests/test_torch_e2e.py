"""The offline main path end to end in each package: ``new → init → stats
→ norm → train (GBT, MinInfoGain 1e-3) → eval`` on the fraud CSV, the
port through its CLI with ``--device cpu`` and the reference through its
processors, each in a model set of its own.

The port takes the CSV to a scored model with nothing of the reference:
its bins, targets and weights come out of its own ``norm`` byte for byte
as the reference's do (``stats`` gives bit-equal boundaries and
categories), both grow the same split structure (the gain floor keeps
them above the f32 noise splits of ROADMAP C9), and the eval AUCs agree
within ±0.005, ROADMAP's parity bound.
"""

import json
import os

import numpy as np
import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

AUC_TOL = 0.005
PARAMS = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log", "LearningRate": 0.1,
          "MinInfoGain": 1e-3}
WIRE = os.path.join("tmp", "CleanedData", ".spill_cache", "spill-bins-y-w")


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _configure(mc, csv_path):
    """The fraud set's dataSet, GBT train#params and one eval set on the
    same CSV (the ``_scaffold_model_set`` fields of ``tests/conftest.py``)."""
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv_path, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    ds.metaColumnNameFile = None
    mc.train.baggingNum = 1
    mc.train.params = dict(PARAMS)
    mc.evals[0].dataSet.dataPath = csv_path
    mc.evals[0].dataSet.dataDelimiter = "|"


def _run_port(base, csv_path):
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    assert cli.main(["--dir", base, "new", "e2e"]) == 0
    d = os.path.join(base, "e2e")
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    _configure(mc, csv_path)
    mc.train.algorithm = Algorithm.GBT
    mc.save(os.path.join(d, "ModelConfig.json"))
    for argv in (["init"], ["stats", "--device", "cpu"], ["norm"],
                 ["train", "--device", "cpu"],
                 ["eval", "-run", "--device", "cpu"]):
        assert cli.main(["--dir", d, *argv]) == 0, argv
    return d


def _run_ref(base, csv_path):
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.create import InitProcessor, create_new_model
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.stats import StatsProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    d = create_new_model("e2e", base_dir=base)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    _configure(mc, csv_path)
    mc.train.algorithm = Algorithm.GBT
    mc.save(os.path.join(d, "ModelConfig.json"))
    assert InitProcessor(d).run() == 0
    assert StatsProcessor(d, params={}).run() == 0
    assert NormalizeProcessor(d, params={}).run() == 0
    assert TrainProcessor(d, params={}).run() == 0
    assert EvalProcessor(d, params={"run_eval": ""}).run() == 0
    return d


def test_offline_main_path_matches_reference(fraud_csv, tmp_path):
    from shifu_tpu_torch.models.tree import load_model
    port = _run_port(str(tmp_path / "port"), fraud_csv)
    ref = _run_ref(str(tmp_path / "ref"), fraud_csv)
    for f in ("bins.raw", "y.raw", "w.raw"):
        with open(os.path.join(ref, WIRE, f), "rb") as g:
            want = g.read()
        with open(os.path.join(port, WIRE, f), "rb") as g:
            assert g.read() == want, f
    _, got = load_model(os.path.join(port, "models", "model0.gbt"))
    _, want = load_model(os.path.join(ref, "models", "model0.gbt"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.split_feat, w.split_feat)
        np.testing.assert_array_equal(g.left_mask, w.left_mask)
    perf = []
    for d in (port, ref):
        with open(os.path.join(d, "evals", "Eval1",
                               "EvalPerformance.json")) as f:
            perf.append(json.load(f))
    for k in ("areaUnderRoc", "weightedAuc", "areaUnderPr"):
        assert abs(perf[0][k] - perf[1][k]) <= AUC_TOL, \
            (k, perf[0][k], perf[1][k])
    assert perf[0]["recordCount"] == perf[1]["recordCount"] > 3500
    assert perf[0]["areaUnderRoc"] > 0.8
