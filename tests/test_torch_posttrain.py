"""Port parity for the ``posttrain`` step: ``PostTrainProcessor`` of
``shifu_tpu`` and of ``shifu_tpu_torch`` (``device="cpu"``) on two copies
of one trained model set, a GBT (5 trees, depth 4) and an NN, each trained
once by the reference on the prepared fraud set.

The tolerance is zero: ``ColumnConfig.binAvgScore`` (Python ``round`` of
each bin's average score) is equal column for column, and
``posttrain/featureImportance.csv`` and ``posttrain/binAvgScore.csv`` are
equal byte for byte.  The clean plane is the default ``wireOnly`` wire
plane (no ``part-*.npz`` in ``CleanedData``), and for the GBT also the
npz plane of ``-Dshifu.norm.wireOnly=false``.
"""

import json
import os
import shutil

import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


PARAMS = {
    "GBT": {"TreeNum": 5, "MaxDepth": 4, "Loss": "log", "LearningRate": 0.1},
    "NN": {"NumHiddenNodes": [6], "ActivationFunc": ["tanh"],
           "Propagation": "R"},
}


@pytest.fixture(scope="module", params=[("GBT", "wire"), ("GBT", "npz"),
                                        ("NN", "wire")],
                ids=["gbt-wire", "gbt-npz", "nn-wire"])
def trained(request, tmp_path_factory, _prepared_template):
    import jax
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    alg, plane = request.param
    d = str(tmp_path_factory.mktemp("torch_posttrain") / "set")
    shutil.copytree(_prepared_template, d)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm[alg]
    mc.train.params = dict(PARAMS[alg])
    mc.train.numTrainEpochs = 10
    mc.save(path)
    if plane == "npz":
        j_environment.set_property("shifu.norm.wireOnly", "false")
        assert NormalizeProcessor(d, params={}).run() == 0
        j_environment.reset_for_tests()
    with jax.enable_x64(False):
        assert TrainProcessor(d, params={}).run() == 0
    clean = os.path.join(d, "tmp", "CleanedData")
    assert any(f.endswith(".npz") for f in os.listdir(clean)) == \
        (plane == "npz")
    return d


def _bin_avg(d):
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        return {c["columnName"]: c["columnBinning"].get("binAvgScore")
                for c in json.load(f)}


def test_posttrain_artifacts_equal_the_reference(trained, tmp_path):
    from shifu_tpu.pipeline.posttrain import PostTrainProcessor as Ref
    from shifu_tpu_torch.pipeline.posttrain import PostTrainProcessor
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(trained, ref)
    shutil.copytree(trained, port)
    assert Ref(ref, params={}).run() == 0
    assert PostTrainProcessor(port, device="cpu").run() == 0
    got, want = _bin_avg(port), _bin_avg(ref)
    assert got == want
    assert sum(v is not None for v in got.values()) >= 5
    for f in ("featureImportance.csv", "binAvgScore.csv"):
        with open(os.path.join(port, "posttrain", f)) as a, \
                open(os.path.join(ref, "posttrain", f)) as b:
            text = a.read()
            assert text == b.read(), f
            assert len(text.splitlines()) >= 5
