"""Port parity for the ``varselect`` step and the SE/ST sensitivity job:
``shifu_tpu_torch.pipeline.varselect`` and ``ops.sensitivity`` against
``shifu_tpu``'s on two copies of the prepared fraud model set (the
reference ran ``init → stats → norm`` there).

Selections are compared exactly: ``finalSelect`` and ``columnFlag`` of
every column after KS, IV, MIX, PARETO and FI ranking, with the auto
filter (missing rate, minimum KS/IV, ``filterOutRatio``, correlation
pruning from a ``correlation.csv``) and the force files.  SE/ST score the
same ``model0.nn`` (trained once by the reference) over the norm plane:
the reference sums its windows in float64 under the test rig's x64
(``shifu_tpu/ops/sensitivity.py:163``, ROADMAP Queue 3 C3), the port sums
each window in float32 and accumulates them in float64, so the frozen
MSEs agree to about 1e-7, the SE scores (a difference of two such MSEs)
within 1e-6 absolute, the ST scores (SE over a base MSE of about 0.1)
within 1e-5 absolute; the selected set is equal.  The streamed job
equals the resident per-column oracle within rtol 3e-5 (the reference's
own bound, ``tests/test_varselect_stream.py``), a padded tail included.
Also: ``-list``, ``-reset``, ``-recover``, ``-autofilter`` and
``-recoverauto`` round trips with the reference's history files, the
filterBy-versus-algorithm check, and that ``filterBy GENETIC`` and
``-recursive`` run (their parity is ``tests/test_torch_dvarsel.py``'s).
"""

import json
import os
import shutil

import numpy as np
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


def _pair(template, root, **varselect):
    """Two copies of ``template`` with ``varSelect`` fields set."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import FilterBy
    dirs = []
    for who in ("ref", "port"):
        d = str(root / who)
        shutil.copytree(template, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        for k, v in varselect.items():
            setattr(mc.varSelect, k, FilterBy[v] if k == "filterBy" else v)
        mc.save(path)
        dirs.append(d)
    return dirs


def _ref(d, **params):
    from shifu_tpu.pipeline.varselect import VarSelectProcessor
    return VarSelectProcessor(d, params=params).run()


def _port(d, **params):
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    return VarSelectProcessor(d, params=params, device="cpu").run()


def _flags(d):
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        return [(c["columnName"], c.get("finalSelect"), c.get("columnFlag"))
                for c in json.load(f)]


def _selected(d):
    return {n for n, s, _ in _flags(d) if s}


CASES = {
    "ks": {"filterNum": 3},
    "iv": {"filterBy": "IV", "filterNum": 3},
    "mix": {"filterBy": "MIX", "filterNum": 4},
    "pareto": {"filterBy": "PARETO", "filterNum": 2},
    "ks_ratio": {"filterNum": 10, "filterOutRatio": 0.5},
    "auto_filter": {"autoFilterEnable": True, "missingRateThreshold": 0.03,
                    "minKsThreshold": 1.0, "filterNum": 10},
    "no_filter": {"filterEnable": False},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_selection_matches_reference(prepared_set, tmp_path, case):
    ref, port = _pair(prepared_set, tmp_path, **CASES[case])
    assert _ref(ref) == 0
    assert _port(port) == 0
    assert _flags(port) == _flags(ref)
    assert _selected(port)


def test_force_files_and_correlation_prune_match_reference(prepared_set,
                                                           tmp_path):
    """Force-select ``noise``, force-remove ``velocity``; a correlation
    matrix that ties ``amount`` to ``age_days`` drops the lower-KS one."""
    fs, fr = tmp_path / "sel.names", tmp_path / "rem.names"
    fs.write_text("noise\n")
    fr.write_text("# removed\nvelocity\n")
    ref, port = _pair(prepared_set, tmp_path,
                      forceSelectColumnNameFile=str(fs),
                      forceRemoveColumnNameFile=str(fr), filterNum=3,
                      autoFilterEnable=True, correlationThreshold=0.5)
    names = ["amount", "velocity", "age_days", "noise"]
    corr = np.eye(4)
    corr[0, 2] = corr[2, 0] = 0.9
    for d in (ref, port):
        with open(os.path.join(d, "correlation.csv"), "w") as f:
            f.write("," + ",".join(names) + "\n")
            for n, row in zip(names, corr):
                f.write(n + "," + ",".join(map(str, row)) + "\n")
    assert _ref(ref) == 0
    assert _port(port) == 0
    assert _flags(port) == _flags(ref)
    flags = {n: (s, fl) for n, s, fl in _flags(port)}
    assert flags["noise"] == (True, "ForceSelect")
    assert flags["velocity"] == (False, "ForceRemove")
    assert not (flags["amount"][0] and flags["age_days"][0])


def test_missing_correlation_matrix_skips_the_prune(prepared_set, tmp_path,
                                                    caplog):
    import logging
    ref, port = _pair(prepared_set, tmp_path, autoFilterEnable=True,
                      correlationThreshold=0.5, filterNum=4)
    assert _ref(ref) == 0
    with caplog.at_level(logging.WARNING):
        assert _port(port) == 0
    assert "correlation matrix missing" in caplog.text
    assert _flags(port) == _flags(ref)


def test_list_reset_recover_and_autofilter_round_trips(prepared_set,
                                                       tmp_path):
    """The same sequence in both packages gives the same selections and
    the same history entries (timestamps aside)."""
    ref, port = _pair(prepared_set, tmp_path, filterNum=5,
                      missingRateThreshold=0.03)
    steps = [{}, {"list": True}, {"reset": True}, {"recover": True},
             {"autofilter": True}, {"recoverauto": True}]
    for params in steps:
        assert _ref(ref, **params) == 0
        assert _port(port, **params) == 0
        assert _flags(port) == _flags(ref), params
    assert len(_selected(port)) == 5
    for f in ("varsel.history", "autofilter.history"):
        got, want = ([{k: v for k, v in json.loads(line).items()
                       if k != "ts"}
                      for line in open(os.path.join(d, "varsels", f))]
                     for d in (port, ref))
        assert got == want, f
    assert _ref(ref, recover=True) == _port(port, recover=True) == 0
    assert _ref(ref, recover=True) == _port(port, recover=True) == 1


@pytest.fixture(scope="module")
def nn_set(tmp_path_factory, _prepared_template):
    """The prepared set re-normalized without ``txn_id`` (a unique id
    whose bins leak the target: with it the net reaches zero error and
    every ST score divides by ~0), with a reference-trained NN
    ``model0.nn``; ``txn_id`` stays a candidate outside the plane."""
    import jax
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("torch_varsel") / "nnset")
    shutil.copytree(_prepared_template, d)
    cpath = os.path.join(d, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    for c in ccs:
        if c.get("columnFlag") not in ("Target", "Weight", "Meta") \
                and c["columnName"] != "txn_id":
            c["finalSelect"] = True
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    assert NormalizeProcessor(d, params={}).run() == 0
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.numTrainEpochs = 20
    mc.train.params = {"NumHiddenNodes": [8], "ActivationFunc": ["tanh"],
                       "Propagation": "R"}
    mc.save(path)
    with jax.enable_x64(False):
        assert TrainProcessor(d, params={}).run() == 0
    return d


@pytest.mark.parametrize("by", ["SE", "ST"])
def test_sensitivity_scores_and_selection_match_reference(nn_set, tmp_path,
                                                          by):
    ref, port = _pair(nn_set, tmp_path, filterBy=by, filterNum=3)
    assert _ref(ref) == 0
    assert _port(port) == 0
    assert _flags(port) == _flags(ref)
    got, want = (json.load(open(os.path.join(d, "varsels", "se.json")))
                 for d in (port, ref))
    assert list(got) == list(want) and len(got) >= 5
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want],
                               rtol=0, atol=1e-6 if by == "SE" else 1e-5)


def test_streamed_scores_equal_the_resident_loop_in_the_step(nn_set,
                                                             tmp_path):
    """``-Dshifu.varsel.batched=false`` (the resident per-column loop)
    and the streamed job (windows of 700 rows: a padded tail) select
    alike, with scores within the oracle's bound."""
    a, b = _pair(nn_set, tmp_path, filterBy="SE", filterNum=3)
    environment.set_property("shifu.train.windowRows", "700")
    assert _port(a) == 0
    environment.reset_for_tests()
    environment.set_property("shifu.varsel.batched", "false")
    assert _port(b) == 0
    assert _flags(a) == _flags(b)
    got, want = (json.load(open(os.path.join(d, "varsels", "se.json")))
                 for d in (a, b))
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=0, atol=1e-6)


@pytest.mark.parametrize("hidden,blocks", [
    ([8], [[i] for i in range(16)]), ([8, 4], [[i] for i in range(11)]),
    ([], [[0], [1, 2, 3], [4, 5], [6]])])
def test_streamed_sensitivity_matches_the_per_column_oracle(tmp_path,
                                                            hidden, blocks):
    """On resident data with a padded tail (window 1024 over 3,000 rows)
    the streamed MSEs match the per-column loop within rtol 3e-5, the
    reference's bound, for deep nets, an LR head and whole blocks; and
    the reference's own oracle on the same weights agrees too."""
    import jax.numpy as jnp
    from shifu_tpu.ops import sensitivity as j_sens
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.ioutil import atomic_savez, atomic_write_json
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.models.nn import params_to_jax
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops import sensitivity as sens
    rng = np.random.default_rng(42)
    n, d = 3000, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    spec = nn_model.NNModelSpec(input_dim=d, hidden_nodes=hidden,
                                activations=["tanh"] * max(1, len(hidden)))
    params = nn_model.init_params(prng.prng_key(0), spec)
    masks = sens.mask_matrix(d, blocks)
    mse_ref, base_ref = sens.per_column_scores(spec, params, x, y, masks,
                                               device="cpu")
    sd = str(tmp_path / "plane")
    os.makedirs(sd)
    for i, s in enumerate(range(0, n, 1000)):
        atomic_savez(os.path.join(sd, f"part-{i:05d}.npz"),
                     x=x[s:s + 1000], y=y[s:s + 1000])
    atomic_write_json(os.path.join(sd, "schema.json"), {
        "outputNames": [f"f{i}" for i in range(d)],
        "columnNums": list(range(d)), "numRows": n})
    stream = ShardStream(Shards.open(sd), ("x", "y"), 1024)
    mse, base, rows = sens.streamed_sensitivity(stream, spec, params, masks,
                                                mask_batch=5, device="cpu")
    assert rows == n
    np.testing.assert_allclose(mse, mse_ref, rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(base, base_ref, rtol=3e-5)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()}
          for layer in params_to_jax(params)]
    from shifu_tpu.models.nn import NNModelSpec as JSpec
    j_mse, j_base = j_sens.per_column_scores(
        JSpec(input_dim=d, hidden_nodes=hidden,
              activations=["tanh"] * max(1, len(hidden))),
        jp, x, y, masks)
    np.testing.assert_allclose(mse, j_mse, rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(base, j_base, rtol=3e-5)


def test_filterby_checks_and_unported_modes(prepared_set, nn_set, tmp_path):
    """SE on a tree set and FI on a net are refused as in the reference;
    GENETIC runs and writes ``genetic.json``; ``-recursive`` on a KS set
    is refused with the reference's return code."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm, FilterBy
    from shifu_tpu_torch.config.validator import ValidationError
    path = os.path.join(prepared_set, "ModelConfig.json")
    for alg, by in (("GBT", "SE"), ("NN", "FI")):
        mc = ModelConfig.load(path)
        mc.train.algorithm, mc.varSelect.filterBy = Algorithm[alg], \
            FilterBy[by]
        mc.save(path)
        with pytest.raises(ValidationError, match=f"filterBy {by}"):
            _port(prepared_set)
    _, port = _pair(nn_set, tmp_path, filterBy="GENETIC", filterNum=3,
                    params={"POPULATION_LIVE_SIZE": 4,
                            "POPULATION_MULTIPLY_CNT": 2,
                            "WrapperEpochs": 3})
    assert _port(port) == 0
    assert os.path.isfile(os.path.join(port, "varsels", "genetic.json"))
    assert len(_selected(port)) == 3
    ref, port = _pair(nn_set, tmp_path / "r", filterBy="KS")
    assert _ref(ref, recursive=2) == _port(port, recursive=2) == 1


@pytest.fixture(scope="module")
def gbt_set(tmp_path_factory, _prepared_template):
    """The prepared set with a reference-trained GBT."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("torch_varsel_fi") / "gbtset")
    shutil.copytree(_prepared_template, d)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                       "LearningRate": 0.1}
    mc.save(path)
    assert TrainProcessor(d, params={}).run() == 0
    return d


def test_fi_selection_from_each_packages_posttrain(gbt_set, tmp_path):
    """FI ranks by ``posttrain``'s featureImportance.csv: each package's
    posttrain, then its varselect, selects the same columns; the CLI
    runs the port's."""
    from shifu_tpu.pipeline.posttrain import PostTrainProcessor
    from shifu_tpu_torch.cli import main
    ref, port = _pair(gbt_set, tmp_path, filterBy="FI", filterNum=3)
    assert PostTrainProcessor(ref, params={}).run() == 0
    assert main(["--dir", port, "posttrain", "--device", "cpu"]) == 0
    assert _ref(ref) == 0
    assert main(["--dir", port, "varsel", "--device", "cpu"]) == 0
    assert _flags(port) == _flags(ref)
    assert len(_selected(port)) == 3
