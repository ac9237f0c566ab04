"""Port parity for ``new → init → stats`` on the ``model_set`` fixture:
``shifu_tpu_torch`` (on the CPU) against ``shifu_tpu`` on the same model
set and data.

- ``new`` and ``init -model`` write the reference's ModelConfig.json, and
  ``init`` its ColumnConfig.json, equal field for field (types, flags,
  ``distinctCount``, ``sampleValues``).
- After ``stats``, every integer, string, category list and
  ``binBoundary`` is equal; float stats agree within 1e-5 relative + 1e-6
  absolute: the moments and weighted sums are f32 sums taken in another
  order (and the test rig runs JAX in x64, ROADMAP Queue 3 C3), combined in
  f64 alike.  Covered: the fused one-pass sweep, the two-pass sweep, a fused
  sweep that overflows into the provisional grid, a shrunk chunk size and
  an unweighted set.
"""

import json
import os
import shutil

import pytest
import torch

from shifu_tpu.config import ModelConfig as JModelConfig
from shifu_tpu.config import environment as jenv
from shifu_tpu.data import parsepool as jpp
from shifu_tpu.pipeline.create import InitProcessor as JInit
from shifu_tpu.pipeline.create import check_algorithm_param as j_check
from shifu_tpu.pipeline.create import create_new_model as j_new
from shifu_tpu.pipeline.stats import StatsProcessor as JStats
from shifu_tpu_torch import cli
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.data import parsepool as ppp
from shifu_tpu_torch.pipeline.create import check_algorithm_param
from shifu_tpu_torch.pipeline.create import create_new_model
from shifu_tpu_torch.pipeline.stats import StatsProcessor

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_close(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and not where.endswith(".binBoundary"):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and isinstance(got, float):
        assert got == want or abs(got - want) <= RTOL * abs(want) + ATOL, \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def _edit(mdir, **fields):
    path = os.path.join(mdir, "ModelConfig.json")
    doc = _json(path)
    for key, value in fields.items():
        node = doc
        *parents, last = key.split(".")
        for p in parents:
            node = node[p]
        node[last] = value
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def _port_copy(model_set, tmp_path):
    dst = str(tmp_path / "port" / "fraudtest")
    shutil.copytree(model_set, dst)
    return dst


def test_new_and_init_model_write_the_reference_config(tmp_path):
    for alg in ("GBT", "NN"):
        a = j_new("m", base_dir=str(tmp_path / f"j{alg}"), algorithm=alg,
                  description="d")
        b = create_new_model("m", base_dir=str(tmp_path / f"p{alg}"),
                             algorithm=alg, description="d")
        assert _json(os.path.join(b, "ModelConfig.json")) == \
            _json(os.path.join(a, "ModelConfig.json"))
        assert j_check(a) == check_algorithm_param(b) == 0
        assert _json(os.path.join(b, "ModelConfig.json")) == \
            _json(os.path.join(a, "ModelConfig.json"))
        with pytest.raises(FileExistsError):
            create_new_model("m", base_dir=str(tmp_path / f"p{alg}"))


@pytest.mark.parametrize("meta", [False, True])
def test_init_writes_the_reference_column_config(model_set, tmp_path, meta):
    if meta:                    # an id column marked meta, as users do
        with open(os.path.join(model_set, "meta.txt"), "w") as f:
            f.write("# ids\ntxn_id\n")
        _edit(model_set, **{"dataSet.metaColumnNameFile": "meta.txt"})
    port = _port_copy(model_set, tmp_path)
    assert JInit(model_set).run() == 0
    assert cli.main(["--dir", port, "init"]) == 0
    want = _json(os.path.join(model_set, "ColumnConfig.json"))
    assert _json(os.path.join(port, "ColumnConfig.json")) == want
    assert any(c["columnType"] == "C" for c in want)
    assert any(c.get("sampleValues") for c in want)


@pytest.mark.parametrize("case", ["fused", "two_pass", "overflow",
                                  "small_chunks", "unweighted"])
def test_stats_matches_reference(model_set, tmp_path, case, monkeypatch):
    props = {}
    if case == "two_pass":
        props["shifu.stats.onePass"] = "false"
    if case == "overflow":      # 1 of 4 chunks stays resident, 3 overflow
        monkeypatch.setattr(jpp, "CHUNK_ROWS", 1000)
        monkeypatch.setattr(ppp, "CHUNK_ROWS", 1000)
        props["shifu.stats.fusedBudgetBytes"] = str(1000 * (5 * 4 + 8))
    if case == "small_chunks":
        monkeypatch.setattr(jpp, "CHUNK_ROWS", 700)
        monkeypatch.setattr(ppp, "CHUNK_ROWS", 700)
    if case == "unweighted":
        _edit(model_set, **{"dataSet.weightColumnName": None})
    assert JInit(model_set).run() == 0
    port = _port_copy(model_set, tmp_path)
    for env in (jenv, environment):
        for k, v in props.items():
            env.set_property(k, v)
    try:
        assert JStats(model_set, params={}).run() == 0
        assert StatsProcessor(port, device="cpu").run() == 0
    finally:
        jenv.reset_for_tests()
        environment.reset_for_tests()
    want = _json(os.path.join(model_set, "ColumnConfig.json"))
    got = _json(os.path.join(port, "ColumnConfig.json"))
    _assert_close(got, want)
    numeric = [c for c in got if c["columnBinning"].get("binBoundary")]
    assert len(numeric) >= 3
    phases = _json(os.path.join(port, "tmp", "profile.json"))["STATS"]
    assert set(phases["phases_s"]) >= (
        {"pass1_moments", "pass2_histograms"} if case == "two_pass"
        else {"fused_sweep"}) | {"setup", "finalize"}


def test_stats_through_the_cli_needs_the_device(model_set, tmp_path,
                                                monkeypatch):
    """``new → init → stats`` through the port's CLI; without CUDA
    ``stats`` raises unless ``--device cpu`` is given."""
    base = str(tmp_path / "cli")
    assert cli.main(["--dir", base, "new", "m"]) == 0
    mdir = os.path.join(base, "m")
    src = JModelConfig.load(os.path.join(model_set, "ModelConfig.json"))
    ds = src.dataSet
    _edit(mdir, **{"dataSet.dataPath": ds.dataPath,
                   "dataSet.dataDelimiter": "|",
                   "dataSet.targetColumnName": "tag",
                   "dataSet.posTags": ["bad"], "dataSet.negTags": ["good"]})
    assert cli.main(["--dir", mdir, "init"]) == 0
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--dir", mdir, "stats"])
    assert cli.main(["--dir", mdir, "stats", "--device", "cpu"]) == 0
    ccs = _json(os.path.join(mdir, "ColumnConfig.json"))
    assert all(c["columnStats"]["totalCount"] == 4000 for c in ccs
               if c.get("columnFlag") is None)


@pytest.mark.parametrize("what", ["psi", "munropat", "checkpoints",
                                  "filter"])
def test_stats_refuses_what_is_not_ported(model_set, tmp_path, what):
    """A filter expression is still refused naming its ROADMAP item; PSI,
    MunroPat and mid-sweep checkpoints are ported and now run, writing the
    reference's ColumnConfig.json (``tests/test_torch_stats_extra.py``
    holds each at length)."""
    edits = {"psi": {"stats.psiColumnName": "txn_id"},
             "munropat": {"stats.binningAlgorithm": "MunroPat"},
             "filter": {"dataSet.filterExpressions": "amount > 1"}
             }.get(what, {})
    _edit(model_set, **edits)
    assert JInit(model_set).run() == 0
    port = _port_copy(model_set, tmp_path)
    if what == "checkpoints":
        environment.set_property("shifu.stats.checkpointChunks", "2")
        jenv.set_property("shifu.stats.checkpointChunks", "2")
    try:
        if what == "filter":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                StatsProcessor(port, device="cpu").run()
            return
        assert JStats(model_set, params={}).run() == 0
        assert StatsProcessor(port, device="cpu").run() == 0
    finally:
        environment.reset_for_tests()
        jenv.reset_for_tests()
    _assert_close(_json(os.path.join(port, "ColumnConfig.json")),
                  _json(os.path.join(model_set, "ColumnConfig.json")))


@pytest.mark.parametrize("step,edit", [
    ("INIT", {"dataSet.dataPath": "no/such/file.csv"}),
    ("INIT", {"dataSet.headerPath": "no_header.txt"}),
    ("STATS", {"dataSet.metaColumnNameFile": "no_meta.txt"}),
    ("STATS", {"dataSet.posTags": ["a", "b"], "dataSet.negTags": []}),
    ("STATS", {"dataSet.targetColumnName": None}),
    ("INIT", {})])
def test_probe_rules_match_reference(model_set, step, edit):
    from shifu_tpu.config.validator import ModelStep as JStep
    from shifu_tpu.config.validator import probe as j_probe
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.validator import ModelStep, probe
    _edit(model_set, **edit)
    path = os.path.join(model_set, "ModelConfig.json")
    errors = []
    for load, prb, st in ((JModelConfig.load, j_probe, JStep[step]),
                          (ModelConfig.load, probe, ModelStep[step])):
        try:
            prb(load(path), st, model_set)
            errors.append(None)
        except ValueError as e:
            errors.append(e.problems)
    assert errors[1] == errors[0]
    assert (errors[0] is None) == (not edit)
