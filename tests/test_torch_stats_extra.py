"""Port parity for the rest of ``stats`` and for ``new -t/-m``:
``shifu_tpu_torch`` (on the CPU) against ``shifu_tpu`` on the
``model_set`` fixture.

- ``new -t <alg> -m <text>`` writes the reference's ModelConfig.json for
  every algorithm.
- ``stats -correlation`` on the mixed set (its own pass, categoricals
  by pos rate), a numeric-only set (the fused sweep's piggyback) and the
  two-pass sweep: cells of two numeric columns agree with the reference's
  within rtol 1e-5 / atol 1e-6.  The port sums pairs in float64 and the
  reference in f32, which keeps about three digits of a categorical
  column's variance (its pos rates near 0.1 are shifted by 0.5), so a cell
  with a categorical column agrees within atol 1e-3 (the reference's own
  error on this fixture is 3.7e-4), and every cell of the port's matrix
  is within 1e-6 of pandas' exact Pearson over the same encodings (the
  file's 6 decimals).  ``export corr`` copies the matrix byte for byte in
  both packages.
- PSI (``psiColumnName``, ``-psi``): ``psi`` within rtol 1e-6 and
  ``unitStats`` with the same units in the same order.
- ``-rebin`` (``-Dshifu.rebin.maxNumBin``, ``-vars``, ``-ivr``, ``-bic``):
  bin boundaries, categories and counts equal; floats as in
  ``tests/test_torch_stats.py`` (rtol 1e-5 + 1e-6).
- MunroPat / MunroPatI: boundaries exactly equal (true data quantiles of
  float64 values), and every boundary a data value.
- ``shifu.stats.checkpointChunks``: a run interrupted at ``stats:chunk``
  and resumed writes the same ColumnConfig.json bytes as an uninterrupted
  checkpointing run, and the reference's values at the stated tolerance.
"""

import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu import cli as j_cli
from shifu_tpu import faults as j_faults
from shifu_tpu.config import environment as jenv
from shifu_tpu.data.reader import DataSource as JDataSource
from shifu_tpu.pipeline.create import InitProcessor as JInit
from shifu_tpu.pipeline.stats import StatsProcessor as JStats
from shifu_tpu_torch import cli, faults
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.data.reader import DataSource
from shifu_tpu_torch.pipeline.stats import StatsProcessor

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean():
    for env, f in ((environment, faults), (jenv, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()
    yield
    for env, f in ((environment, faults), (jenv, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()


def _json(path):
    with open(path) as f:
        return json.load(f)


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


def _both_props(**props):
    for env in (environment, jenv):
        for k, v in props.items():
            env.set_property(k, str(v))


def _assert_close(got, want, where="", rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}", rtol, atol)
    elif isinstance(want, list) and not where.endswith(".binBoundary"):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]", rtol, atol)
    elif isinstance(want, float) and isinstance(got, float):
        assert got == want or abs(got - want) <= rtol * abs(want) + atol, \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def _pair(model_set, tmp_path, **edits):
    """The reference's set after ``init`` and a copy of it for the port."""
    if edits:
        _edit(model_set, **edits)
    assert JInit(model_set).run() == 0
    port = str(tmp_path / "port" / "fraudtest")
    shutil.copytree(model_set, port)
    return model_set, port


def _ccs(mdir):
    return _json(os.path.join(mdir, "ColumnConfig.json"))


def _matrix(path):
    with open(path) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    names = rows[0][1:]
    assert [r[0] for r in rows[1:]] == names
    return names, np.array([[float(v) for v in r[1:]] for r in rows[1:]])


# --------------------------------------------------------------- new -t -m
@pytest.mark.parametrize("alg", ["NN", "LR", "GBT", "RF", "DT", "WDL",
                                 "SVM"])
def test_new_with_algorithm_and_description_writes_the_reference_config(
        tmp_path, alg):
    args = ["new", "-t", alg, "-m", f"a {alg} model set", "m"]
    assert j_cli.main(["--dir", str(tmp_path / "ref")] + args) == 0
    assert cli.main(["--dir", str(tmp_path / "port")] + args) == 0
    got = _json(str(tmp_path / "port" / "m" / "ModelConfig.json"))
    want = _json(str(tmp_path / "ref" / "m" / "ModelConfig.json"))
    assert got == want
    assert got["train"]["algorithm"] == alg
    assert got["basic"]["description"] == f"a {alg} model set"


# ------------------------------------------------------------- correlation
def _numeric_only(mdir):
    """Mark the categorical columns meta, so only numerics are
    candidates."""
    path = os.path.join(mdir, "ColumnConfig.json")
    ccs = _json(path)
    for c in ccs:
        if c["columnType"] == "C" and c.get("columnFlag") is None:
            c["columnFlag"] = "Meta"
    with open(path, "w") as f:
        json.dump(ccs, f, indent=2)


@pytest.mark.parametrize("case", ["mixed", "numeric_only", "two_pass"])
def test_correlation_matches_reference(model_set, tmp_path, case):
    ref, port = _pair(model_set, tmp_path)
    if case != "mixed":
        _numeric_only(ref)
        _numeric_only(port)
    if case == "two_pass":
        _both_props(**{"shifu.stats.onePass": "false"})
    assert JStats(ref, params={"correlation": True}).run() == 0
    assert cli.main(["--dir", port, "stats", "-correlation",
                     "--device", "cpu"]) == 0
    names, got = _matrix(os.path.join(port, "correlation.csv"))
    jnames, want = _matrix(os.path.join(ref, "correlation.csv"))
    assert names == jnames
    ccs = {c["columnName"]: c for c in _ccs(port)}
    cat = np.array([ccs[n]["columnType"] == "C" for n in names])
    assert cat.any() == (case == "mixed")
    num2 = ~cat[:, None] & ~cat[None, :]
    np.testing.assert_allclose(got[num2], want[num2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[~num2], want[~num2], atol=1e-3)
    np.testing.assert_allclose(np.diag(got), 1.0)
    np.testing.assert_allclose(got, got.T, atol=1e-6)
    # pairwise complete (amount has missing cells: each pair counts only
    # the rows where both are valid), categoricals by their pos rate:
    # pandas' exact Pearson over the same encodings
    import pandas as pd
    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(port, "ModelConfig.json"))
    raw = pd.read_csv(mc.dataSet.dataPath, sep="|", dtype=str,
                      keep_default_na=False)
    enc = {}
    for n, is_cat in zip(names, cat):
        if is_cat:
            bn = ccs[n]["columnBinning"]
            enc[n] = raw[n].str.strip().map(
                dict(zip(bn["binCategory"], bn["binPosRate"]))
            ).astype(float)
        else:
            enc[n] = pd.to_numeric(raw[n], errors="coerce")
    exact = pd.DataFrame(enc)[names].corr().to_numpy()
    np.testing.assert_allclose(got, exact, atol=ATOL)
    # the stats themselves still match
    _assert_close(_ccs(port), _ccs(ref))
    # export corr copies the matrix, byte for byte, in both packages
    from shifu_tpu.pipeline.export import ExportProcessor as JExport
    from shifu_tpu_torch.pipeline.export import ExportProcessor
    assert cli.main(["--dir", port, "export", "corr"]) == 0
    assert JExport(ref, params={"type": "corr"}).run() == 0
    for d in (ref, port):
        with open(os.path.join(d, "export", "correlation.csv"), "rb") as f:
            exported = f.read()
        with open(os.path.join(d, "correlation.csv"), "rb") as f:
            assert exported == f.read()
    shutil.copy(os.path.join(ref, "correlation.csv"),
                os.path.join(port, "correlation.csv"))
    assert ExportProcessor(port, params={"type": "corr"}).run() == 0
    with open(os.path.join(port, "export", "correlation.csv"), "rb") as a, \
            open(os.path.join(ref, "export", "correlation.csv"), "rb") as b:
        assert a.read() == b.read()


def test_correlation_accumulator_matches_reference(rng):
    from shifu_tpu.ops.correlation import CorrelationAccumulator as JAcc
    from shifu_tpu_torch.ops.correlation import CorrelationAccumulator
    x = rng.normal(3.0, 2.0, size=(5000, 6))
    x[:, 1] = 0.7 * x[:, 0] + 0.3 * x[:, 1]
    x[:, 5] = 7.0                             # zero variance -> NaN
    valid = rng.random(x.shape) > 0.1
    off = x.mean(axis=0)
    a, b = CorrelationAccumulator(6, offset=off), JAcc(6, offset=off)
    for s in range(0, 5000, 1700):
        a.update(x[s:s + 1700], valid[s:s + 1700])
        b.update(x[s:s + 1700], valid[s:s + 1700])
    np.testing.assert_array_equal(a.n, b.n)
    got, want = a.finalize(), b.finalize()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ok = valid[:, :5]
    for i in range(5):
        for j in range(i + 1, 5):
            both = ok[:, i] & ok[:, j]
            exact = np.corrcoef(x[both, i], x[both, j])[0, 1]
            np.testing.assert_allclose(got[i, j], exact, rtol=1e-12)


# --------------------------------------------------------------------- PSI
@pytest.mark.parametrize("unit_col,flag", [("channel", False),
                                           ("country", True)])
def test_psi_matches_reference(model_set, tmp_path, unit_col, flag):
    ref, port = _pair(model_set, tmp_path,
                      **{"stats.psiColumnName": unit_col})
    assert JStats(ref, params={"psi": flag}).run() == 0
    args = ["--dir", port, "stats", "--device", "cpu"] + \
        (["-psi"] if flag else [])
    assert cli.main(args) == 0
    got, want = _ccs(port), _ccs(ref)
    n = 0
    for g, w in zip(got, want):
        gs, ws = g["columnStats"], w["columnStats"]
        assert (gs["psi"] is None) == (ws["psi"] is None)
        if ws["psi"] is None:
            continue
        n += 1
        np.testing.assert_allclose(gs["psi"], ws["psi"], rtol=1e-6)
        gu = [u.rsplit(":", 1) for u in gs["unitStats"]]
        wu = [u.rsplit(":", 1) for u in ws["unitStats"]]
        assert [u for u, _ in gu] == [u for u, _ in wu]
        np.testing.assert_allclose([float(v) for _, v in gu],
                                   [float(v) for _, v in wu], rtol=1e-6,
                                   atol=1e-6)
    assert n >= 4
    _assert_close(got, want)


def test_pos_rate_and_psi_match_reference():
    from shifu_tpu.ops.stats_math import pos_rate as j_pos_rate
    from shifu_tpu.ops.stats_math import psi as j_psi
    from shifu_tpu_torch.ops.stats_math import pos_rate, psi
    pr = pos_rate(np.array([1.0, 0.0]), np.array([3.0, 0.0]))
    assert pr[0] == 0.25 and np.isnan(pr[1])
    jpr = j_pos_rate(np.array([1.0, 0.0]), np.array([3.0, 0.0]))
    assert pr[0] == jpr[0] and np.isnan(jpr[1])
    for e, a in (([50, 50.0], [50, 50.0]), ([90, 10.0], [10, 90.0]),
                 ([5, 0.0, 3], [1, 4.0, 0])):
        assert psi(np.array(e), np.array(a)) == \
            j_psi(np.array(e), np.array(a))
    assert psi(np.array([50, 50.0]), np.array([50, 50.0])) < 1e-12
    assert psi(np.array([90, 10.0]), np.array([10, 90.0])) > 1.0


# ------------------------------------------------------------------- rebin
@pytest.mark.parametrize("how", ["property", "cli_flags"])
def test_rebin_matches_reference(model_set, tmp_path, how):
    ref, port = _pair(model_set, tmp_path)
    assert JStats(ref, params={}).run() == 0
    assert StatsProcessor(port, device="cpu").run() == 0
    before = {c["columnName"]: len(c["columnBinning"]["binCountNeg"] or [])
              for c in _ccs(port)}
    if how == "property":
        _both_props(**{"shifu.rebin.maxNumBin": 4})
        jparams = {"rebin": True}
        argv = ["-rebin"]
    else:
        jparams = {"rebin": True, "rebin_vars": "amount,country",
                   "rebin_ivr": 0.9, "rebin_bic": 50}
        argv = ["-rebin", "-vars", "amount,country", "-ivr", "0.9",
                "-bic", "50"]
    assert JStats(ref, params=jparams).run() == 0
    assert cli.main(["--dir", port, "stats", "--device", "cpu"]
                    + argv) == 0
    got, want = _ccs(port), _ccs(ref)
    _assert_close(got, want)
    shrunk = [c["columnName"] for c in got
              if c["columnBinning"]["binCountNeg"]
              and len(c["columnBinning"]["binCountNeg"])
              < before[c["columnName"]]]
    assert shrunk
    if how == "cli_flags":
        assert set(shrunk) <= {"amount", "country"}
    for c in got:
        bn = c["columnBinning"]
        if bn["binCountNeg"]:
            n = len(bn["binBoundary"] or bn["binCategory"])
            assert len(bn["binCountNeg"]) == n + 1
            assert len(bn["binCountWoe"]) == n + 1


def test_rebinned_pipeline_still_trains(model_set, tmp_path):
    _, port = _pair(model_set, tmp_path)
    for argv in (["stats", "-rebin", "--device", "cpu"], ["norm"],
                 ["train", "--device", "cpu"]):
        assert cli.main(["--dir", port] + argv) == 0
    assert os.path.isfile(os.path.join(port, "models", "model0.nn"))


# ---------------------------------------------------------------- MunroPat
@pytest.mark.parametrize("alg,method", [("MunroPat", "EqualTotal"),
                                        ("MunroPatI", "EqualPositive"),
                                        ("MunroPat", "WeightEqualTotal")])
def test_munropat_exact_boundaries_match_reference(model_set, tmp_path,
                                                   alg, method):
    ref, port = _pair(model_set, tmp_path, **{
        "stats.binningAlgorithm": alg, "stats.binningMethod": method,
        "stats.maxNumBin": 8})
    assert JStats(ref, params={}).run() == 0
    assert cli.main(["--dir", port, "stats", "--device", "cpu"]) == 0
    got, want = _ccs(port), _ccs(ref)
    _assert_close(got, want)
    amount = next(c for c in got if c["columnName"] == "amount")
    assert amount["columnBinning"]["binningAlgorithm"] == alg
    import pandas as pd
    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(port, "ModelConfig.json"))
    df = pd.read_csv(mc.dataSet.dataPath, sep="|")
    vals = set(np.round(pd.to_numeric(df["amount"], errors="coerce")
                        .dropna().to_numpy(), 9))
    for b in amount["columnBinning"]["binBoundary"][1:]:
        assert np.round(b, 9) in vals, b
    phases = _json(os.path.join(port, "tmp", "profile.json"))["STATS"]
    assert {"pass1_moments", "pass2_histograms"} <= set(phases["phases_s"])


# ---------------------------------------------------- mid-sweep checkpoints
def test_stats_checkpoint_resume_matches_uninterrupted(model_set, tmp_path,
                                                       monkeypatch):
    ref, port = _pair(model_set, tmp_path)
    control = port + "_ctl"
    shutil.copytree(port, control)
    for cls in (DataSource, JDataSource):
        orig = cls.iter_chunks
        monkeypatch.setattr(
            cls, "iter_chunks",
            lambda self, chunk_rows=500, _o=orig: _o(self, 500))
    _both_props(**{"shifu.stats.checkpointChunks": 3})
    assert JStats(ref, params={}).run() == 0
    assert StatsProcessor(control, device="cpu").run() == 0

    environment.set_property("shifu.faults", "stats:chunk=5:ioerror")
    faults.reset_for_tests()
    with pytest.raises(faults.InjectedFault):
        StatsProcessor(port, device="cpu").run()
    partial = os.path.join(port, "tmp", "stats", "partial_sweep.npz")
    assert os.path.isfile(partial)         # the chunk-3 checkpoint landed
    environment.set_property("shifu.faults", "")
    faults.reset_for_tests()
    assert StatsProcessor(port, device="cpu").run() == 0
    assert not os.path.isfile(partial)     # a committed run drops it
    with open(os.path.join(port, "ColumnConfig.json")) as f:
        resumed = f.read()
    with open(os.path.join(control, "ColumnConfig.json")) as f:
        assert resumed == f.read()
    _assert_close(json.loads(resumed), _ccs(ref))
