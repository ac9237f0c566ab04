"""Port parity for ``export`` and the model-spec layer:
``shifu_tpu_torch.pipeline.export``, ``export.pmml``,
``export.reference_spec`` and ``models.reference_import`` against
``shifu_tpu``'s over the SAME ``models/`` directory and
``ColumnConfig.json`` (the reference trained each model once on the
prepared fraud set; both packages read the other's npz model files), so a
difference can only come from the exporters.

- PMML (GBT, RF, NN, LR, with and without ``-c``, and the one-hot NN of
  ``tests/test_aux_steps.py:117``) is byte-equal to the reference's, and
  the port's PMML scored by ``tests/helpers/pmml_eval.py`` agrees with
  the port's native model at the tolerances of
  ``tests/test_pmml_roundtrip.py`` (2e-3 on all but 0.2% of rows, median
  under 5e-4: constants are printed with 6 decimals).
- ``export -t spec``: the ``.nn`` text is equal, the ``.gbt``/``.rf``
  gzip payloads are equal (the gzip header carries the time of writing).
- ``load_encog_nn`` and ``load_reference_tree`` give the reference's
  arrays on files the reference wrote, and ``RefTreeModel.compute``
  (float64 numpy in both) equals the reference's exactly; the re-read
  forest scores as the port's native forest within rtol 1e-5 / atol 1e-6
  on rows with every numeric present (the reference's own bound,
  ``tests/test_reference_export.py:113``).
- ``columnstats``, ``woemapping``, ``bagging`` and ``corr`` equal the
  reference's files; the WDL spec writer's payload equals
  ``tests/golden/wdl_model_golden.bin`` and reads back to the same
  arrays.
"""

import glob
import gzip
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))

pytestmark = pytest.mark.torch_port

PARAMS = {
    "GBT": {"TreeNum": 6, "MaxDepth": 3, "Loss": "log",
            "LearningRate": 0.1},
    "RF": {"TreeNum": 5, "MaxDepth": 3, "Impurity": "variance"},
    "NN": {"Propagation": "B", "LearningRate": 0.1, "NumHiddenNodes": [8],
           "ActivationFunc": ["tanh"]},
    "LR": {"LearningRate": 0.1},
}
EXT = {"GBT": "gbt", "RF": "rf", "NN": "nn", "LR": "lr"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory, _prepared_template):
    """One reference-trained set per algorithm, made on first use."""
    from pipeline import train_algorithm
    from shifu_tpu.config import ModelConfig
    sets = {}

    def get(alg):
        if alg not in sets:
            d = str(tmp_path_factory.mktemp(f"export_{alg}") / "set")
            shutil.copytree(_prepared_template, d)
            path = os.path.join(d, "ModelConfig.json")
            mc = ModelConfig.load(path)
            mc.train.numTrainEpochs = 10
            mc.save(path)
            train_algorithm(d, alg, PARAMS[alg])
            sets[alg] = d
        return sets[alg]
    return get


def _pair(src, root):
    dirs = []
    for who in ("ref", "port"):
        d = str(root / who)
        shutil.copytree(src, d)
        dirs.append(d)
    return dirs


def _export(ref, port, **params):
    from shifu_tpu.pipeline.export import ExportProcessor as JExport
    from shifu_tpu_torch.pipeline.export import ExportProcessor
    rc_ref = JExport(ref, params=dict(params)).run()
    rc_port = ExportProcessor(port, params=dict(params)).run()
    return rc_ref, rc_port


def _files(d, pattern):
    return sorted(glob.glob(os.path.join(d, "export", pattern)))


def _same_bytes(ref, port, pattern):
    want, got = _files(ref, pattern), _files(port, pattern)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and got
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


@pytest.mark.parametrize("concise", [False, True])
@pytest.mark.parametrize("alg", ["GBT", "RF", "NN", "LR"])
def test_pmml_is_byte_equal_to_the_reference(trained, tmp_path, alg,
                                             concise):
    ref, port = _pair(trained(alg), tmp_path)
    assert _export(ref, port, type="pmml", concise=concise) == (0, 0)
    _same_bytes(ref, port, "*.pmml")


def test_baggingpmml_and_positional_type_match(trained, tmp_path):
    """``baggingpmml`` is ``pmml`` in both packages, and the CLI's
    positional type reaches the same processor."""
    from shifu_tpu_torch.cli import main
    ref, port = _pair(trained("GBT"), tmp_path)
    assert _export(ref, port, type="baggingpmml") == (0, 0)
    _same_bytes(ref, port, "*.pmml")
    for f in _files(port, "*.pmml"):
        os.remove(f)
    assert main(["--dir", port, "export", "pmml", "-c"]) == 0
    for f in _files(ref, "*.pmml"):
        os.remove(f)
    from shifu_tpu.cli import main as jmain
    assert jmain(["--dir", ref, "export", "pmml", "-c"]) == 0
    _same_bytes(ref, port, "*.pmml")


def test_pmml_onehot_nn_is_byte_equal(_prepared_template, tmp_path):
    """ZSCALE_ONEHOT (the case of ``tests/test_aux_steps.py:117``): every
    categorical bin is an indicator field; ``txn_id`` is left out of the
    selection (it would expand into ~4,000 inputs).  The net carries
    random weights of the expanded width, saved by the port."""
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.config.model_config import NormType
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops.normalize import NormalizedColumn
    src = str(tmp_path / "src")
    shutil.copytree(_prepared_template, src)
    path = os.path.join(src, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.normalize.normType = NormType.ZSCALE_ONEHOT
    mc.save(path)
    cpath = os.path.join(src, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    for c in ccs:
        c["finalSelect"] = c.get("columnFlag") not in (
            "Target", "Weight", "Meta") and c["columnName"] != "txn_id"
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    cols = [c for c in load_column_configs(cpath)
            if c.finalSelect and c.is_candidate()]
    width = sum(NormalizedColumn(c, mc.normalize.normType,
                                 mc.normalize.stdDevCutOff).width
                for c in cols)
    assert width > len(cols)                  # some column expanded
    spec = nn_model.NNModelSpec(input_dim=width, hidden_nodes=[5],
                                activations=["tanh"])
    nn_model.save_model(os.path.join(src, "models", "model0.nn"), spec,
                        nn_model.init_params(prng.prng_key(7), spec))
    ref, port = _pair(src, tmp_path)
    for concise in (False, True):
        assert _export(ref, port, type="pmml", concise=concise) == (0, 0)
        _same_bytes(ref, port, "*.pmml")


def _rows_and_port_scores(d, model_file):
    """Raw row dicts and the port's native scores (CPU) of the set's
    first chunk, through the port's transform."""
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.data.transform import DatasetTransformer
    from shifu_tpu_torch.models import load_any
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    chunk = next(iter(DataSource(mc.dataSet.dataPath,
                                 mc.dataSet.dataDelimiter).iter_chunks()))
    tf = DatasetTransformer(mc, ccs)
    tc = tf.transform(chunk)
    model = load_any(os.path.join(d, "models", model_file))
    native = model.compute(tc.bins if model.input_kind == "bins" else tc.x,
                           device="cpu")[:, 0]
    cat = {cc.columnName for cc in ccs if cc.is_categorical()}
    rows = []
    for i in range(len(chunk)):
        row = {}
        for nc in tf.norm_cols:
            name = nc.cc.columnName
            v = str(chunk.col(name)[i]).strip()
            row[name] = v if name in cat else (
                float(v) if v not in ("", "NA", "nan") else None)
        rows.append(row)
    return rows, native


@pytest.mark.parametrize("alg", ["GBT", "RF", "NN", "LR"])
def test_port_pmml_scores_as_the_port_model(trained, tmp_path, alg):
    from pmml_eval import PmmlEvaluator
    from shifu_tpu_torch.pipeline.export import ExportProcessor
    d = str(tmp_path / "port")
    shutil.copytree(trained(alg), d)
    assert ExportProcessor(d, params={"type": "pmml"}).run() == 0
    (pmml,) = _files(d, "*.pmml")
    rows, native = _rows_and_port_scores(d, f"model0.{EXT[alg]}")
    ev = PmmlEvaluator(pmml)
    diff = np.abs(np.array([ev.score(r) for r in rows]) - native)
    assert float((diff > 2e-3).mean()) <= 0.002, diff.max()
    assert float(np.median(diff)) < 5e-4


@pytest.mark.parametrize("alg", ["GBT", "RF", "NN"])
def test_spec_payloads_equal_the_reference(trained, tmp_path, alg):
    ref, port = _pair(trained(alg), tmp_path)
    assert _export(ref, port, type="spec") == (0, 0)
    want, got = (_files(d, "reference/*") for d in (ref, port))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and got
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            pa, pb = fa.read(), fb.read()
        if alg != "NN":
            pa, pb = gzip.decompress(pa), gzip.decompress(pb)
        assert pa == pb, a


def _raw_by_column(d, column_nums):
    """(bins, raw values by columnNum, rows with a missing numeric) of the
    training CSV through the port's transform — the reference format
    reads raw values, categorical columns as category indices."""
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.data.transform import DatasetTransformer
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    (chunk,) = list(DataSource(mc.dataSet.dataPath,
                               mc.dataSet.dataDelimiter).iter_chunks())
    tc = DatasetTransformer(mc, ccs).transform(chunk)
    by_num = {cc.columnNum: cc for cc in ccs}
    raw, missing = {}, np.zeros(tc.n, bool)
    for j, num in enumerate(column_nums):
        cc = by_num[num]
        if cc.is_categorical():
            raw[num] = tc.bins[:, j].astype(np.float64)
        else:
            v = np.array([float(x) if str(x).strip() not in ("", "NA")
                          else np.nan for x in chunk.col(cc.columnName)])
            raw[num] = v
            missing |= ~np.isfinite(v)
    return tc.bins, raw, missing


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_reference_trees_reimport_equal(trained, tmp_path, alg):
    """The port's ``load_reference_tree`` on the reference's file: the
    same structure and the same float64 scores, bit for bit; and the
    re-read forest scores as the native one (link applied for GBT)."""
    from shifu_tpu.models.reference_import import \
        load_reference_tree as j_load
    from shifu_tpu_torch.models.reference_import import load_reference_tree
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    ref, port = _pair(trained(alg), tmp_path)
    assert _export(ref, port, type="spec") == (0, 0)
    path = os.path.join(ref, "export", "reference", f"model0.{EXT[alg]}")
    got, want = load_reference_tree(path), j_load(path)
    for k in ("version", "algorithm", "loss", "input_count",
              "mean_by_column", "name_by_column", "categories_by_column",
              "column_mapping", "bag_weights"):
        assert getattr(got, k) == getattr(want, k), k
    native = IndependentTreeModel.load(
        os.path.join(port, "models", f"model0.{EXT[alg]}"))
    bins, raw, missing = _raw_by_column(port, native.spec.column_nums)
    scores = got.compute(raw)
    np.testing.assert_array_equal(scores, want.compute(raw))
    ours = native.compute(bins, device="cpu")[:, 0]
    if alg == "GBT":
        scores = 1.0 / (1.0 + np.exp(-scores))
    ok = ~missing
    assert ok.sum() > 1000
    np.testing.assert_allclose(ours[ok], scores[ok], rtol=1e-5, atol=1e-6)


def test_reference_encog_nn_reimports_equal(trained, tmp_path):
    from shifu_tpu.models.reference_import import load_encog_nn as j_load
    from shifu_tpu_torch.models.nn import IndependentNNModel, load_model
    from shifu_tpu_torch.models.reference_import import load_encog_nn
    ref, port = _pair(trained("NN"), tmp_path)
    assert _export(ref, port, type="spec") == (0, 0)
    path = os.path.join(ref, "export", "reference", "model0.nn")
    (spec, params), (jspec, jparams) = load_encog_nn(path), j_load(path)
    for k in ("input_dim", "hidden_nodes", "activations", "output_dim",
              "output_activation", "extra"):
        assert getattr(spec, k) == getattr(jspec, k), k
    for a, b in zip(params, jparams):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    x = np.random.default_rng(0).normal(size=(256, spec.input_dim)) \
        .astype(np.float32)
    native = IndependentNNModel(*load_model(
        os.path.join(port, "models", "model0.nn")))
    np.testing.assert_allclose(
        IndependentNNModel(spec, params).compute(x, device="cpu"),
        native.compute(x, device="cpu"), rtol=1e-6, atol=1e-7)


def test_columnstats_woe_bagging_and_corr_match(trained, tmp_path):
    ref, port = _pair(trained("GBT"), tmp_path)
    for t in ("columnstats", "woemapping", "woe", "bagging"):
        assert _export(ref, port, type=t) == (0, 0), t
    _same_bytes(ref, port, "*.csv")
    _same_bytes(ref, port, "bagging/*")
    # corr copies `stats -correlation`'s matrix, which only the
    # reference's stats writes: without it both fail alike
    assert _export(ref, port, type="corr") == (1, 1)
    for d in (ref, port):
        with open(os.path.join(d, "correlation.csv"), "w") as f:
            f.write(",a,b\na,1.0,0.25\nb,0.25,1.0\n")
    assert _export(ref, port, type="corr") == (0, 0)
    _same_bytes(ref, port, "correlation.csv")
    assert _export(ref, port, type="nosuch") == (1, 1)


def test_wdl_specs_raise_naming_item_10(tmp_path):
    """Once a refusal (the WDL spec format was ROADMAP item 10), now the
    format's round trip: ``tests/test_wdl_golden.py``'s model, built in
    the port, writes the checked-in bytes and reads back to its arrays."""
    from test_torch_wdl import _golden
    from test_wdl_golden import GOLDEN
    from shifu_tpu_torch.export.reference_spec import write_reference_wdl
    from shifu_tpu_torch.models.reference_import import load_reference_wdl
    spec, params, ccs = _golden()
    path = str(tmp_path / "model0.wdl")
    write_reference_wdl(path, spec, params, ccs)
    with open(path, "rb") as f:
        payload = gzip.decompress(f.read())
    with open(GOLDEN, "rb") as f:
        assert payload == f.read()
    spec2, params2, stats = load_reference_wdl(path)
    assert (spec2.numeric_dim, spec2.cat_cardinalities, spec2.embed_dim,
            spec2.hidden_nodes, spec2.column_nums, spec2.cat_column_nums) \
        == (2, [3, 2], 2, [3], [1, 2], [5, 6])
    assert sorted(stats) == [1, 2, 5, 6]
    for k in ("embed", "wide_cat", "wide_num", "bias"):
        assert torch.equal(params2[k], params[k]), k
    for a, b in zip(params2["deep"], params["deep"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
