"""Port parity for the ``norm`` step: ``NormalizeProcessor`` of
``shifu_tpu`` and of ``shifu_tpu_torch`` on two copies of the prepared
fraud model set (the reference has run ``init → stats → norm`` there), on
the same ``ColumnConfig.json``.

Both transforms are the same numpy float64 code over the same parsed
arrays, so the tolerance is zero throughout: the clean wire plane
(``bins``, ``y``, ``w`` and its manifest) is byte-equal, every
``NormalizedData`` npz array is equal element for element (the npz files
themselves carry zip timestamps), and both ``schema.json`` files are equal
field for field.  Cases: eight norm types, sampling with ``sampleNegOnly``,
``-shuffle`` (npz clean plane), a torn run resumed from its journal, the
step's CLI, and the port's ``train`` on the port's plane against the same
``train`` on the reference's plane; the ``DatasetTransformer`` alone for
every norm type, and the planes read back through the port's ``Shards``
(the reference's ``test_norm_step_end_to_end``).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.config.model_config import NormType

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))

pytestmark = pytest.mark.torch_port

WIRE = os.path.join("tmp", "CleanedData", ".spill_cache", "spill-bins-y-w")
NORM_TYPES = ("ZSCALE", "WOE", "WEIGHT_WOE_ZSCORE", "HYBRID",
              "ZSCALE_ONEHOT", "ZSCALE_INDEX", "ASIS_PR", "DISCRETE_ZSCORE")


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _pair(template, root, **normalize):
    """Two copies of ``template`` with ``normalize`` fields set: (ref, port)."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import NormType
    dirs = []
    for name in ("ref", "port"):
        d = str(root / name)
        shutil.copytree(template, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        for k, v in normalize.items():
            setattr(mc.normalize, k, NormType[v] if k == "normType" else v)
        mc.save(path)
        dirs.append(d)
    return dirs


def _norm_ref(d, **params):
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    assert NormalizeProcessor(d, params=params).run() == 0


def _norm_port(d, **params):
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    assert NormalizeProcessor(d, params=params).run() == 0


def _npz_arrays(d, sub):
    out = {}
    for f in sorted(os.listdir(os.path.join(d, "tmp", sub))):
        if f.endswith(".npz"):
            with np.load(os.path.join(d, "tmp", sub, f)) as z:
                out[f] = {k: z[k].copy() for k in z}
    return out


def _schema(d, sub):
    with open(os.path.join(d, "tmp", sub, "schema.json")) as f:
        return json.load(f)


def _assert_same_planes(ref, port, wire=True):
    """Wire plane byte-equal (or npz clean shards equal), NormalizedData
    arrays equal with their dtypes, both schemas equal field for field."""
    for sub in ("NormalizedData", "CleanedData"):
        assert _schema(port, sub) == _schema(ref, sub), sub
        a, b = _npz_arrays(ref, sub), _npz_arrays(port, sub)
        assert a.keys() == b.keys(), sub
        for f in a:
            assert a[f].keys() == b[f].keys(), f
            for k in a[f]:
                assert b[f][k].dtype == a[f][k].dtype, (sub, f, k)
                np.testing.assert_array_equal(b[f][k], a[f][k],
                                              err_msg=f"{sub}/{f}/{k}")
    assert bool(_npz_arrays(ref, "CleanedData")) != wire
    if wire:
        names = sorted(os.listdir(os.path.join(ref, WIRE)))
        assert names == ["bins.raw", "manifest.json", "w.raw", "y.raw"]
        assert sorted(os.listdir(os.path.join(port, WIRE))) == names
        for f in names:
            with open(os.path.join(ref, WIRE, f), "rb") as g:
                want = g.read()
            with open(os.path.join(port, WIRE, f), "rb") as g:
                assert g.read() == want, f


@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_norm_planes_equal_the_reference(prepared_set, tmp_path, norm_type):
    ref, port = _pair(prepared_set, tmp_path, normType=norm_type)
    _norm_ref(ref)
    _norm_port(port)
    _assert_same_planes(ref, port)
    schema = _schema(port, "NormalizedData")
    assert schema["normType"] == norm_type
    assert schema["numRows"] > 3500 and schema["binsDtype"] == "uint16"
    with open(os.path.join(port, "tmp", "journal", "NORMALIZE.json")) as f:
        assert json.load(f)["status"] == "complete"


def test_sampling_with_neg_only_equals_the_reference(prepared_set,
                                                     tmp_path):
    ref, port = _pair(prepared_set, tmp_path, sampleRate=0.5,
                      sampleNegOnly=True)
    _norm_ref(ref)
    _norm_port(port)
    _assert_same_planes(ref, port)
    y = _npz_arrays(port, "NormalizedData")["part-00000.npz"]["y"]
    full = _npz_arrays(prepared_set, "NormalizedData")["part-00000.npz"]["y"]
    # every positive kept, about half of the negatives
    assert (y == 1).sum() == (full == 1).sum()
    assert 0.4 < (y == 0).sum() / (full == 0).sum() < 0.6


def test_shuffle_equals_the_reference(prepared_set, tmp_path):
    ref, port = _pair(prepared_set, tmp_path)
    _norm_ref(ref, shuffle=True)
    _norm_port(port, shuffle=True)
    _assert_same_planes(ref, port, wire=False)
    unshuffled = _npz_arrays(prepared_set, "NormalizedData")
    got = _npz_arrays(port, "NormalizedData")
    assert not np.array_equal(got["part-00000.npz"]["y"],
                              unshuffled["part-00000.npz"]["y"])


def _small_geometry(monkeypatch, chunk_rows=500, shard_rows=600):
    """Chunks of 500 rows and shards of 600 on both sides, so the
    4,000-row fixture gives several shards (shards flush on chunk
    boundaries once the buffer passes SHARD_ROWS)."""
    for pkg in ("shifu_tpu", "shifu_tpu_torch"):
        monkeypatch.setattr(f"{pkg}.data.parsepool.CHUNK_ROWS", chunk_rows)
        monkeypatch.setattr(f"{pkg}.pipeline.norm.SHARD_ROWS", shard_rows)


def test_torn_run_resumes_to_the_reference_bytes(prepared_set, tmp_path,
                                                 monkeypatch):
    """A run that dies at shard 2's wire append (after its npz landed),
    with torn tail bytes past the last committed wire manifest, resumes
    from the journal: the committed prefix is kept (not rewritten), the
    tail is truncated and re-lands, and the result equals an uninterrupted
    reference run byte for byte."""
    from shifu_tpu_torch.data.spill import WireWriter
    ref, port = _pair(prepared_set, tmp_path)
    _small_geometry(monkeypatch)
    _norm_ref(ref)

    real_append = WireWriter.append

    def dying_append(self, part):
        if self.n_shards == 2:
            raise OSError("disk went away")
        real_append(self, part)

    monkeypatch.setattr(WireWriter, "append", dying_append)
    with pytest.raises(OSError, match="disk went away"):
        _norm_port(port)
    monkeypatch.setattr(WireWriter, "append", real_append)
    with open(os.path.join(port, "tmp", "journal", "NORMALIZE.json")) as f:
        doc = json.load(f)
    assert doc["status"] == "running"
    assert sorted(doc["items"]) == ["shard-00000", "shard-00001"]
    with open(os.path.join(port, WIRE, "y.raw"), "ab") as f:
        f.write(b"\xff" * 12)                # a mid-append crash's tail
    part0 = os.path.join(port, "tmp", "NormalizedData", "part-00000.npz")
    mtime0 = os.stat(part0).st_mtime_ns

    _norm_port(port)
    assert os.stat(part0).st_mtime_ns == mtime0
    n_shards = len(_npz_arrays(ref, "NormalizedData"))
    assert n_shards > 3                      # shards past the torn one
    _assert_same_planes(ref, port)
    with open(os.path.join(port, "tmp", "journal", "NORMALIZE.json")) as f:
        doc = json.load(f)
    assert doc["status"] == "complete" and len(doc["items"]) == n_shards


def test_norm_cli_and_train_precondition(prepared_set, tmp_path):
    """``norm`` through the port's CLI writes the reference's planes, and
    the port's ``train`` refuses a plane whose norm run is torn."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config.errors import ShifuError
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    ref, port = _pair(prepared_set, tmp_path)
    _norm_ref(ref)
    assert cli.main(["--dir", port, "norm"]) == 0
    _assert_same_planes(ref, port)
    jpath = os.path.join(port, "tmp", "journal", "NORMALIZE.json")
    with open(jpath) as f:
        doc = json.load(f)
    doc["status"] = "running"
    with open(jpath, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ShifuError, match="did not complete"):
        TrainProcessor(port, device="cpu").run()


def test_train_on_the_port_plane_grows_the_reference_forest(prepared_set,
                                                            tmp_path):
    """The port's ``train`` (GBT, MinInfoGain 1e-3: above the f32 noise
    splits of ROADMAP C9) grows the same forest from the port's plane as
    from the reference's, and the same as the reference's ``train``."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor as JTrain
    from shifu_tpu_torch.models.tree import load_model
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    ref, port = _pair(prepared_set, tmp_path)
    _norm_port(port)
    for d in (ref, port):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.GBT
        mc.train.params = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                           "LearningRate": 0.1, "MinInfoGain": 1e-3}
        mc.save(path)
    ref_j = str(tmp_path / "ref_j")
    shutil.copytree(ref, ref_j)
    assert TrainProcessor(port, device="cpu").run() == 0
    assert TrainProcessor(ref, device="cpu").run() == 0
    assert JTrain(ref_j, params={}).run() == 0
    _, got = load_model(os.path.join(port, "models", "model0.gbt"))
    for other in (ref, ref_j):
        _, want = load_model(os.path.join(other, "models", "model0.gbt"))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.split_feat, w.split_feat)
            np.testing.assert_array_equal(g.left_mask, w.left_mask)
            np.testing.assert_allclose(g.leaf_value, w.leaf_value,
                                       rtol=1e-5, atol=1e-6)


def test_norm_with_telemetry_writes_the_reference_drift_table(
        prepared_set, tmp_path):
    """With telemetry on, norm's streaming drift monitor writes
    ``telemetry/drift.json``: per-column PSI of this run's bins against
    the ColumnConfig snapshot, within 1e-6 of the reference's, and the
    trace counts the same ``norm.rows``."""
    from shifu_tpu import obs as jobs
    from shifu_tpu.pipeline.norm import NormalizeProcessor as JNorm
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    from torch_port import shifted_source
    dirs = []
    for name in ("ref", "port"):
        dirs.append(str(tmp_path / name))
        shutil.copytree(prepared_set, dirs[-1])
        rows = shifted_source(dirs[-1], str(tmp_path / "src"))
    try:
        jobs.set_enabled(True)
        assert JNorm(dirs[0], params={}).run() == 0
        obs.set_enabled(True)
        assert NormalizeProcessor(dirs[1]).run() == 0
    finally:
        jobs.reset_for_tests()
        obs.reset_for_tests()
    docs, counted = [], []
    for d in dirs:
        with open(os.path.join(d, "telemetry", "drift.json")) as f:
            docs.append(json.load(f))
        with open(os.path.join(d, "telemetry", "trace.jsonl")) as f:
            counted.append([json.loads(ln).get("value") for ln in f
                            if '"norm.rows"' in ln])
    ref, port = docs
    assert port["rows"] == ref["rows"] == rows
    assert port["flagged"] == ref["flagged"]
    assert port["columns"].keys() == ref["columns"].keys()
    assert max(ref["columns"].values()) > 0.01
    for col, v in ref["columns"].items():
        assert abs(port["columns"][col] - v) <= 1e-6, col
    assert counted[0] == counted[1] == [float(rows)]


@pytest.fixture(scope="module")
def fraud_chunks(_prepared_template):
    """Each package's configs and extracted chunks of the prepared set."""
    from shifu_tpu.config import ModelConfig as JModelConfig
    from shifu_tpu.config import load_column_configs as j_load
    from shifu_tpu.data import DataSource as JDataSource
    from shifu_tpu.data.extract import ChunkExtractor as JExtractor
    from shifu_tpu.data.parsepool import iter_extracted as j_iter
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.data.extract import ChunkExtractor
    from shifu_tpu_torch.data.parsepool import iter_extracted
    from shifu_tpu_torch.data.reader import DataSource
    d = _prepared_template
    out = []
    for mcls, load, src, ext, it in (
            (JModelConfig, j_load, JDataSource, JExtractor, j_iter),
            (ModelConfig, load_column_configs, DataSource, ChunkExtractor,
             iter_extracted)):
        mc = mcls.load(os.path.join(d, "ModelConfig.json"))
        ccs = load(os.path.join(d, "ColumnConfig.json"))
        ex = ext(mc, ccs)
        chunks = [c for _, c in it(src(mc.dataSet.dataPath, "|"), ex)]
        out.append((mc, ccs, chunks))
    return out


@pytest.mark.parametrize("norm_type", [t.name for t in NormType])
def test_transformer_equals_the_reference_for_every_norm_type(fraud_chunks,
                                                              norm_type):
    """``DatasetTransformer`` on the same parsed chunk, every norm type of
    ``ModelNormalizeConf``: x, bins, target and weight equal, names equal."""
    from shifu_tpu.config.model_config import NormType as JNormType
    from shifu_tpu.data.transform import DatasetTransformer as JTransformer
    from shifu_tpu_torch.data.transform import DatasetTransformer
    (jmc, jccs, jchunks), (mc, ccs, chunks) = fraud_chunks
    jmc.normalize.normType = JNormType[norm_type]
    mc.normalize.normType = NormType[norm_type]
    jtf, tf = JTransformer(jmc, jccs), DatasetTransformer(mc, ccs)
    assert tf.output_names == jtf.output_names
    assert len(chunks) == len(jchunks) == 1
    want = jtf.transform_extracted(jchunks[0])
    got = tf.transform_extracted(chunks[0])
    assert got.n == want.n > 3500
    for k in ("x", "bins", "target", "weight"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_norm_planes_read_back_through_the_port_shards(prepared_set,
                                                       tmp_path):
    """The reference's ``test_norm_step_end_to_end`` on the port's own
    planes, read back through the port's ``Shards``."""
    from shifu_tpu_torch.data.shards import Shards
    port = _pair(prepared_set, tmp_path)[1]
    _norm_port(port)
    norm = Shards.open(os.path.join(port, "tmp", "NormalizedData"))
    clean = Shards.open(os.path.join(port, "tmp", "CleanedData"))
    data, bins = norm.load_all(), clean.load_all()
    n = len(data["y"])
    assert n > 3500                       # rows with unknown tags dropped
    assert data["x"].shape[0] == n and data["x"].dtype == np.float32
    assert set(np.unique(data["y"])) == {0.0, 1.0}
    assert (data["w"] > 0).all()
    assert clean.is_wire and bins["bins"].dtype == np.dtype(
        clean.schema["binsDtype"]) and bins["bins"].dtype.itemsize <= 2
    assert clean.schema["shardRows"] == clean.shard_rows
    assert sum(clean.schema["shardRows"]) == n == len(bins["y"])
    assert bins["bins"].min() >= 0
    assert abs(np.nanmean(data["x"])) < 1.0
    assert norm.schema["outputNames"] == clean.schema["outputNames"]
