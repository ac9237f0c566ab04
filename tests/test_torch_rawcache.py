"""Port parity for the columnar raw cache (``shifu_tpu_torch.data.rawcache``
and the cache branch of ``parsepool.iter_extracted``) against
``shifu_tpu.data.rawcache`` on the prepared fraud model set, with both
packages' ``CHUNK_ROWS`` shrunk to 700 so the 4,000-row CSV makes six
chunks.

The tolerance is zero throughout: the cache stores what the parse gives,
so the ``.raw`` files of the two packages are byte-equal and their
manifests equal as dicts (the same directory key too), each package
serves the other's cache with the arrays of its own text parse, and the
norm planes and eval scores are equal with the cache and without it
(``-Dshifu.ingest.rawCache=false``).  A consumer whose ``chunkRows``
differs from the manifest's rebuilds silently, so every pass that should
be served asserts a hit (``parsepool.cache_passes``), not only equal
arrays.  Also: staleness on a source change (mtime, size), the permanent
budget ``aborted`` marker, the torn-tmp sweep and an abandoned pass, a
``sampleRate < 1`` replay, categorical codes in first-appearance order
(a value first seen in a later chunk, an empty cell, a missing-value
token) and C6's ``"-0"`` beside integers.
"""

import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.data import parsepool

pytestmark = pytest.mark.torch_port

CHUNK = 700


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    monkeypatch.setattr("shifu_tpu.data.parsepool.CHUNK_ROWS", CHUNK)
    monkeypatch.setattr(parsepool, "CHUNK_ROWS", CHUNK)
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


@pytest.fixture
def cset(prepared_set, tmp_path, fraud_csv):
    """The prepared set over its own copy of the CSV (so changing the
    source leaves the session-scoped fixture alone), with no raw cache yet."""
    csv = str(tmp_path / "data" / "part-000.csv")
    os.makedirs(os.path.dirname(csv))
    shutil.copy2(fraud_csv, csv)
    _point_at(prepared_set, csv)
    shutil.rmtree(os.path.join(prepared_set, "tmp", "RawCache"),
                  ignore_errors=True)
    return prepared_set


def _point_at(d, csv):
    from shifu_tpu.config import ModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.dataSet.dataPath = csv
    mc.evals[0].dataSet.dataPath = csv
    mc.save(path)


def _ref_io(d):
    """(source, stats-time extractor) of the reference."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.column_config import load_column_configs
    from shifu_tpu.data import DataSource
    from shifu_tpu.data.extract import ChunkExtractor
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    return (DataSource(mc.dataSet.dataPath, mc.dataSet.dataDelimiter),
            ChunkExtractor(mc, ccs))


def _port_io(d):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.data.extract import ChunkExtractor
    from shifu_tpu_torch.data.reader import DataSource
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    return (DataSource(mc.dataSet.dataPath, mc.dataSet.dataDelimiter),
            ChunkExtractor(mc, ccs))


def _ref_pass(d, root, **kw):
    from shifu_tpu.data.parsepool import iter_extracted
    src, ex = _ref_io(d)
    return list(iter_extracted(src, ex, cache_root=root, **kw))


def _port_pass(d, root=None, **kw):
    from shifu_tpu_torch.data.parsepool import iter_extracted
    src, ex = _port_io(d)
    return list(iter_extracted(src, ex, cache_root=root, **kw))


def _counted(fn, *args, **kw):
    """(result, the hits/misses of the cache passes ``fn`` made)."""
    before = dict(parsepool.cache_passes)
    out = fn(*args, **kw)
    return out, {k: parsepool.cache_passes[k] - before[k]
                 for k in ("hits", "misses")}


def _text_parse(d, rate=1.0):
    environment.set_property("shifu.ingest.rawCache", "false")
    try:
        return _port_pass(d, os.path.join(d, "tmp", "RawCache"), rate=rate)
    finally:
        environment.reset_for_tests()


def _assert_same_chunks(got, want):
    assert [ci for ci, _ in got] == [ci for ci, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.n == b.n
        for k in ("target", "weight", "numeric", "numeric_valid"):
            assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k
        assert a.categorical.keys() == b.categorical.keys()
        for k in a.categorical:
            assert list(a.categorical[k]) == list(b.categorical[k]), k


def _only_dir(root):
    (key,) = os.listdir(root)
    return os.path.join(root, key)


def _cache_files(cdir):
    out = {}
    for f in sorted(os.listdir(cdir)):
        with open(os.path.join(cdir, f), "rb") as fh:
            out[f] = fh.read()
    man = json.loads(out.pop("manifest.json"))
    return out, man


def test_raw_files_and_manifest_equal_the_reference(cset):
    """Both packages write the cache of one CSV: the same directory key,
    the same ``.raw`` bytes, equal manifests."""
    ref_root = os.path.join(cset, "tmp", "RawCacheRef")
    port_root = os.path.join(cset, "tmp", "RawCache")
    _ref_pass(cset, ref_root)
    _, c = _counted(_port_pass, cset, port_root)
    assert c == {"hits": 0, "misses": 1}
    assert os.listdir(ref_root) == os.listdir(port_root)
    ref_files, ref_man = _cache_files(_only_dir(ref_root))
    port_files, port_man = _cache_files(_only_dir(port_root))
    assert port_man == ref_man
    assert port_man["chunkRows"] == CHUNK and len(port_man["chunkKept"]) == 6
    assert set(port_files) == set(ref_files)
    assert "cat-0.raw" in port_files and "numeric.raw" in port_files
    for k in ref_files:
        assert port_files[k] == ref_files[k], k


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_serves_the_other(cset, writer):
    """A cache the one package commits, the other serves (a hit) with the
    arrays of its own text parse; the reference's own reader reads the
    port's cache."""
    root = os.path.join(cset, "tmp", "RawCache")
    (_ref_pass if writer == "ref" else _port_pass)(cset, root)
    if writer == "ref":
        got, c = _counted(_port_pass, cset, root)
        assert c == {"hits": 1, "misses": 0}
        _assert_same_chunks(got, _text_parse(cset))
        return
    from shifu_tpu.data.parsepool import cache_dir_for
    from shifu_tpu.data.rawcache import open_raw_cache, source_signature
    src, ex = _ref_io(cset)
    sig = source_signature(src.files)
    rd, writable = open_raw_cache(cache_dir_for(root, sig, ex), sig, ex,
                                  CHUNK)
    assert rd is not None and not writable and rd.n_chunks == 6
    j_environment.set_property("shifu.ingest.rawCache", "false")
    want = _ref_pass(cset, root)
    j_environment.reset_for_tests()
    _assert_same_chunks([(ci, rd.chunk(ci, ex)) for ci in range(6)], want)


def _gbt(d):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 3, "MaxDepth": 3, "Loss": "log",
                       "LearningRate": 0.1}
    mc.evals[0].dataSet = mc.dataSet.__class__(**vars(mc.dataSet))
    mc.save(path)


def _steps(d):
    """The port's ``stats → norm → train → eval -run`` on the CPU; the
    cache passes of norm and eval."""
    from shifu_tpu_torch.pipeline.evaluate import EvalProcessor
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    assert StatsProcessor(d, device="cpu").run() == 0
    rc, norm_c = _counted(NormalizeProcessor(d).run)
    assert rc == 0
    assert TrainProcessor(d, device="cpu").run() == 0
    rc, eval_c = _counted(EvalProcessor(d, params={"run_eval": ""},
                                        device="cpu").run)
    assert rc == 0
    return norm_c, eval_c


def test_norm_planes_and_eval_scores_equal_with_and_without_cache(
        cset, tmp_path):
    """Cache on: stats writes it, norm and eval are hits; cache off: every
    pass parses text.  The wire plane, the norm shards and the score file
    are byte-equal."""
    off = str(tmp_path / "off")
    shutil.copytree(cset, off)
    _gbt(cset)
    _gbt(off)
    assert _steps(cset) == ({"hits": 1, "misses": 0},
                            {"hits": 1, "misses": 0})
    environment.set_property("shifu.ingest.rawCache", "false")
    assert _steps(off) == ({"hits": 0, "misses": 0},
                           {"hits": 0, "misses": 0})
    assert not os.path.exists(os.path.join(off, "tmp", "RawCache"))
    for sub in ("tmp/CleanedData/.spill_cache/spill-bins-y-w",
                "tmp/NormalizedData", "evals/Eval1"):
        names = sorted(f for f in os.listdir(os.path.join(cset, sub))
                       if f.endswith((".raw", ".npz", "EvalScore")))
        assert names == sorted(
            f for f in os.listdir(os.path.join(off, sub))
            if f.endswith((".raw", ".npz", "EvalScore"))) and names
        for f in names:
            a, b = (os.path.join(x, sub, f) for x in (cset, off))
            if f.endswith(".npz"):
                with np.load(a) as za, np.load(b) as zb:
                    for k in za:
                        assert za[k].tobytes() == zb[k].tobytes(), (f, k)
            else:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), f


@pytest.mark.parametrize("change", ["mtime", "size"])
def test_source_change_makes_the_cache_stale(cset, change):
    """The manifest pins the source's ``[name, size, mtime_ns]``: after a
    change the next pass misses and rebuilds, the one after it hits."""
    from shifu_tpu_torch.config import ModelConfig
    root = os.path.join(cset, "tmp", "RawCache")
    _port_pass(cset, root)
    csv = ModelConfig.load(os.path.join(cset, "ModelConfig.json")) \
        .dataSet.dataPath
    st = os.stat(csv)
    if change == "mtime":
        os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    else:
        with open(csv) as f:
            last = f.read().splitlines()[-1]
        with open(csv, "a") as f:
            f.write(last + "\n")
        os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns))
    got, c = _counted(_port_pass, cset, root)
    assert c == {"hits": 0, "misses": 1}
    rows = sum(ex.n for _, ex in got)
    assert rows == 4000 + (change == "size")
    again, c = _counted(_port_pass, cset, root)
    assert c == {"hits": 1, "misses": 0}
    _assert_same_chunks(again, got)


def test_budget_abort_is_permanent(cset):
    """Over ``rawCacheBudgetBytes`` the write aborts and leaves an
    ``aborted`` marker: later passes neither serve nor rebuild, even with
    the budget raised, and still give the text parse's chunks."""
    from shifu_tpu_torch.data.rawcache import open_raw_cache
    from shifu_tpu_torch.data.shards import source_signature
    root = os.path.join(cset, "tmp", "RawCache")
    environment.set_property("shifu.ingest.rawCacheBudgetBytes", "64")
    first = _port_pass(cset, root)
    environment.reset_for_tests()
    cdir = _only_dir(root)
    assert sorted(os.listdir(cdir)) == ["manifest.json"]
    with open(os.path.join(cdir, "manifest.json")) as f:
        assert "budget 64 bytes exceeded" in json.load(f)["aborted"]
    src, ex = _port_io(cset)
    assert open_raw_cache(cdir, source_signature(src.files), ex,
                          CHUNK) == (None, False)
    again, c = _counted(_port_pass, cset, root)
    assert c == {"hits": 0, "misses": 1}
    assert sorted(os.listdir(cdir)) == ["manifest.json"]
    _assert_same_chunks(again, first)
    _assert_same_chunks(first, _text_parse(cset))


def test_torn_tmp_files_are_swept_and_an_abandoned_pass_leaves_none(cset):
    """A consumer that leaves mid-pass aborts the write (no manifest, no
    tmp file) and its pass still counts a miss, with no bytes written; a
    killed writer's tmp files are swept by the next writer, whose cache
    then serves."""
    from shifu_tpu_torch.data.parsepool import iter_extracted
    root = os.path.join(cset, "tmp", "RawCache")
    src, ex = _port_io(cset)
    before = dict(parsepool.cache_passes)
    it = iter_extracted(src, ex, cache_root=root)
    next(it)
    next(it)
    it.close()
    assert {k: parsepool.cache_passes[k] - before[k] for k in before} == \
        {"hits": 0, "misses": 1, "bytes_written": 0}
    cdir = _only_dir(root)
    assert os.listdir(cdir) == []
    torn = os.path.join(cdir, "numeric.raw.tmp-999-1")
    with open(torn, "wb") as f:
        f.write(b"\0" * 100)
    written = parsepool.cache_passes["bytes_written"]
    got, c = _counted(_port_pass, cset, root)
    assert c == {"hits": 0, "misses": 1} and not os.path.exists(torn)
    with open(os.path.join(cdir, "manifest.json")) as f:
        assert parsepool.cache_passes["bytes_written"] - written == \
            json.load(f)["bytes"] > 0
    served, c = _counted(_port_pass, cset, root)
    assert c == {"hits": 1, "misses": 0}
    _assert_same_chunks(served, got)


def test_sampled_replay_equals_the_text_parse(cset):
    """``sampleRate < 1``: the cold pass parses at full rate and replays
    the sample, the warm pass serves it; both equal the sample-then-parse
    order without the cache."""
    root = os.path.join(cset, "tmp", "RawCache")
    want = _text_parse(cset, rate=0.6)
    cold, c = _counted(_port_pass, cset, root, rate=0.6)
    assert c == {"hits": 0, "misses": 1}
    warm, c = _counted(_port_pass, cset, root, rate=0.6)
    assert c == {"hits": 1, "misses": 0}
    assert 0.5 < sum(ex.n for _, ex in warm) / 4000 < 0.7
    _assert_same_chunks(cold, want)
    _assert_same_chunks(warm, want)


def test_category_codes_and_signed_zero_match_the_reference(cset):
    """``country`` gets a value first seen in chunk 2 (``ZZ``), empty
    cells and the missing token ``?``; ``velocity`` gets ``"-0"`` in a
    chunk of integers (0.0) and beside ``1.5`` (-0.0, C6).  Codes,
    vocabularies and bytes equal the reference's."""
    from shifu_tpu_torch.config import ModelConfig
    csv = ModelConfig.load(os.path.join(cset, "ModelConfig.json")) \
        .dataSet.dataPath
    with open(csv) as f:
        lines = f.read().splitlines()
    head = lines[0].split("|")
    ci, vi = head.index("country"), head.index("velocity")
    rows = [line.split("|") for line in lines[1:]]
    for i, r in enumerate(rows):
        if r[ci] == "ZZ":
            r[ci] = "US"
        if 10 <= i < 20:
            r[ci] = ""
        elif 30 <= i < 40:
            r[ci] = "?"
        elif i in (1500, 1600):
            r[ci] = "ZZ"
    rows[100][vi] = "-0"
    rows[800][vi], rows[801][vi] = "-0", "1.5"
    with open(csv, "w") as f:
        f.write("\n".join([lines[0]] + ["|".join(r) for r in rows]) + "\n")
    ref_root = os.path.join(cset, "tmp", "RawCacheRef")
    port_root = os.path.join(cset, "tmp", "RawCache")
    _ref_pass(cset, ref_root)
    _port_pass(cset, port_root)
    ref_files, ref_man = _cache_files(_only_dir(ref_root))
    port_files, port_man = _cache_files(_only_dir(port_root))
    assert port_man == ref_man
    for k in ref_files:
        assert port_files[k] == ref_files[k], k
    j = port_man["categoricalCols"].index("country")
    vocab = port_man["vocabs"][j]
    assert {"", "?", "ZZ"} <= set(vocab) and vocab[-1] == "ZZ"
    served, c = _counted(_port_pass, cset, port_root)
    assert c == {"hits": 1, "misses": 0}
    by_id = {}
    for _, ex in served:
        k = [c.columnName for c in ex.numeric_cols].index("velocity")
        for t, v in zip(ex.categorical["txn_id"], ex.numeric[:, k]):
            by_id[t] = v
    assert by_id["t100"] == 0.0 and not np.signbit(by_id["t100"])
    assert by_id["t800"] == 0.0 and np.signbit(by_id["t800"])
