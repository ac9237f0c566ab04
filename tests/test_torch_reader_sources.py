"""Port parity for every source the reference reads — the port's
``DataSource`` (stdlib decompression, ``fsspec`` and ``pyarrow`` imported
only where such a source is read) against ``shifu_tpu``'s ``pd.read_csv``
/ ``pyarrow`` reader, on the same files.

Chunks must be equal cell for cell; a failure must raise the same
exception type (coded ``ShifuError``s the same code), and with
``shifu.data.badThreshold`` > 0 the same files are quarantined with the
same ``data.quarantined_*`` counts.  Covered: ``.gz``, ``.bz2``, ``.xz``,
``.zip``, ``.tar`` and ``.tar.gz`` sources; ``.zst``, which fails as the
reference fails without the ``zstandard`` package; corrupt and truncated
archives; the quarantine scenarios of ``tests/test_faults.py`` and
``tests/test_ingest_oneparse.py`` (the parse pool on and off, torn npz
shards); ``memory://`` and ``file://`` fsspec sources with the gated
Hadoop schemes; parquet with nullable columns; the multi-character
delimiter ``read_csv``'s C engine refuses and ``\\s+``; and the columnar
raw cache a compressed or parquet source writes, which must be the
reference's.  No test here leaves ``localhost``.
"""

import bz2
import gzip
import io
import json
import lzma
import os
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from shifu_tpu import obs as jobs
from shifu_tpu.config import environment as jenv
from shifu_tpu.data import reader as jr
from shifu_tpu_torch import obs
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.data import reader as pr

pytestmark = pytest.mark.torch_port

H = ["a", "b", "tag"]


@pytest.fixture(autouse=True)
def _clean():
    for env in (environment, jenv):
        env.reset_for_tests()
        env.set_property("shifu.io.retries", "0")
    obs.reset_for_tests()
    jobs.reset_for_tests()
    yield
    environment.reset_for_tests()
    jenv.reset_for_tests()
    obs.reset_for_tests()
    jobs.reset_for_tests()


def _props(**kv):
    for k, v in kv.items():
        environment.set_property(k.replace("_", "."), str(v))
        jenv.set_property(k.replace("_", "."), str(v))


def _text(n=23, seed=0, width=3):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        cells = [f"{rng.normal():.4f}", str(int(rng.integers(-5, 50))),
                 rng.choice(["bad", "good"])][:width]
        if rng.random() < 0.1:
            cells[0] = ""
        rows.append("|".join(cells))
    return "\n".join(rows) + "\n"


def _write(path, text, how):
    data = text.encode()
    if how == "gz":
        data = gzip.compress(data)
    elif how == "bz2":
        data = bz2.compress(data)
    elif how == "xz":
        data = lzma.compress(data)
    elif how == "zip":
        b = io.BytesIO()
        with zipfile.ZipFile(b, "w") as zf:
            zf.writestr("inner.csv", data)
        data = b.getvalue()
    elif how in ("tar", "tar.gz"):
        b = io.BytesIO()
        with tarfile.open(fileobj=b,
                          mode="w:gz" if how == "tar.gz" else "w") as tf:
            info = tarfile.TarInfo("inner.csv")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        data = b.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _chunks(mod, path, header=H, chunk_rows=5, delimiter="|"):
    src = mod.DataSource(path, delimiter, header=header)
    if mod is jr:
        return [[[str(v) for v in r] for r in c.data.values.tolist()]
                for c in src.iter_chunks(chunk_rows)]
    return [[list(r) for r in zip(*(c.data[h] for h in src.header))]
            for c in src.iter_chunks(chunk_rows)]


def _outcome(mod, path, **kw):
    try:
        return "ok", _chunks(mod, path, **kw)
    except Exception as e:                    # noqa: BLE001 — compared
        code = getattr(getattr(e, "error_code", None), "name", None)
        return type(e).__name__, code


@pytest.mark.parametrize("how", ["plain", "gz", "bz2", "xz", "zip", "tar",
                                 "tar.gz"])
def test_compressed_sources_equal_the_reference(tmp_path, how):
    ext = {"plain": ""}.get(how, "." + how)
    path = _write(tmp_path / f"part-0.csv{ext}", _text(), how)
    got, want = _chunks(pr, path), _chunks(jr, path)
    assert got == want and sum(len(c) for c in got) == 23
    # a directory of mixed compressions, as one source
    d = tmp_path / "mixed"
    d.mkdir()
    for i, h in enumerate(("gz", "plain", "bz2", "xz")):
        e = {"plain": ""}.get(h, "." + h)
        _write(d / f"part-{i}.csv{e}", _text(seed=i), h)
    assert _chunks(pr, str(d)) == _chunks(jr, str(d))


def test_zst_fails_as_the_reference_does_without_zstandard(tmp_path,
                                                           monkeypatch):
    path = _write(tmp_path / "part-0.csv.zst", "x", "plain")
    with pytest.raises(ImportError) as pe:
        _chunks(pr, path)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError) as je:
        _chunks(jr, path)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("name,data", [
    ("bad.gz", b"not gzip\n" * 5), ("bad.bz2", b"not bz2\n" * 5),
    ("bad.xz", b"not xz\n" * 5), ("bad.zip", b"not zip\n" * 5),
    ("bad.tar", b"not tar\n" * 5)])
@pytest.mark.parametrize("threshold", [None, "0.6"])
def test_corrupt_archives_fail_or_quarantine_alike(tmp_path, name, data,
                                                   threshold):
    d = tmp_path / "d"
    d.mkdir()
    _write(d / "part-aaa.csv", _text(20), "plain")
    with open(d / f"part-bbb-{name}", "wb") as f:
        f.write(data)
    if threshold:
        _props(shifu_data_badThreshold=threshold)
        obs.set_enabled(True)
        jobs.set_enabled(True)
    got, want = _outcome(pr, str(d)), _outcome(jr, str(d))
    assert got == want
    if threshold and got[0] == "ok":
        assert obs.get_registry().counter(
            "data.quarantined_shards").value == 1 == jobs.get_registry(
        ).counter("data.quarantined_shards").value


def test_zip_must_hold_one_file_and_truncated_streams_raise(tmp_path):
    for names in ((), ("a.csv", "b.csv")):
        b = io.BytesIO()
        with zipfile.ZipFile(b, "w") as zf:
            for n in names:
                zf.writestr(n, _text())
        p = tmp_path / f"z{len(names)}.zip"
        p.write_bytes(b.getvalue())
        assert _outcome(pr, str(p))[0] == _outcome(jr, str(p))[0] \
            == "ValueError"
    big = "".join(_text(400, seed=s) for s in range(5)).encode()
    p = tmp_path / "trunc.csv.gz"
    p.write_bytes(gzip.compress(big)[:5000])
    assert _outcome(pr, str(p))[0] == _outcome(jr, str(p))[0] \
        == "EOFError"


def _mixed_dir(tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    with open(d / "part-aaa.csv", "w") as f:
        for i in range(20):
            f.write(f"{i}|{i * 2}|good\n")
    with open(d / "part-bbb.csv.gz", "wb") as f:
        f.write(b"this is not gzip data\n" * 5)
    return str(d)


def test_quarantine_scenarios_of_the_reference(tmp_path):
    d = _mixed_dir(tmp_path)
    # strict by default: the bad gzip raises an OSError in both
    assert _outcome(pr, d)[0] == _outcome(jr, d)[0] == "OSError"
    # under the threshold: the good rows survive, one shard quarantined
    _props(shifu_data_badThreshold="0.6")
    obs.set_enabled(True)
    jobs.set_enabled(True)
    got, want = _outcome(pr, d), _outcome(jr, d)
    assert got == want and sum(len(c) for c in got[1]) == 20
    for reg in (obs.get_registry(), jobs.get_registry()):
        assert reg.counter("data.quarantined_shards").value == 1
        assert reg.counter("data.quarantined_rows").value == 0
    # over it: the coded error names the first offender
    _props(shifu_data_badThreshold="0.05")
    errs = []
    for mod in (pr, jr):
        with pytest.raises(Exception) as ei:
            _chunks(mod, d)
        errs.append(ei.value)
    assert [e.error_code.name for e in errs] == \
        ["ERROR_BAD_DATA_THRESHOLD"] * 2
    assert all("part-bbb" in str(e) for e in errs)


@pytest.mark.parametrize("workers", ["0", "4"])
def test_pooled_quarantine_accounting_matches(tmp_path, workers):
    """The parse pool on and off: the same rows and quarantine counts as
    the reference's serial loop."""
    from shifu_tpu_torch.data import parsepool
    d = tmp_path / "data"
    d.mkdir()
    with open(d / "part-aaa.csv", "w") as f:
        for i in range(50):
            f.write(f"{i}|{i * 2}|good\n")
    with open(d / "part-bbb.csv.gz", "wb") as f:
        f.write(b"this is not gzip data\n" * 5)
    _props(shifu_data_badThreshold="0.6", shifu_ingest_parseWorkers=workers)
    obs.set_enabled(True)
    jobs.set_enabled(True)
    rows = sum(len(c) for c in jr.DataSource(str(d), "|", header=H)
               .iter_chunks())
    want = (rows, jobs.get_registry().counter(
        "data.quarantined_shards").value)
    assert parsepool.parse_workers() == int(workers) or workers == "4"
    rows = sum(len(c) for c in pr.DataSource(str(d), "|", header=H)
               .iter_chunks())
    assert (rows, obs.get_registry().counter(
        "data.quarantined_shards").value) == want == (50, 1.0)


def test_torn_npz_shard_is_quarantined_under_the_threshold(tmp_path):
    from shifu_tpu.data.shards import Shards as JShards
    from shifu_tpu_torch.data.shards import Shards
    d = tmp_path / "shards"
    d.mkdir()
    for s in range(4):
        np.savez(d / f"part-{s:05d}.npz", y=np.full(32, s, np.float32),
                 w=np.ones(32, np.float32))
    with open(d / "schema.json", "w") as f:
        json.dump({"numShards": 4, "numRows": 128}, f)
    bad = d / "part-00002.npz"
    with open(bad, "r+b") as f:
        f.truncate(os.path.getsize(bad) // 2)
    for cls in (Shards, JShards):
        with pytest.raises(Exception):
            cls.open(str(d)).load_all()
    _props(shifu_data_badThreshold="0.5")
    obs.set_enabled(True)
    jobs.set_enabled(True)
    got = Shards.open(str(d)).load_all()
    want = JShards.open(str(d)).load_all()
    np.testing.assert_array_equal(got["y"], want["y"])
    assert len(got["y"]) == 96 and 2.0 not in got["y"]
    assert obs.get_registry().counter("data.quarantined_shards").value == 1
    with pytest.raises(Exception):
        list(Shards.open(str(d)).iter_shards(strict=True))


# ------------------------------------------------------------- fsspec
def _memory_dataset(tag):
    import fsspec
    fs = fsspec.filesystem("memory")
    text = _text(40, seed=3)
    lines = text.splitlines()
    with fs.open(f"/{tag}/part-000.csv", "w") as f:
        f.write("a|b|tag\n" + "\n".join(lines[:20]) + "\n")
    with fs.open(f"/{tag}/part-001.csv.gz", "wb") as f:
        f.write(gzip.compress(("a|b|tag\n" + "\n".join(lines[20:])
                               + "\n").encode()))
    with fs.open(f"/{tag}/_SUCCESS", "w") as f:
        f.write("")
    return f"memory://{tag}"


def test_memory_source_lists_parts_and_streams_equal_chunks():
    path = _memory_dataset("torch_src")
    files = pr.resolve_data_files(path)
    assert files == jr.resolve_data_files(path)
    assert [os.path.basename(f) for f in files] == ["part-000.csv",
                                                    "part-001.csv.gz"]
    assert pr.DataSource(path, "|").header == jr.DataSource(path, "|").header
    got = _chunks(pr, path, header=None, chunk_rows=7)
    assert got == _chunks(jr, path, header=None, chunk_rows=7)
    assert sum(len(c) for c in got) == 40


def test_gated_and_unknown_schemes_are_coded_errors(tmp_path):
    for url, match in (("hdfs://nn:8020/data/part-*", "webhdfs://namenode"),
                       ("viewfs://x/part-*", "no native"),
                       ("s3n://bucket/part-*", "known scheme")):
        codes = []
        for mod in (pr, jr):
            with pytest.raises(Exception, match=match) as ei:
                mod.resolve_data_files(url)
            codes.append(ei.value.error_code.name)
        assert codes == ["ERROR_REMOTE_SOURCE"] * 2
    hp = tmp_path / "header"
    hp.write_text("a|b|c\n")
    assert pr.read_header(f"file://{hp}", "|") == \
        jr.read_header(f"file://{hp}", "|") == ["a", "b", "c"]
    data = _write(tmp_path / "p.csv", _text(), "plain")
    assert _chunks(pr, f"file://{data}") == _chunks(jr, f"file://{data}")


# ------------------------------------------------------------- parquet
def _parquet(path, n=37, seed=1):
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    ints = [None if rng.random() < 0.2 else int(v)
            for v in rng.integers(-9, 99, n)]
    floats = [None if rng.random() < 0.1 else float(v)
              for v in rng.normal(size=n)]
    tags = [str(v) for v in rng.choice(["bad", "good"], n)]
    pq.write_table(pa.table({"a": pa.array(ints, pa.int64()),
                             "b": pa.array(floats, pa.float64()),
                             "tag": pa.array(tags)}), str(path),
                   row_group_size=10)
    return str(path)


def test_parquet_source_equals_the_reference(tmp_path):
    d = tmp_path / "pq"
    d.mkdir()
    _parquet(d / "part-0.parquet")
    _parquet(d / "part-1.parquet", seed=2)
    src = pr.DataSource(str(d), "|")
    assert src.parquet and src.header == jr.DataSource(str(d), "|").header
    got = _chunks(pr, str(d), header=None, chunk_rows=8)
    want = _chunks(jr, str(d), header=None, chunk_rows=8)
    assert got == want and sum(len(c) for c in got) == 74
    assert any("" in row for c in got for row in c)


# ----------------------------------------------------------- delimiters
def test_multi_character_delimiters_fail_as_the_c_engine_does(tmp_path):
    path = _write(tmp_path / "p.csv", _text().replace("|", "||"), "plain")
    outs = [_outcome(m, path, delimiter="||") for m in (pr, jr)]
    assert outs[0] == outs[1] == ("ValueError", None)
    ws = tmp_path / "ws.csv"
    ws.write_text("1  2\tgood\n 3 4  bad \n5 6\n\n")
    assert _chunks(pr, str(ws), delimiter=r"\s+") == \
        _chunks(jr, str(ws), delimiter=r"\s+")


# ------------------------------------------------------------ raw cache
@pytest.mark.parametrize("kind", ["gz", "parquet"])
def test_compressed_and_parquet_sources_write_the_reference_cache(
        prepared_set, tmp_path, kind):
    """The raw cache of a gzipped CSV or a parquet copy of the fraud
    set: the same directory key, ``.raw`` bytes and manifest as the
    reference's."""
    from shifu_tpu.config import ModelConfig as JMC
    from shifu_tpu.config.column_config import load_column_configs as jl
    from shifu_tpu.data.extract import ChunkExtractor as JX
    from shifu_tpu.data.parsepool import iter_extracted as j_iter
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.data.extract import ChunkExtractor
    from shifu_tpu_torch.data.parsepool import iter_extracted
    mc_path = os.path.join(prepared_set, "ModelConfig.json")
    src_csv = JMC.load(mc_path).dataSet.dataPath
    with open(src_csv) as f:
        text = f.read()
    if kind == "gz":
        data = _write(tmp_path / "fraud.csv.gz", text, "gz")
    else:
        import pyarrow as pa
        import pyarrow.parquet as pq
        lines = text.splitlines()
        head = lines[0].split("|")
        cols = list(zip(*(ln.split("|") for ln in lines[1:])))
        data = str(tmp_path / "fraud.parquet")
        pq.write_table(pa.table({h: pa.array(list(c))
                                 for h, c in zip(head, cols)}), data)
    cc = os.path.join(prepared_set, "ColumnConfig.json")
    roots = []
    for cfg, load, x, mod, it in ((JMC, jl, JX, jr, j_iter),
                                  (ModelConfig, load_column_configs,
                                   ChunkExtractor, pr, iter_extracted)):
        mc = cfg.load(mc_path)
        root = str(tmp_path / f"cache-{mod.__name__.split('.')[0]}")
        src = mod.DataSource(data, "|")
        list(it(src, x(mc, load(cc)), cache_root=root))
        roots.append(root)
    assert os.listdir(roots[0]) == os.listdir(roots[1])
    (key,) = os.listdir(roots[0])
    files = []
    for root in roots:
        cdir = os.path.join(root, key)
        out = {}
        for f in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, f), "rb") as fh:
                out[f] = fh.read()
        man = json.loads(out.pop("manifest.json"))
        files.append((out, man))
    assert files[0][1] == files[1][1] and files[0][1]["rows"] > 3000
    assert files[0][0] == files[1][0]
