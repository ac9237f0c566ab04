"""Port parity for the reading side of the stats path: the port's
``DataSource`` (no pandas) against ``shifu_tpu``'s ``pd.read_csv`` reader,
cell for cell and chunk for chunk; then extraction and ``iter_extracted``
(the parse pool on and off, ``sampleRate`` 0.5) against the reference's on
the fraud fixture.  All outputs are compared for equality.
"""

import gzip
import os

import numpy as np
import pytest

from shifu_tpu.config import ModelConfig as JModelConfig
from shifu_tpu.config import environment as jenv
from shifu_tpu.config import load_column_configs as j_load_ccs
from shifu_tpu.data import extract as jx
from shifu_tpu.data import parsepool as jpp
from shifu_tpu.data import reader as jr
from shifu_tpu_torch.config import ModelConfig, environment
from shifu_tpu_torch.config import load_column_configs
from shifu_tpu_torch.data import extract as px
from shifu_tpu_torch.data import parsepool as ppp
from shifu_tpu_torch.data import reader as pr

pytestmark = pytest.mark.torch_port

H = ["a", "b", "c"]


def _chunks(mod, path, header, chunk_rows):
    src = mod.DataSource(path, "|", header=header)
    if mod is jr:
        return [c.data.values.tolist() for c in src.iter_chunks(chunk_rows)]
    return [[list(r) for r in zip(*(c.data[h] for h in header))]
            for c in src.iter_chunks(chunk_rows)]


def _both(path, header, chunk_rows):
    out = []
    for mod in (jr, pr):
        try:
            out.append(_chunks(mod, path, header, chunk_rows))
        except Exception as e:                       # noqa: BLE001
            out.append(type(e).__name__)
    return out


CASES = {
    "plain": "1|2|3\n4|5|6\n7|8|9\n10|11|12\n",
    "literal_header_row": "a|b|c\n1|2|3\n4|5|6\n",
    "header_row_only": "a|b|c\n",
    "quotes_are_literal": '"1|2"|3|4\n"a"|b"|c\n',
    "too_many_fields": "1|2|3\n4|5|6|7\n8|9|10\n11|12|13|14|15\n16|17|18\n",
    "short_rows": "1|2\n3\n4|5|6\n||\n",
    "blank_lines": "1|2|3\n\n   \n\t\n4|5|6\n \t \n7|8|9\n",
    "crlf": "1|2|3\r\n4|5|6\r\n\r\n7|8|9\r\n",
    "bare_cr": "1|2|3\r4|5|6\r7|8|9",
    "no_final_newline": "1|2|3\n4|5|6",
    "bom": "﻿a|b|c\n1|2|3\n",
    "spaces_kept": " 1 | x |3 \n",
    "first_row_long": "1|2|3|4\n5|6|7|8|9\n10\n11|12|13|14\n",
    "first_row_short": "1\n2|3\n4|5|6\n7|8|9|10\n",
    "bad_line_at_batch_start": "1|2\n4|5|6|7\n7|8|9\n1|2|3|4\n5|5|5\n",
    "empty_file": "",
    "only_blank_lines": "\n \n",
}


@pytest.mark.parametrize("chunk_rows", [1, 2, 3, 1000])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_cells_and_chunks_equal_reference(tmp_path, name, chunk_rows):
    path = tmp_path / "part-0.csv"
    path.write_bytes(CASES[name].encode("utf-8"))
    want, got = _both(str(path), H, chunk_rows)
    assert got == want


def test_reader_random_files_equal_reference(tmp_path):
    """Random files within the contract: random field counts, blank lines,
    header rows, BOMs and line ends, random chunk sizes."""
    rng = np.random.default_rng(0)
    tokens = ["1", "x", "", '"q"', "s ", "é", "a", "-0", "1e5"]
    for trial in range(150):
        lead = " " if rng.random() < 0.5 else ""
        lines = []
        for _ in range(rng.integers(0, 12)):
            k = rng.random()
            if k < 0.1:
                lines.append(str(rng.choice(["", " ", "\t", " \t "])))
            elif k < 0.15:
                lines.append("a|b|c")
            else:
                lines.append("|".join(
                    lead + str(rng.choice(tokens)) + str(rng.integers(0, 9))
                    for _ in range(rng.choice([1, 2, 3, 3, 3, 4, 5]))))
        # a bare CR before a line that starts with a blank is outside the
        # contract (see data/reader.py::_file_batches)
        ends = ["\n", "\n", "\r\n"] + ([] if lead else ["\r"])
        text = "".join(ln + str(rng.choice(ends)) for ln in lines)
        if rng.random() < 0.05:
            text = "﻿" + text
        path = tmp_path / f"f{trial}.csv"
        path.write_bytes(text.encode("utf-8"))
        want, got = _both(str(path), H, int(rng.integers(1, 6)))
        assert got == want, text


def test_files_gzip_header_and_errors(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    with gzip.open(d / "part-1.csv.gz", "wt") as f:
        f.write("x|y\n1|2\n3|4\n")
    (d / "part-0.csv").write_text("x|y\n5|6\n")
    (d / "_SUCCESS").write_text("")
    (d / ".pig_header").write_text("x|y\n")
    assert pr.resolve_data_files(str(d)) == jr.resolve_data_files(str(d))
    assert pr.resolve_data_files(str(d / "part-*")) == \
        jr.resolve_data_files(str(d / "part-*"))
    assert pr.read_header(None, "|", pr.resolve_data_files(str(d))) == \
        jr.read_header(None, "|", jr.resolve_data_files(str(d))) == ["x", "y"]
    (tmp_path / "h.txt").write_text(" x | y \n")
    assert pr.read_header(str(tmp_path / "h.txt"), "|") == ["x", "y"]
    want = [c.data.values.tolist()
            for c in jr.DataSource(str(d), "|").iter_chunks(1)]
    got = [[list(r) for r in zip(c.data["x"], c.data["y"])]
           for c in pr.DataSource(str(d), "|").iter_chunks(1)]
    assert got == want
    with pytest.raises(NotImplementedError, match="item 1"):
        pr.DataSource("gs://bucket/data", "|")
    (d / "p.parquet").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="parquet"):
        pr.DataSource(str(d), "|")
    bad = tmp_path / "bad.csv"
    bad.write_bytes(b"1|2\n\xff|3\n")
    with pytest.raises(UnicodeDecodeError):
        list(pr.DataSource(str(bad), "|", header=["x", "y"]).iter_chunks())
    environment.set_property("shifu.data.badThreshold", "0.1")
    try:
        with pytest.raises(NotImplementedError, match="quarantine"):
            list(pr.DataSource(str(bad), "|",
                               header=["x", "y"]).iter_chunks())
    finally:
        environment.reset_for_tests()


def test_tags_weights_and_filters():
    tags = np.array(["bad", " good", "BAD", "", "x", "bad "], object)
    for args in ((["bad"], ["good"]), (["bad"], []), (["bad", "x"], ["x"])):
        np.testing.assert_array_equal(pr.tag_to_target(tags, *args),
                                      jr.tag_to_target(tags, *args))
    np.testing.assert_array_equal(pr.tag_to_class(tags, ["good", "x"]),
                                  jr.tag_to_class(tags, ["good", "x"]))
    w = np.array(["1.5", "", "-2", "0", "abc", " 3 "], object)
    np.testing.assert_array_equal(pr.parse_weight(w, 6),
                                  jr.parse_weight(w, 6))
    from shifu_tpu_torch.data.purifier import DataPurifier
    assert DataPurifier("  ").mask(pr.RawChunk(H, {
        h: np.array(["1", "2"], object) for h in H})).tolist() == [1, 1]
    with pytest.raises(NotImplementedError, match="item 1"):
        DataPurifier("a > 1")


@pytest.fixture
def fraud_extractors(model_set):
    """(reference, port) extractors and sources over the fraud fixture,
    with ColumnConfig from the reference's init."""
    from shifu_tpu.pipeline.create import InitProcessor
    assert InitProcessor(model_set).run() == 0
    out = []
    for cfg, load, x, rd in ((JModelConfig, j_load_ccs, jx, jr),
                             (ModelConfig, load_column_configs, px, pr)):
        mc = cfg.load(os.path.join(model_set, "ModelConfig.json"))
        ccs = load(os.path.join(model_set, "ColumnConfig.json"))
        out.append((x.ChunkExtractor(mc, ccs),
                    rd.DataSource(mc.dataSet.dataPath, "|")))
    return out


def _same_extracted(a, b, provenance=True):
    assert a.n == b.n
    keys = ["target", "weight", "numeric", "numeric_valid"]
    if provenance:
        assert a.raw_rows == b.raw_rows
        keys.append("kept_idx")
    for k in keys:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert list(a.categorical) == list(b.categorical)
    for k in a.categorical:
        assert list(a.categorical[k]) == list(b.categorical[k])


@pytest.mark.parametrize("workers,rate", [("0", 1.0), ("3", 1.0),
                                          ("0", 0.5), ("3", 0.5)])
def test_iter_extracted_equals_reference(fraud_extractors, workers, rate,
                                         monkeypatch):
    (jex, jsrc), (pex, psrc) = fraud_extractors
    monkeypatch.setattr(jpp, "CHUNK_ROWS", 1500)
    monkeypatch.setattr(ppp, "CHUNK_ROWS", 1500)
    for env in (jenv, environment):
        env.set_property("shifu.ingest.parseWorkers", workers)
    try:
        want = list(jpp.iter_extracted(jsrc, jex, rate=rate))
        got = list(ppp.iter_extracted(psrc, pex, rate=rate))
    finally:
        jenv.reset_for_tests()
        environment.reset_for_tests()
    assert [ci for ci, _ in got] == [ci for ci, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(got, want):
        _same_extracted(a, b)
    # the sample replayed after a full parse keeps the same rows (its
    # provenance counts the unsampled chunk)
    full = list(ppp.iter_extracted(psrc, pex))
    for (ci, ex), (_, b) in zip(full, want):
        _same_extracted(ppp.subsample_extracted(ex, rate, ci), b,
                        provenance=rate >= 1.0)
