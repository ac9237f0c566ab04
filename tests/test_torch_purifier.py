"""Port parity for ``dataSet.filterExpressions`` —
``shifu_tpu_torch.data.purifier.DataPurifier`` (an interpreter over a
whitelisted ``ast``) against ``shifu_tpu``'s ``pandas.eval``.

``DataPurifier(expr).mask(chunk)`` must equal the reference's, row for
row, over named cases for each trap (``&`` / ``|`` precedence, NaN,
the per-chunk numeric decision, errors that keep every row, ``not`` /
``~``, membership, chained comparisons, arithmetic, string literals) and
over expressions that a ``hypothesis`` strategy draws from the grammar.
"""

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from shifu_tpu.data.purifier import DataPurifier as JDataPurifier
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import RawChunk

pytestmark = pytest.mark.torch_port

CHUNKS = [
    {"a": ["1", "2", "", "3", "-1"], "b": ["1.5", "x", "2", "", "0"],
     "s": ["T", "F", "", "T", "x"], "i": ["0", "5", "2", "7", "1"],
     "f": ["0.5", "1", "inf", "-2", " 3 "], "e": ["", "", "", "", ""]},
    # the same names, other types: `a` and `i` are strings here, `s`
    # numeric, `e` an all-integer column
    {"a": ["x", "y", "", "1x", "z"], "b": ["3", "4", "5", "6", "7"],
     "s": ["1", "", "2", "3", "4"], "i": ["T", "T", "F", "", "T"],
     "f": ["1e3", "-0", "NaN", "nan", "2"], "e": ["1", "2", "3", "4", "5"]},
]


def _masks(expr, cols):
    df = pd.DataFrame(cols, dtype=str)
    chunk = RawChunk(list(cols), {k: np.array(v, dtype=object)
                                  for k, v in cols.items()})
    return (DataPurifier(expr).mask(chunk).tolist(),
            JDataPurifier(expr).mask(df).tolist())


NAMED = [
    # precedence: & and | are `and` / `or`
    "a > 1 & b < 2", "a > 1 | s == 'T'", "a > 1 or s == 'T' and i > 2",
    "(a > 1) | (s == 'T')", "a > 1 & True",
    # missing values
    "a > 0", "a != 1", "b == 2", "e == ''", "e != 1", "f > 1",
    # not / ~
    "not a > 1", "~(a > 1)", "not (a > 1 or s == 'T')", "~i", "~a",
    # membership and ==/!= against strings and lists
    "s == 'T'", "s != 'T'", "'T' == s", "a == 'T'", "a != 'T'",
    "a in [1, 2]", "a not in [1, 2]", "s in ['T', 'x']", "a == [1, 2]",
    "[1, 2] == a", "a in b", "s in ('T',)",
    # chained comparisons
    "1 < a < 3", "-1 <= a < 2 <= i",
    # arithmetic
    "a + i > 3", "a * 2 == i", "a / 0 > 1", "i // 0 > 1", "i % 0 > 1",
    "i % 2 == 1", "a ** 2 > 1", "-a > 0", "+a > 0", "abs(a) > 1",
    "sqrt(i) >= 2", "arctan2(a, i) > 0",
    # strings
    "s < 'U'", "s >= 'F'", "s + 'x' == 'Tx'", "s == \"T\"",
    # errors keep every row
    "a >", "zz > 1", "s > 1", "e > 1", "i ** -1 > 0", "a & i", "i & 1",
    "(a > 1) ^ (i > 1)", "a.real > 0", "s[0] == 'T'", "@a > 1", "1 > 0",
    "`x y` > 1", "a = 1", "abs(s) > 1", "-s", "True",
    # not a boolean: the truthy rows
    "a", "i", "s", "a + 1", "i * 0", "i & (a > 1)", "`a` > 1",
]


@pytest.mark.parametrize("expr", NAMED)
def test_named_expressions_keep_the_same_rows(expr):
    for cols in CHUNKS:
        got, want = _masks(expr, cols)
        assert got == want, (expr, cols)


def test_empty_and_blank_filters_keep_every_row():
    for expr in (None, "", "   "):
        got, want = _masks(expr, CHUNKS[0])
        assert got == want == [True] * 5


_NAMES = st.sampled_from(["a", "b", "s", "i", "f", "e"])
_NUMS = st.one_of(st.integers(-3, 8).map(str),
                  st.sampled_from(["0.5", "1.5", "-2.5", "1e0"]))
_STRS = st.sampled_from(["'T'", "'F'", "''", "'x'", "'1'"])
_LISTS = st.lists(st.one_of(_NUMS, _STRS), min_size=1, max_size=3).map(
    lambda xs: "[" + ", ".join(xs) + "]")
_ATOMS = st.one_of(_NAMES, _NUMS, _STRS)


def _exprs():
    arith = st.recursive(
        _ATOMS, lambda inner: st.one_of(
            st.tuples(inner, st.sampled_from(["+", "-", "*", "/", "%"]),
                      inner).map(lambda t: f"({t[0]} {t[1]} {t[2]})"),
            inner.map(lambda x: f"-{x}")), max_leaves=3)
    cmp_ = st.one_of(
        st.tuples(arith, st.sampled_from(["<", "<=", ">", ">=", "==", "!="]),
                  arith).map(lambda t: f"{t[0]} {t[1]} {t[2]}"),
        st.tuples(_NAMES, st.sampled_from(["in", "not in", "==", "!="]),
                  _LISTS).map(lambda t: f"{t[0]} {t[1]} {t[2]}"),
        st.tuples(arith, arith, arith).map(
            lambda t: f"{t[0]} < {t[1]} <= {t[2]}"))
    return st.recursive(
        cmp_, lambda inner: st.one_of(
            st.tuples(inner, st.sampled_from(["&", "|", "and", "or"]),
                      inner).map(lambda t: f"{t[0]} {t[1]} {t[2]}"),
            inner.map(lambda x: f"not ({x})"),
            inner.map(lambda x: f"~({x})")), max_leaves=4)


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_exprs(), st.integers(0, len(CHUNKS) - 1))
def test_drawn_expressions_keep_the_same_rows(expr, ci):
    got, want = _masks(expr, CHUNKS[ci])
    assert got == want, expr


def test_filtered_pipeline_matches_the_reference(model_set, tmp_path,
                                                 monkeypatch):
    """``init → stats → norm → train (GBT) → eval`` with a filter on the
    training and the eval set: the ColumnConfig counts are equal and the
    AUCs agree within 0.005 (the reference's filtered extraction needs
    the C14 shim)."""
    import json
    import os
    import shutil
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from torch_port import writable_reference_filter
    from shifu_tpu.config import ModelConfig
    writable_reference_filter(monkeypatch)
    path = os.path.join(model_set, "ModelConfig.json")
    mc = ModelConfig.load(path)
    expr = "amount > 5 & channel != 'pos' | velocity >= 6"
    mc.dataSet.filterExpressions = expr
    mc.evals[0].dataSet.filterExpressions = expr
    mc.train.algorithm = "GBT"
    mc.train.params = {"TreeNum": 5, "MaxDepth": 3, "Loss": "log"}
    mc.save(path)
    dirs = {}
    for who in ("ref", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(model_set, dirs[who])
    from shifu_tpu.pipeline.create import InitProcessor as JI
    from shifu_tpu.pipeline.evaluate import EvalProcessor as JE
    from shifu_tpu.pipeline.norm import NormalizeProcessor as JN
    from shifu_tpu.pipeline.stats import StatsProcessor as JS
    from shifu_tpu.pipeline.train import TrainProcessor as JT
    from shifu_tpu_torch.pipeline.create import InitProcessor
    from shifu_tpu_torch.pipeline.evaluate import EvalProcessor
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    d = dirs["ref"]
    assert JI(d).run() == 0
    for P, p in ((JS, {}), (JN, {}), (JT, {}), (JE, {"run_eval": ""})):
        assert P(d, params=p).run() == 0
    d = dirs["port"]
    assert InitProcessor(d).run() == 0
    assert StatsProcessor(d, device="cpu").run() == 0
    assert NormalizeProcessor(d).run() == 0
    assert TrainProcessor(d, params={}, device="cpu").run() == 0
    assert EvalProcessor(d, params={"run_eval": ""}, device="cpu").run() == 0
    ccs, aucs = [], []
    for who in ("ref", "port"):
        with open(os.path.join(dirs[who], "ColumnConfig.json")) as f:
            ccs.append([(c["columnName"], c["columnStats"]["totalCount"],
                         c["columnStats"]["missingCount"],
                         c["columnBinning"].get("binCountPos"),
                         c["columnBinning"].get("binCountNeg"))
                        for c in json.load(f)])
        with open(os.path.join(dirs[who], "evals", "Eval1",
                               "EvalPerformance.json")) as f:
            aucs.append(json.load(f)["areaUnderRoc"])
    assert ccs[0] == ccs[1]
    total = ccs[0][1][1]
    assert 1000 < total < 3900           # the filter dropped rows
    assert abs(aucs[0] - aucs[1]) <= 0.005


def test_c14_the_reference_cannot_extract_a_filtered_chunk():
    """ROADMAP C14: unshimmed, the reference's ``ChunkExtractor`` fails on
    every filter that evaluates (pandas' copy-on-write hands it a
    read-only mask, which it updates in place); the port's extracts the
    kept rows."""
    from shifu_tpu.config import ModelConfig as JMC
    from shifu_tpu.data.extract import ChunkExtractor as JX
    from shifu_tpu.data.reader import RawChunk as JRawChunk
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.data.extract import ChunkExtractor
    cols = {"a": ["1", "2", "3", "4"], "tag": ["bad", "good", "bad", "x"]}
    mcs = []
    for cfg in (JMC, ModelConfig):
        mc = cfg()
        mc.dataSet.targetColumnName = "tag"
        mc.dataSet.posTags, mc.dataSet.negTags = ["bad"], ["good"]
        mc.dataSet.filterExpressions = "a > 1"
        mcs.append(mc)
    df = pd.DataFrame(cols, dtype=str)
    with pytest.raises(ValueError, match="read-only"):
        JX(mcs[0], []).extract(JRawChunk(columns=list(cols), data=df))
    chunk = RawChunk(list(cols), {k: np.array(v, dtype=object)
                                  for k, v in cols.items()})
    ex = ChunkExtractor(mcs[1], []).extract(chunk)
    assert ex.n == 2 and ex.target.tolist() == [0.0, 1.0]
