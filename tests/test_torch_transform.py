"""Port parity: the raw-record transform of ``shifu_tpu_torch.serve``
against ``shifu_tpu.serve.transform`` on the same records.

The reference runs under the test rig's x64 (f64 wire, f64 binning), so
the port's transform runs with ``dtype=torch.float64``.  Bins and the
packed wire must be EQUAL, the parse errors identical, and the normalized
x within 1 f32 ulp.  The pandas-free ``parse_numeric`` /
``bin_categorical`` rewrites are held against the reference's pandas
versions value for value, on edge strings and on a hypothesis property.
"""

import csv
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from shifu_tpu.config import ModelConfig as JModelConfig
from shifu_tpu.config import ColumnConfig as JColumnConfig
from shifu_tpu.config import load_column_configs as j_load_ccs
from shifu_tpu.data.reader import parse_numeric as j_parse_numeric
from shifu_tpu.ops.binning import ColumnBinner as JColumnBinner
from shifu_tpu.serve.transform import FusedTransform as JFusedTransform
from shifu_tpu_torch.config import (ColumnConfig, ModelConfig,
                                    load_column_configs)
from shifu_tpu_torch.config.model_config import NormType, PrecisionType
from shifu_tpu_torch.data.reader import parse_numeric
from shifu_tpu_torch.ops.binning import CATEGORY_GROUP_SEP, ColumnBinner
from shifu_tpu_torch.serve.transform import FusedTransform

pytestmark = pytest.mark.torch_port


def _columns(cc_cls):
    """Numeric columns with and without boundaries plus a categorical one
    holding a merged category group — every bin family the transform
    groups (the reference serve suite's snapshot, widened)."""
    ccs = []
    for j, name in enumerate(("a", "b")):
        cc = cc_cls(columnNum=j, columnName=name, finalSelect=True)
        cc.columnBinning.binBoundary = [float("-inf"), 0.0, 1.0]
        cc.columnBinning.binCountNeg = [5, 5, 5, 3]
        cc.columnBinning.binCountPos = [2, 3, 4, 1]
        cc.columnBinning.binPosRate = [2 / 7., 3 / 8., 4 / 9., 0.25]
        cc.columnBinning.binCountWoe = [0.1, -0.2, 0.3, 0.0]
        cc.columnStats.mean = 0.4 + j
        cc.columnStats.stdDev = 1.3
        cc.columnStats.min = -2.0
        ccs.append(cc)
    cc = cc_cls(columnNum=2, columnName="c", finalSelect=True)
    cc.columnType = type(cc.columnType).C
    cc.columnBinning.binCategory = ["red", "green",
                                    f"blue{CATEGORY_GROUP_SEP}navy"]
    cc.columnBinning.binCountNeg = [4, 4, 4, 2]
    cc.columnBinning.binCountPos = [1, 2, 3, 1]
    cc.columnBinning.binPosRate = [.2, 1 / 3., 3 / 7., 1 / 3.]
    cc.columnBinning.binCountWoe = [0.05, -0.1, 0.2, 0.0]
    cc.columnStats.mean = 0.3
    cc.columnStats.stdDev = 0.2
    ccs.append(cc)
    cc = cc_cls(columnNum=3, columnName="d", finalSelect=True)
    cc.columnStats.mean = 2.0
    cc.columnStats.stdDev = 0.5
    ccs.append(cc)
    return ccs


def _records(seed=0, n=40):
    """Records exercising every parse edge: missing fields, None, missing
    markers, unparseable numbers, inf, strings with spaces, ints, unknown
    and merged categories, booleans — plus two malformed records."""
    rng = np.random.default_rng(seed)
    numeric = [lambda: float(rng.normal(0.5, 1.5)), lambda: None,
               lambda: "?", lambda: "not-a-number", lambda: " 0.75 ",
               lambda: int(rng.integers(-3, 4)), lambda: "inf",
               lambda: "1_000", lambda: 1.0, lambda: True]
    cats = ["red", "green", "blue", "navy", " red ", "chartreuse", None, "",
            7]
    out = []
    for _ in range(n):
        rec = {}
        for name in ("a", "b", "d"):
            if rng.random() > 0.05:
                rec[name] = numeric[int(rng.integers(len(numeric)))]()
        if rng.random() > 0.05:
            rec["c"] = cats[int(rng.integers(len(cats)))]
        out.append(rec)
    out[3] = 17
    out[11] = {"a": [1, 2], "b": 0.0, "c": "red"}
    return out


def _pair(norm_type=NormType.ZSCALE, precision=PrecisionType.FLOAT32):
    mc, jmc = ModelConfig(), JModelConfig()
    mc.normalize.normType = norm_type
    mc.normalize.precisionType = precision
    jmc.normalize.normType = type(jmc.normalize.normType)[norm_type.name]
    jmc.normalize.precisionType = \
        type(jmc.normalize.precisionType)[precision.name]
    return (FusedTransform(mc, _columns(ColumnConfig), dtype=torch.float64),
            JFusedTransform(jmc, _columns(JColumnConfig)))


def _assert_transform_parity(tf, jtf, records):
    packed, kept, errors = tf.parse_records(records)
    jpacked, jkept, jerrors = jtf.parse_records(records)
    assert errors == jerrors
    assert np.array_equal(kept, jkept)
    assert packed.dtype == jpacked.dtype == np.float64
    assert packed.tobytes() == jpacked.tobytes()
    x, bins = tf.apply_device(torch.from_numpy(packed))
    jx, jbins = jax.jit(jtf.apply_device)(jpacked)
    jx, jbins = np.asarray(jx), np.asarray(jbins)
    assert bins.dtype == torch.int32 and np.array_equal(bins.numpy(), jbins)
    assert x.dtype == torch.float32 and x.shape == jx.shape
    np.testing.assert_array_max_ulp(x.numpy(), jx, maxulp=1)
    # a bins-only consumer (tree ensembles) gets the same bins, no x
    x0, bins0 = tf.apply_device(torch.from_numpy(packed), need_x=False)
    assert x0.shape == (len(packed), 0) and torch.equal(bins0, bins)


@pytest.mark.parametrize("norm_type", [
    NormType.ZSCALE, NormType.ZSCORE, NormType.OLD_ZSCALE, NormType.WOE,
    NormType.WOE_ZSCALE, NormType.WEIGHT_WOE, NormType.HYBRID,
    NormType.ASIS_PR, NormType.ASIS_WOE, NormType.DISCRETE_ZSCALE,
    NormType.ZSCALE_INDEX, NormType.WOE_INDEX, NormType.ONEHOT,
    NormType.ZSCALE_ONEHOT])
def test_fused_transform_parity_per_norm_type(norm_type):
    tf, jtf = _pair(norm_type)
    _assert_transform_parity(tf, jtf,
                             _records(seed=sum(map(ord, norm_type.name))))


@pytest.mark.parametrize("precision", [PrecisionType.FLOAT7,
                                       PrecisionType.FLOAT16,
                                       PrecisionType.DOUBLE64])
def test_fused_transform_parity_per_precision(precision):
    tf, jtf = _pair(NormType.ZSCALE, precision)
    _assert_transform_parity(tf, jtf, _records(seed=5))


def test_fused_transform_parity_on_prepared_modelset(prepared_set):
    """The fixture's real stats+norm ColumnConfig, records straight from
    its CSV (strings as the reader saw them, a few retyped as JSON
    numbers)."""
    mc = ModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    jmc = JModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(prepared_set,
                                           "ColumnConfig.json"))
    jccs = j_load_ccs(os.path.join(prepared_set, "ColumnConfig.json"))
    tf = FusedTransform(mc, ccs, dtype=torch.float64)
    jtf = JFusedTransform(jmc, jccs)
    with open(mc.dataSet.dataPath) as f:
        records = [dict(r) for _, r in zip(range(300),
                                           csv.DictReader(f, delimiter="|"))]
    for i, r in enumerate(records[::7]):
        if r.get("amount"):
            r["amount"] = float(r["amount"])
        r["velocity"] = None if i % 3 == 0 else r["velocity"]
    assert tf.wire_width == jtf.wire_width and tf.width == jtf.width
    _assert_transform_parity(tf, jtf, records)


def test_float32_transform_bins_like_its_float32_wire():
    """The default compute dtype is float32 (the reference CLI's): the wire
    is f32, so 0.9999999999 arrives as 1.0 and bins past the 1.0 boundary,
    where the float64 transform (the x64 rig's) keeps it below."""
    rec = [{"a": 0.9999999999, "b": -1e-12, "c": "red", "d": 3}]
    tf32 = FusedTransform(ModelConfig(), _columns(ColumnConfig))
    tf64 = FusedTransform(ModelConfig(), _columns(ColumnConfig),
                          dtype=torch.float64)
    assert tf32.wire_dtype == np.float32 and tf64.wire_dtype == np.float64
    x, bins = tf32.apply_device(torch.from_numpy(tf32.parse_records(rec)[0]))
    assert bins.tolist() == [[2, 0, 0, 0]] and x.dtype == torch.float32
    _, bins = tf64.apply_device(torch.from_numpy(tf64.parse_records(rec)[0]))
    assert bins.tolist() == [[1, 0, 0, 0]]


# --------------------------------------------------------- parse rules
EDGE_STRINGS = [
    "1", "1.5", " 2 ", "1_000", "infinity", "-Inf", "+inf", "INF", "nan",
    "NaN", "0x10", "True", "False", "1,5", "1e5", "1E+05", ".5", "5.", "+.5",
    "-.5", "--5", "1e", "e5", "1.2.3", "", " ", "1e500", "-1e500", "1e-500",
    "١٢", "１２", "1 2", "\t3\n", "12345678901234567890",
    "9223372036854775807", "9223372036854775808", "-9223372036854775809",
    "18446744073709551616", "3.141592653589793238462643383279", "4.9e-324",
    "1\x002", "1.5\x00x", "inf\x00abc", "5e 1", "5e +", "-0", "-0e500",
    "0.000000000000000000000000000001e30", "1e4294967296", "null", "?",
    "NULL", "*", "~", "#"]


@pytest.mark.parametrize("batch", [
    EDGE_STRINGS, ["12", "-0", "9223372036854775808"], ["-0", "00"],
    ["9223372036854775807"], ["9223372036854775808", "-1"],
    ["99999999999999999999"], ["1\x00", "2"], ["3", "?"]],
    ids=["edges", "uint-batch", "int-batch", "int64-max", "sign-conflict",
         "beyond-uint64", "nul-int", "int-and-missing"])
def test_parse_numeric_matches_reference(batch):
    mv = JModelConfig().dataSet.missingOrInvalidValues
    for missing in ([], mv):
        f, v = parse_numeric(batch, missing)
        jf, jv = j_parse_numeric(np.array(batch, dtype=object), missing)
        assert np.array_equal(v, jv)
        assert f.tobytes() == jf.tobytes()


def test_bin_categorical_matches_reference():
    cats = ["US", "GB", f"DE{CATEGORY_GROUP_SEP}AT", " CN", "", "None"]
    vals = ["US", " US ", "us", "DE", "AT", "CN", " CN", "", "None", "FR",
            "\tGB\n", "DE\x01AT", "　GB"]
    got = ColumnBinner(categories=cats).bin_categorical(vals)
    want = JColumnBinner(categories=cats).bin_categorical(
        np.array(vals, dtype=object))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


_text = st.text(max_size=12) | st.from_regex(
    r"\s*[+-]?\d{0,22}(\.\d{0,22})?([eE]\s*[+-]?\d{0,5})?\s*", fullmatch=True)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(_text, min_size=1, max_size=6))
def test_parse_numeric_property_over_text(batch):
    mv = JModelConfig().dataSet.missingOrInvalidValues
    f, v = parse_numeric(batch, mv)
    jf, jv = j_parse_numeric(np.array(batch, dtype=object), mv)
    assert np.array_equal(v, jv)
    assert f.tobytes() == jf.tobytes()
    cats = ["a", "b c", "d"]
    assert np.array_equal(
        ColumnBinner(categories=cats).bin_categorical(batch),
        JColumnBinner(categories=cats).bin_categorical(
            np.array(batch, dtype=object)))
