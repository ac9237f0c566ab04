"""PMML export — the port's copy of ``shifu_tpu.export.pmml`` (host-side
``xml.etree``, no device work; the same code path, so the documents are
the reference's byte for byte).  Reference
``core/pmml/PMMLTranslator.java:47,77`` +
``core/pmml/builder/impl/`` (16 builder classes) reduced to three builders
over ``xml.etree``: RegressionModel (LR), NeuralNetwork (NN),
MiningModel/TreeModel segmentation (GBT/RF), targeting PMML 4.2.

Score parity with the native scorer is the contract (the reference verifies
against jpmml-evaluator): every DerivedField is computed from the SAME
Normalizer tables used in training —

- numeric z-score family → clamped zscore ``Apply`` (mapMissingTo=0 ≙
  missing→mean);
- numeric woe/discrete families → ``Discretize`` whose bins output the
  exact per-bin normalized value;
- categorical (any width-1 norm) → ``MapValues`` category→value computed by
  ``NormalizedColumn.transform`` on each bin index;
- GBT trees: leaf values pre-scaled by shrinkage, an init-score constant
  segment, and a logistic-link OutputField for log loss.

- one-hot-expanding norms (ONEHOT / ZSCALE_ONEHOT categorical) → one
  indicator ``MapValues`` DerivedField per bin (the last = missing/unseen
  indicator); net inputs / regression predictors bind to the flat expanded
  feature list in norm order.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from ..config import ColumnConfig
from ..config.model_config import ModelConfig, NormType
from ..ops.normalize import NormalizedColumn

PMML_NS = "http://www.dmg.org/PMML-4_2"

ZSCORE_FAMILY = {NormType.ZSCALE, NormType.ZSCORE, NormType.OLD_ZSCALE,
                 NormType.OLD_ZSCORE, NormType.HYBRID, NormType.WEIGHT_HYBRID,
                 NormType.ZSCALE_ONEHOT, NormType.ZSCALE_INDEX,
                 NormType.ZSCORE_INDEX}


class PmmlUnsupportedError(ValueError):
    pass


def _pmml_root() -> ET.Element:
    root = ET.Element("PMML", {"version": "4.2", "xmlns": PMML_NS})
    header = ET.SubElement(root, "Header", {"copyright": "shifu-tpu"})
    ET.SubElement(header, "Application", {"name": "shifu-tpu"})
    return root


def _data_dictionary(root: ET.Element, columns: List[ColumnConfig],
                     target_name: str) -> None:
    dd = ET.SubElement(root, "DataDictionary",
                       {"numberOfFields": str(len(columns) + 1)})
    for cc in columns:
        ET.SubElement(dd, "DataField", {
            "name": cc.columnName,
            "optype": "categorical" if cc.is_categorical() else "continuous",
            "dataType": "string" if cc.is_categorical() else "double"})
    ET.SubElement(dd, "DataField", {"name": target_name,
                                    "optype": "categorical",
                                    "dataType": "string"})


def _mining_schema(parent: ET.Element, columns: List[ColumnConfig],
                   target_name: str) -> None:
    ms = ET.SubElement(parent, "MiningSchema")
    for cc in columns:
        ET.SubElement(ms, "MiningField", {"name": cc.columnName,
                                          "usageType": "active"})
    ET.SubElement(ms, "MiningField", {"name": target_name,
                                      "usageType": "target"})


def _derived_name(cc: ColumnConfig) -> str:
    return f"shifu::{cc.columnName}"


def _categorical_value_table(cc: ColumnConfig, nc: NormalizedColumn
                             ) -> np.ndarray:
    """Exact per-bin normalized output (incl. the trailing missing bin)."""
    nb = cc.num_bins() + 1
    idx = np.arange(nb)
    return nc.transform(np.zeros(nb), np.zeros(nb, bool), idx)[:, 0]


def _numeric_bin_values(cc: ColumnConfig, nc: NormalizedColumn) -> np.ndarray:
    nb = cc.num_bins() + 1
    idx = np.arange(nb)
    # values/valid only matter for zscore paths, which don't take this branch
    return nc.transform(np.zeros(nb), np.ones(nb, bool), idx)[:, 0]


def _local_transformations(parent: ET.Element, columns: List[ColumnConfig],
                           model_config: ModelConfig) -> List[str]:
    """Emit one DerivedField per normalized FEATURE and return the flat
    ordered name list — one-hot-expanding norms contribute one indicator
    field per bin (reference ``WoeZscorePmmlElementCreator`` +
    ``ZscoreLocalTransformCreator`` family, ``core/pmml/builder/impl/``),
    so net input i == flat feature i for every norm type."""
    norm_type = model_config.normalize.normType
    cutoff = model_config.normalize.stdDevCutOff
    lt = ET.SubElement(parent, "LocalTransformations")
    names: List[str] = []
    for cc in columns:
        nc = NormalizedColumn(cc, norm_type, cutoff)
        if nc.width != 1:
            # one-hot expansion: feature j = [bin(col) == j]; the last
            # feature is the missing-bin indicator (unseen/missing -> 1).
            # Categorical bins one-hot via MapValues; numeric bins (plain
            # NormType.ONEHOT) via per-interval Discretize indicators.
            nb = nc.width - 1
            cats = list(cc.bin_category or [])
            bounds = list(cc.bin_boundary or [])
            for j in range(nc.width):
                name = f"{_derived_name(cc)}_{j}"
                df = ET.SubElement(lt, "DerivedField",
                                   {"name": name, "optype": "continuous",
                                    "dataType": "double"})
                missing_feat = j == nb
                if cc.is_categorical():
                    mv = ET.SubElement(df, "MapValues", {
                        "outputColumn": "out", "dataType": "double",
                        "defaultValue": "1" if missing_feat else "0",
                        "mapMissingTo": "1" if missing_feat else "0"})
                    ET.SubElement(mv, "FieldColumnPair",
                                  {"field": cc.columnName, "column": "in"})
                    table = ET.SubElement(mv, "InlineTable")
                    for bi, cat in enumerate(cats):
                        row = ET.SubElement(table, "row")
                        ET.SubElement(row, "in").text = str(cat)
                        ET.SubElement(row, "out").text = \
                            "1" if (bi == j and not missing_feat) else "0"
                else:
                    disc = ET.SubElement(df, "Discretize", {
                        "field": cc.columnName, "dataType": "double",
                        "defaultValue": "0",
                        "mapMissingTo": "1" if missing_feat else "0"})
                    if not missing_feat and j < len(bounds):
                        b = ET.SubElement(disc, "DiscretizeBin",
                                          {"binValue": "1"})
                        iv = {"closure": "closedOpen"}
                        if np.isfinite(bounds[j]):
                            iv["leftMargin"] = f"{bounds[j]:.6g}"
                        if j + 1 < len(bounds) and np.isfinite(bounds[j + 1]):
                            iv["rightMargin"] = f"{bounds[j + 1]:.6g}"
                        ET.SubElement(b, "Interval", iv)
                names.append(name)
            continue
        df = ET.SubElement(lt, "DerivedField",
                           {"name": _derived_name(cc), "optype": "continuous",
                            "dataType": "double"})
        if cc.is_categorical():
            vals = _categorical_value_table(cc, nc)
            _map_values(df, cc, vals)
        elif norm_type in ZSCORE_FAMILY:
            _zscore_transform(df, cc, cutoff)
        else:
            # per-bin table norms (WOE / WOE_ZSCALE / DISCRETE_* / ...)
            vals = _numeric_bin_values(cc, nc)
            _discretize(df, cc, vals)
        names.append(_derived_name(cc))
    return names


def _map_values(df: ET.Element, cc: ColumnConfig, vals: np.ndarray) -> None:
    mv = ET.SubElement(df, "MapValues", {
        "outputColumn": "out", "dataType": "double",
        # unseen / missing category -> the missing-bin value
        "defaultValue": f"{vals[-1]:.6f}", "mapMissingTo": f"{vals[-1]:.6f}"})
    ET.SubElement(mv, "FieldColumnPair", {"field": cc.columnName,
                                          "column": "in"})
    table = ET.SubElement(mv, "InlineTable")
    for cat, v in zip(cc.bin_category or [], vals[:-1]):
        row = ET.SubElement(table, "row")
        ET.SubElement(row, "in").text = str(cat)
        ET.SubElement(row, "out").text = f"{v:.6f}"


def _discretize(df: ET.Element, cc: ColumnConfig, vals: np.ndarray) -> None:
    """Numeric bin-table norm: Discretize where each bin outputs its
    normalized value directly (missing -> missing-bin value)."""
    bounds = cc.bin_boundary or []
    disc = ET.SubElement(df, "Discretize", {
        "field": cc.columnName, "dataType": "double",
        "defaultValue": f"{vals[-1]:.6f}", "mapMissingTo": f"{vals[-1]:.6f}"})
    for i in range(len(bounds)):
        b = ET.SubElement(disc, "DiscretizeBin",
                          {"binValue": f"{vals[i]:.6f}"})
        iv = {"closure": "closedOpen"}
        if np.isfinite(bounds[i]):
            iv["leftMargin"] = f"{bounds[i]:.6g}"
        if i + 1 < len(bounds) and np.isfinite(bounds[i + 1]):
            iv["rightMargin"] = f"{bounds[i + 1]:.6g}"
        ET.SubElement(b, "Interval", iv)


def _zscore_transform(df: ET.Element, cc: ColumnConfig, cutoff: float) -> None:
    mean, std = cc.mean(), cc.std_dev()
    lo, hi = mean - cutoff * std, mean + cutoff * std
    apply_div = ET.SubElement(df, "Apply", {"function": "/",
                                            "mapMissingTo": "0"})
    apply_sub = ET.SubElement(apply_div, "Apply", {"function": "-"})
    apply_max = ET.SubElement(apply_sub, "Apply", {"function": "max"})
    apply_min = ET.SubElement(apply_max, "Apply", {"function": "min"})
    ET.SubElement(apply_min, "FieldRef", {"field": cc.columnName})
    ET.SubElement(apply_min, "Constant").text = f"{hi:.6f}"
    ET.SubElement(apply_max, "Constant").text = f"{lo:.6f}"
    ET.SubElement(apply_sub, "Constant").text = f"{mean:.6f}"
    ET.SubElement(apply_div, "Constant").text = f"{std:.6f}"


def _fmt_list(vals) -> str:
    return "[" + ", ".join(str(v) for v in (vals or [])) + "]"


def _model_stats(parent: ET.Element, columns: List[ColumnConfig],
                 concise: bool) -> None:
    """ModelStats with per-input UnivariateStats (reference
    ``core/pmml/builder/impl/ModelStatsCreator.java:60-230``): numeric
    columns carry NumericInfo (+ ContStats bin intervals unless concise),
    categoricals a DiscrStats count array (+ bin-count Extensions unless
    concise)."""
    ms = ET.SubElement(parent, "ModelStats")
    for cc in columns:
        us = ET.SubElement(ms, "UnivariateStats", {"field": cc.columnName})
        st, bn = cc.columnStats, cc.columnBinning
        pos = bn.binCountPos or []
        neg = bn.binCountNeg or []

        def extensions(el: ET.Element) -> None:
            for name, vals in (("BinCountPos", pos), ("BinCountNeg", neg),
                               ("BinWeightedCountPos", bn.binWeightedPos),
                               ("BinWeightedCountNeg", bn.binWeightedNeg),
                               ("BinPosRate", bn.binPosRate)):
                ET.SubElement(el, "Extension",
                              {"name": name, "value": _fmt_list(vals)})
        if cc.is_categorical():
            ds = ET.SubElement(us, "DiscrStats")
            if not concise:      # PMML content model: Extension* first
                extensions(ds)
            counts = [int(p) + int(n) for p, n in zip(pos, neg)]
            arr = ET.SubElement(ds, "Array", {"type": "int",
                                              "n": str(len(counts))})
            arr.text = " ".join(str(v) for v in counts)
        else:
            attrs = {}
            for k, v in (("minimum", st.min), ("maximum", st.max),
                         ("mean", st.mean), ("median", st.median),
                         ("standardDeviation", st.stdDev)):
                if v is not None:
                    attrs[k] = str(v)
            ET.SubElement(us, "NumericInfo", attrs)
            if not concise:
                cs = ET.SubElement(us, "ContStats")
                extensions(cs)   # PMML content model: Extension* first
                bb = bn.binBoundary or []
                for i in range(len(bb)):
                    right = bb[i + 1] if i + 1 < len(bb) else float("inf")
                    attrs_i = {"closure": "openClosed"}
                    # +-inf margins are OMITTED (xs:double has no "inf"
                    # lexical form; same convention as every Discretize
                    # interval this file emits)
                    if np.isfinite(bb[i]):
                        attrs_i["leftMargin"] = str(bb[i])
                    if np.isfinite(right):
                        attrs_i["rightMargin"] = str(right)
                    ET.SubElement(cs, "Interval", attrs_i)


# ----------------------------------------------------------------- models
def nn_to_pmml(model_config: ModelConfig, columns: List[ColumnConfig],
               spec, params, concise: bool = False) -> ET.ElementTree:
    """NeuralNetwork PMML (reference NNPmmlModelCreator +
    NeuralNetworkModelIntegrator).  One-hot-expanding norms contribute one
    indicator field per bin; net input i == flat feature i."""
    target = model_config.dataSet.targetColumnName or "target"
    root = _pmml_root()
    _data_dictionary(root, columns, target)
    nn = ET.SubElement(root, "NeuralNetwork", {
        "functionName": "regression",
        "activationFunction": _pmml_act(spec.activations[0]
                                        if spec.activations else "tanh")})
    _mining_schema(nn, columns, target)
    _model_stats(nn, columns, concise)
    feature_names = _local_transformations(nn, columns, model_config)
    if spec.input_dim != len(feature_names):
        raise PmmlUnsupportedError(
            f"net input dim {spec.input_dim} != {len(feature_names)} "
            "normalized features — the model was trained on a different "
            "column/norm configuration")

    inputs = ET.SubElement(nn, "NeuralInputs",
                           {"numberOfInputs": str(spec.input_dim)})
    in_ids = []
    for i, fname in enumerate(feature_names):
        nid = f"0,{i}"
        ni = ET.SubElement(inputs, "NeuralInput", {"id": nid})
        df = ET.SubElement(ni, "DerivedField", {"optype": "continuous",
                                                "dataType": "double"})
        ET.SubElement(df, "FieldRef", {"field": fname})
        in_ids.append(nid)

    prev_ids = in_ids
    for li, layer in enumerate(params):
        w = np.asarray(layer["w"])
        b = np.asarray(layer["b"])
        is_out = li == len(params) - 1
        act = _pmml_act(spec.output_activation if is_out else
                        spec.activations[li % max(1, len(spec.activations))])
        nl = ET.SubElement(nn, "NeuralLayer",
                           {"numberOfNeurons": str(w.shape[1]),
                            "activationFunction": act})
        ids = []
        for j in range(w.shape[1]):
            nid = f"{li + 1},{j}"
            neuron = ET.SubElement(nl, "Neuron",
                                   {"id": nid, "bias": f"{b[j]:.6f}"})
            for pi, pid in enumerate(prev_ids):
                ET.SubElement(neuron, "Con",
                              {"from": pid, "weight": f"{w[pi, j]:.6f}"})
            ids.append(nid)
        prev_ids = ids

    outs = ET.SubElement(nn, "NeuralOutputs", {"numberOfOutputs": "1"})
    no = ET.SubElement(outs, "NeuralOutput", {"outputNeuron": prev_ids[0]})
    df = ET.SubElement(no, "DerivedField", {"optype": "continuous",
                                            "dataType": "double"})
    ET.SubElement(df, "FieldRef", {"field": target})
    return ET.ElementTree(root)


def lr_to_pmml(model_config: ModelConfig, columns: List[ColumnConfig],
               spec, params, concise: bool = False) -> ET.ElementTree:
    """RegressionModel PMML with logit normalization (reference
    RegressionPmmlModelCreator).  One-hot norms yield one predictor per
    expanded indicator feature."""
    target = model_config.dataSet.targetColumnName or "target"
    root = _pmml_root()
    _data_dictionary(root, columns, target)
    rm = ET.SubElement(root, "RegressionModel", {
        "functionName": "regression", "normalizationMethod": "logit"})
    _mining_schema(rm, columns, target)
    _model_stats(rm, columns, concise)
    feature_names = _local_transformations(rm, columns, model_config)
    if spec.input_dim != len(feature_names):
        raise PmmlUnsupportedError(
            f"LR input dim {spec.input_dim} != {len(feature_names)} "
            "normalized features — the model was trained on a different "
            "column/norm configuration")
    w = np.asarray(params[0]["w"])[:, 0]
    b = float(np.asarray(params[0]["b"])[0])
    table = ET.SubElement(rm, "RegressionTable", {"intercept": f"{b:.6f}"})
    for i, fname in enumerate(feature_names):
        ET.SubElement(table, "NumericPredictor",
                      {"name": fname, "exponent": "1",
                       "coefficient": f"{w[i]:.6f}"})
    return ET.ElementTree(root)


def tree_to_pmml(model_config: ModelConfig, columns: List[ColumnConfig],
                 spec, trees, concise: bool = False) -> ET.ElementTree:
    """MiningModel with TreeModel segments.  Split predicates test the
    ``bin(col)`` derived fields defined in LocalTransformations (Discretize /
    MapValues to bin index); GBT leaves are pre-scaled by shrinkage with an
    init-score constant segment and a logistic OutputField for log loss —
    scores match the native ``IndependentTreeModel.compute`` exactly (modulo
    GBT squared-loss clipping, which PMML omits)."""
    target = model_config.dataSet.targetColumnName or "target"
    is_gbt = spec.algorithm == "GBT"
    root = _pmml_root()
    _data_dictionary(root, columns, target)
    mm = ET.SubElement(root, "MiningModel", {"functionName": "regression"})
    _mining_schema(mm, columns, target)
    _model_stats(mm, columns, concise)
    _bin_index_transforms(mm, columns)
    if is_gbt and spec.loss == "log":
        _logistic_output(mm)
    seg = ET.SubElement(mm, "Segmentation", {
        "multipleModelMethod": "sum" if is_gbt else "average"})
    col_by_idx = {j: cc for j, cc in enumerate(columns)}
    scale = spec.learning_rate if is_gbt else 1.0
    if is_gbt and spec.init_score:
        s = ET.SubElement(seg, "Segment", {"id": "init"})
        ET.SubElement(s, "True")
        tm = ET.SubElement(s, "TreeModel", {"functionName": "regression"})
        _mining_schema(tm, columns, target)
        node = ET.SubElement(tm, "Node", {"id": "0",
                                          "score": f"{spec.init_score:.6f}"})
        ET.SubElement(node, "True")
    for ti, t in enumerate(trees):
        s = ET.SubElement(seg, "Segment", {"id": str(ti)})
        ET.SubElement(s, "True")
        tm = ET.SubElement(s, "TreeModel", {"functionName": "regression",
                                            "splitCharacteristic": "binarySplit"})
        _mining_schema(tm, columns, target)
        root_node = ET.SubElement(tm, "Node", {"id": "0", "score": "0"})
        ET.SubElement(root_node, "True")
        _emit_tree_node(root_node, t, 0, col_by_idx, scale)
    return ET.ElementTree(root)


def _bin_index_transforms(mm: ET.Element, columns: List[ColumnConfig]) -> None:
    """DerivedField ``bin(col)`` = the bin index (integer), matching
    ``ColumnBinner``: numeric Discretize over boundaries, categorical
    MapValues; missing/unseen -> the trailing missing bin."""
    lt = ET.SubElement(mm, "LocalTransformations")
    for cc in columns:
        nb = cc.num_bins()
        df = ET.SubElement(lt, "DerivedField",
                           {"name": f"bin({cc.columnName})",
                            "optype": "categorical", "dataType": "integer"})
        if cc.is_categorical():
            mv = ET.SubElement(df, "MapValues", {
                "outputColumn": "out", "dataType": "integer",
                "defaultValue": str(nb), "mapMissingTo": str(nb)})
            ET.SubElement(mv, "FieldColumnPair", {"field": cc.columnName,
                                                  "column": "in"})
            table = ET.SubElement(mv, "InlineTable")
            for i, cat in enumerate(cc.bin_category or []):
                row = ET.SubElement(table, "row")
                ET.SubElement(row, "in").text = str(cat)
                ET.SubElement(row, "out").text = str(i)
        else:
            bounds = cc.bin_boundary or []
            disc = ET.SubElement(df, "Discretize", {
                "field": cc.columnName, "dataType": "integer",
                "defaultValue": str(nb), "mapMissingTo": str(nb)})
            for i in range(len(bounds)):
                b = ET.SubElement(disc, "DiscretizeBin", {"binValue": str(i)})
                iv = {"closure": "closedOpen"}
                if np.isfinite(bounds[i]):
                    iv["leftMargin"] = f"{bounds[i]:.6g}"
                if i + 1 < len(bounds) and np.isfinite(bounds[i + 1]):
                    iv["rightMargin"] = f"{bounds[i + 1]:.6g}"
                ET.SubElement(b, "Interval", iv)


def _logistic_output(mm: ET.Element) -> None:
    out = ET.SubElement(mm, "Output")
    ET.SubElement(out, "OutputField", {"name": "rawSum", "optype": "continuous",
                                       "dataType": "double",
                                       "feature": "predictedValue"})
    of = ET.SubElement(out, "OutputField", {"name": "score",
                                            "optype": "continuous",
                                            "dataType": "double",
                                            "feature": "transformedValue"})
    div = ET.SubElement(of, "Apply", {"function": "/"})
    ET.SubElement(div, "Constant").text = "1"
    plus = ET.SubElement(div, "Apply", {"function": "+"})
    ET.SubElement(plus, "Constant").text = "1"
    expo = ET.SubElement(plus, "Apply", {"function": "exp"})
    neg = ET.SubElement(expo, "Apply", {"function": "*"})
    ET.SubElement(neg, "Constant").text = "-1"
    ET.SubElement(neg, "FieldRef", {"field": "rawSum"})


def _emit_tree_node(parent: ET.Element, t, node: int, col_by_idx,
                    scale: float) -> None:
    feat = int(t.split_feat[node]) if node < len(t.split_feat) else -1
    parent.set("score", f"{float(t.leaf_value[node]) * scale:.6f}")
    if feat < 0:
        return
    cc = col_by_idx.get(feat)
    fname = cc.columnName if cc else f"feature_{feat}"
    left_bins = [str(b) for b in np.flatnonzero(t.left_mask[node])]
    for child, bins_attr in ((2 * node + 1, left_bins), (2 * node + 2, None)):
        n = ET.SubElement(parent, "Node", {"id": str(child), "score": "0"})
        if bins_attr is not None:
            pred = ET.SubElement(n, "SimpleSetPredicate",
                                 {"field": f"bin({fname})",
                                  "booleanOperator": "isIn"})
            arr = ET.SubElement(pred, "Array",
                                {"type": "int", "n": str(len(bins_attr))})
            arr.text = " ".join(bins_attr)
        else:
            ET.SubElement(n, "True")
        _emit_tree_node(n, t, child, col_by_idx, scale)


def _pmml_act(name: str) -> str:
    m = {"sigmoid": "logistic", "tanh": "tanh", "relu": "rectifier",
         "linear": "identity", "leakyrelu": "rectifier", "swish": "rectifier",
         "ptanh": "tanh"}
    return m.get((name or "sigmoid").lower(), "logistic")


def write_pmml(tree: ET.ElementTree, path: str) -> None:
    ET.indent(tree, space="  ")
    tree.write(path, xml_declaration=True, encoding="utf-8")
