"""Importers for the reference's serialized model formats — the port's
copy of ``shifu_tpu.models.reference_import`` (host-side parsers; the
float64 tree scorer is numpy, as the reference's is).  Encog weights and
``BinaryWDLSerializer`` tables come back as the port's float32 host
tensors, ready for :class:`~shifu_tpu_torch.models.nn.IndependentNNModel`
and :class:`~shifu_tpu_torch.models.wdl.IndependentWDLModel` on either
device.

Three formats are read: the reference's production model files, which
its dependency-free Java consumers load —

- Encog EG text networks (``*.nn``) written by Encog 3.0's persistence
  (reference ``PersistBasicFloatNetwork`` / ``core/alg/NNTrainer.java``),
  e.g. ``example/cancer-judgement/ModelStore/ModelSet1/models/model*.nn``.
- Binary tree forests (``*.gbt`` / ``*.rf``) written by
  ``core/dtrain/dt/BinaryDTSerializer.java:60-160`` and read back by
  ``dt/IndependentTreeModel.java:887-1075`` (version >= 3, optionally
  gzipped), e.g. ``example/readablespec/model0.gbt``.
- Wide-and-deep streams (``*.wdl``) written by
  ``core/dtrain/wdl/BinaryWDLSerializer.java:66-125``.

Reading them back is the round-trip oracle of ``export -t spec``: the
exported forest, re-read here, scores as the native forest does.

The importers map onto our native structures where shapes allow (Encog MLP
-> ``models.nn.NNModelSpec`` params) and keep a faithful node-walk scorer
where they don't (reference trees split on raw values, our ``TreeArrays``
split on bin indices).
"""

from __future__ import annotations

import gzip
import io
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .nn import NNModelSpec

# -------------------------------------------------- reference fixture data

def load_reference_psv(data_path: str, header_path: str,
                       delimiter: str = "|") -> Dict[str, np.ndarray]:
    """Load a reference example data file (``.pig_header`` + part file)
    into per-column string arrays."""
    with open(header_path) as f:
        header = f.read().strip().split(delimiter)
    rows = [ln.rstrip("\n").split(delimiter)
            for ln in open(data_path) if ln.strip()]
    return {name: np.array([r[i] for r in rows])
            for i, name in enumerate(header)}


def zscore_matrix(cols: Dict[str, np.ndarray], column_configs,
                  cutoff: float = 4.0):
    """(z, raw_by_columnNum): zscore-with-cutoff matrix over final-selected
    columns using the reference ColumnConfig's own mean/stdDev (the eval
    normalization ``core/Normalizer.java:124-287`` applies), plus the raw
    per-columnNum values trees consume."""
    selected = [c for c in column_configs if c.finalSelect]
    n = len(next(iter(cols.values())))
    z = np.zeros((n, len(selected)), np.float32)
    raw: Dict[int, np.ndarray] = {}
    for j, cc in enumerate(selected):
        v = np.array([float(x) if x not in ("", "NA") else np.nan
                      for x in cols[cc.columnName]])
        raw[cc.columnNum] = v
        mean, std = cc.columnStats.mean, cc.columnStats.stdDev
        zz = (np.where(np.isfinite(v), v, mean) - mean) / max(std, 1e-12)
        z[:, j] = np.clip(zz, -cutoff, cutoff)
    return z, raw


# --------------------------------------------------------------- Encog EG

_EG_ACTIVATIONS = {
    "ActivationSigmoid": "sigmoid",
    "ActivationTANH": "tanh",
    "ActivationLinear": "linear",
    "ActivationReLU": "relu",
    "ActivationLOG": "log",
    "ActivationSIN": "sin",
    "ActivationElliott": "sigmoid",      # closest; not used by reference models
}


def _parse_eg_sections(text: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    current = None
    for raw in text.splitlines():
        line = raw.strip("\r\n")
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            current = line[1:-1]
            sections[current] = []
        elif current is not None:
            sections[current].append(line)
    return sections


def load_encog_nn(path: str) -> Tuple[NNModelSpec, List[Dict]]:
    """Parse an Encog EG text network into our NN params (float32 host
    tensors).

    Encog stores layers output-first (``layerCounts[0]`` = output layer) with
    per-layer flat weight blocks at ``weightIndex``; each block is
    ``[feedCounts[L-1], layerCounts[L]]`` row-major, the trailing column being
    the bias neuron's weight (bias output = ``biasActivation[L]``).  We
    transpose into our input-first ``[{"w": [in,out], "b": [out]}, ...]``.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    if not text.startswith("encog,BasicNetwork"):
        raise ValueError(f"{path}: not an Encog EG BasicNetwork file")
    sections = _parse_eg_sections(text)
    kv: Dict[str, str] = {}
    for line in sections.get("BASIC:NETWORK", []):
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k] = v

    def ints(key: str) -> List[int]:
        return [int(t) for t in kv[key].split(",") if t != ""]

    def floats(key: str) -> List[float]:
        return [float(t) for t in kv[key].split(",") if t != ""]

    layer_counts = ints("layerCounts")          # output-first, incl. bias
    feed_counts = ints("layerFeedCounts")       # output-first, excl. bias
    weight_index = ints("weightIndex")
    weights = np.asarray(floats("weights"), np.float64)
    bias_act = floats("biasActivation")
    n_layers = len(layer_counts)

    acts = [ln.strip().strip('"') for ln in sections.get("BASIC:ACTIVATION", [])
            if ln.strip().strip('"')]

    params: List[Dict] = []
    spec_acts: List[str] = []
    # walk input layer (index n-1) down to the output layer (index 0)
    for layer in range(n_layers - 1, 0, -1):
        out_feed = feed_counts[layer - 1]
        in_count = layer_counts[layer]
        in_feed = feed_counts[layer]
        start = weight_index[layer - 1]
        block = weights[start:start + out_feed * in_count]
        block = block.reshape(out_feed, in_count)
        w = block[:, :in_feed].T.astype(np.float32)           # [in, out]
        if in_count > in_feed:                                # bias neuron
            b = (block[:, in_feed] * bias_act[layer]).astype(np.float32)
        else:
            b = np.zeros(out_feed, np.float32)
        params.append({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
        act_name = _EG_ACTIVATIONS.get(acts[layer - 1], "sigmoid") \
            if layer - 1 < len(acts) else "sigmoid"
        spec_acts.append(act_name)

    spec = NNModelSpec(
        input_dim=feed_counts[-1],
        hidden_nodes=[feed_counts[i] for i in range(n_layers - 2, 0, -1)],
        activations=spec_acts[:-1] or ["sigmoid"],
        output_dim=feed_counts[0],
        output_activation=spec_acts[-1],
        extra={"source": "encog-eg"})
    return spec, params


# ----------------------------------------------------- binary tree forest

@dataclass
class RefNode:
    node_id: int
    gain: float
    wgt_cnt: float
    split_column: int = -1
    split_type: int = 1                 # Split.java:63-64 — 1 CONTINUOUS, 2 CATEGORICAL
    threshold: float = 0.0
    cat_is_left: bool = False
    cat_set: Optional[set] = None       # short category indices
    predict: float = 0.0
    is_leaf: bool = True
    left: Optional["RefNode"] = None
    right: Optional["RefNode"] = None


@dataclass
class RefTreeModel:
    """Parsed reference forest + faithful scorer.

    Scoring mirrors ``IndependentTreeModel.computeRegressionScore``
    (``IndependentTreeModel.java:387-443``): per bag, GBT sums
    ``learning_rate_i * predict_i`` and the final score is the bag mean;
    RF computes ``sum(w_i * predict_i) / sum(w_i)`` per bag, then the bag
    mean.  Numeric splits go left when ``value < threshold`` (missing ->
    column mean first, ``predictNode`` line 524); categorical values are
    category indices, with missing/out-of-range mapped to the dedicated
    missing bucket ``index == categoricalSize`` (lines 530-537) which is
    never inside a split's bitset.
    """
    version: int
    algorithm: str                       # "GBT" | "RF"
    loss: str
    is_classification: bool
    is_one_vs_all: bool
    input_count: int
    mean_by_column: Dict[int, float]
    name_by_column: Dict[int, str]
    categories_by_column: Dict[int, List[str]]
    column_mapping: Dict[int, int]       # columnNum -> dense input index
    bags: List[List[RefNode]] = field(default_factory=list)
    bag_weights: List[List[float]] = field(default_factory=list)

    @property
    def trees(self) -> List[RefNode]:
        return [t for bag in self.bags for t in bag]

    @property
    def tree_weights(self) -> List[float]:
        return [w for bag in self.bag_weights for w in bag]

    def _score_node(self, node: RefNode, x: np.ndarray,
                    idx: np.ndarray, out: np.ndarray) -> None:
        if node.is_leaf or node.left is None or node.right is None:
            out[idx] = node.predict
            return
        col = self.column_mapping.get(node.split_column, node.split_column)
        v = x[idx, col]
        if node.split_type != 2:
            go_left = v < node.threshold
        else:
            cat_size = len(self.categories_by_column.get(node.split_column, ()))
            # missing/out-of-range -> missing bucket index == cat_size
            iv = np.where((v < 0) | (v >= cat_size) | ~np.isfinite(v),
                          float(cat_size), v) + 0.1
            cats = node.cat_set or set()
            in_set = np.isin(iv.astype(np.int64), list(cats) or [-1])
            go_left = in_set if node.cat_is_left else ~in_set
        self._score_node(node.left, x, idx[go_left], out)
        self._score_node(node.right, x, idx[~go_left], out)

    def compute(self, x_by_column: Dict[int, np.ndarray]) -> np.ndarray:
        """Score rows given per-columnNum raw value arrays (missing=NaN;
        categorical columns carry category indices)."""
        n = len(next(iter(x_by_column.values())))
        width = max(self.column_mapping.values()) + 1 if self.column_mapping \
            else max(x_by_column) + 1
        x = np.full((n, width), np.nan)
        for col, dense in self.column_mapping.items():
            v = np.asarray(x_by_column.get(col, np.full(n, np.nan)), np.float64)
            if col not in self.categories_by_column:     # numeric: missing->mean
                mean = self.mean_by_column.get(col, 0.0)
                v = np.where(np.isfinite(v), v, mean)
            x[:, dense] = v
        total = np.zeros(n, np.float64)
        idx = np.arange(n)
        for bag, wgts in zip(self.bags, self.bag_weights):
            bag_score = np.zeros(n, np.float64)
            wsum = 0.0
            for tree, w in zip(bag, wgts):
                out = np.empty(n, np.float64)
                self._score_node(tree, x, idx, out)
                bag_score += w * out
                wsum += w
            if self.algorithm != "GBT":
                bag_score /= max(wsum, 1e-12)
            total += bag_score
        return total / max(len(self.bags), 1)


class _JavaDataInput:
    """DataInput reader for the subset BinaryDTSerializer uses."""

    def __init__(self, data: bytes):
        self._b = io.BytesIO(data)

    def _read(self, n: int) -> bytes:
        d = self._b.read(n)
        if len(d) != n:
            raise EOFError("truncated reference model stream")
        return d

    def read_int(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def read_short(self) -> int:
        return struct.unpack(">h", self._read(2))[0]

    def read_byte(self) -> int:
        return struct.unpack(">b", self._read(1))[0]

    def read_boolean(self) -> bool:
        return self._read(1) != b"\x00"

    def read_double(self) -> float:
        return struct.unpack(">d", self._read(8))[0]

    def read_float(self) -> float:
        return struct.unpack(">f", self._read(4))[0]

    def read_utf(self) -> str:
        ln = struct.unpack(">H", self._read(2))[0]
        return self._read(ln).decode("utf-8", errors="replace")

    def read_long_utf(self) -> str:
        """Category entry: short marker < 0 means int-length byte string
        (``IndependentTreeModel.readCategory``)."""
        marker = self.read_short()
        if marker < 0:
            ln = self.read_int()
            return self._read(ln).decode("utf-8", errors="replace")
        return self._read(marker).decode("utf-8", errors="replace")


def _read_bitset(d: _JavaDataInput) -> set:
    """``SimpleBitSet.readFields``: int word count then byte words; bit
    ``i%8`` of word ``i/8`` set means category index ``i`` is in the set."""
    n_words = d.read_int()
    out = set()
    for w in range(n_words):
        byte = d.read_byte() & 0xFF
        for bit in range(8):
            if byte & (1 << bit):
                out.add(w * 8 + bit)
    return out


def _read_node(d: _JavaDataInput, version: int) -> RefNode:
    node = RefNode(node_id=d.read_int(), gain=d.read_float(),
                   wgt_cnt=(d.read_double() if version > 2 else d.read_float()))
    if d.read_boolean():                                     # split present
        node.split_column = d.read_int()
        node.split_type = d.read_byte()
        if node.split_type == 2:                             # CATEGORICAL
            node.cat_is_left = d.read_boolean()
            if not d.read_boolean():                         # not null
                node.cat_set = _read_bitset(d)
        else:                                                # CONTINUOUS
            node.threshold = d.read_double()
    is_real_leaf = d.read_boolean()
    node.is_leaf = is_real_leaf
    if is_real_leaf and d.read_boolean():
        node.predict = d.read_double()
        d.read_byte()                                        # classValue
    if d.read_boolean():
        node.left = _read_node(d, version)
    if d.read_boolean():
        node.right = _read_node(d, version)
    return node


def load_reference_tree(path: str) -> RefTreeModel:
    """Parse a ``BinaryDTSerializer`` forest (version >= 3, gzip or plain)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    d = _JavaDataInput(raw)
    version = d.read_int()
    if version < 3:
        raise ValueError(f"{path}: reference tree model version {version} "
                         "< 3 is a legacy layout this importer does not read")
    algorithm = d.read_utf()
    loss = d.read_utf()
    is_classification = d.read_boolean()
    is_one_vs_all = d.read_boolean()
    input_count = d.read_int()

    mean_by_column = {}
    for _ in range(d.read_int()):
        col = d.read_int()
        mean_by_column[col] = d.read_double()
    name_by_column = {}
    for _ in range(d.read_int()):
        col = d.read_int()
        name_by_column[col] = d.read_utf()
    categories_by_column: Dict[int, List[str]] = {}
    for _ in range(d.read_int()):
        col = d.read_int()
        categories_by_column[col] = [d.read_long_utf()
                                     for _ in range(d.read_int())]
    column_mapping = {}
    for _ in range(d.read_int()):
        k = d.read_int()
        column_mapping[k] = d.read_int()

    model = RefTreeModel(version=version, algorithm=algorithm.upper(),
                         loss=loss, is_classification=is_classification,
                         is_one_vs_all=is_one_vs_all, input_count=input_count,
                         mean_by_column=mean_by_column,
                         name_by_column=name_by_column,
                         categories_by_column=categories_by_column,
                         column_mapping=column_mapping)

    bags = 1 if version < 4 else d.read_int()
    for _ in range(bags):
        bag_trees: List[RefNode] = []
        bag_wgts: List[float] = []
        for _ in range(d.read_int()):
            tree_id = d.read_int()                   # noqa: F841
            node_num = d.read_int()                  # noqa: F841
            root = _read_node(d, version)
            lr = d.read_double()
            if root.node_id == 1:                    # Node.ROOT_INDEX
                d.read_double()                      # rootWgtCnt
            # trailing per-tree feature list (TreeNode.readFields)
            n_feats = d.read_int()
            for _ in range(n_feats):
                d.read_int()
            bag_trees.append(root)
            bag_wgts.append(lr)
        model.bags.append(bag_trees)
        model.bag_weights.append(bag_wgts)
    return model


# -------------------------------------------------- WDL binary (.wdl)

def _read_java_string(d: _JavaDataInput) -> Optional[str]:
    """``dtrain/StringUtils.readString``: int byte-length + raw UTF-8
    (0 = null), not readUTF."""
    n = d.read_int()
    if n == 0:
        return None
    return d._read(n).decode("utf-8", errors="replace")


def _read_double_list(d: _JavaDataInput) -> List[float]:
    return [d.read_double() for _ in range(d.read_int())]


def _read_floats(d: _JavaDataInput, shape) -> np.ndarray:
    """A big-endian f32 block in one buffer read."""
    n = int(np.prod(shape))
    return np.frombuffer(d._read(4 * n), ">f4").reshape(shape) \
        .astype(np.float32)


def _read_wdl_dense(d: _JavaDataInput):
    """``wdl/DenseLayer.readFields`` (WEIGHTS/MODEL_SPEC): l2reg, in, out,
    presence-flagged weights [in][out] + bias [out]."""
    d.read_float()                                   # l2reg
    n_in, n_out = d.read_int(), d.read_int()
    w = _read_floats(d, (n_in, n_out)) if d.read_boolean() \
        else np.zeros((n_in, n_out), np.float32)
    b = _read_floats(d, (n_out,)) if d.read_boolean() \
        else np.zeros(n_out, np.float32)
    return w, b


def _expect(cond: bool, path: str, what: str) -> None:
    """An explicit stream-shape check (its reads must happen under
    ``python -O`` too)."""
    if not cond:
        raise ValueError(f"{path}: malformed WDL stream — {what}")


def load_reference_wdl(path: str):
    """Parse a ``BinaryWDLSerializer`` stream
    (``core/dtrain/wdl/BinaryWDLSerializer.java:66-125`` writer,
    ``IndependentWDLModel.loadFromStream:198-300`` reader) into
    ``(WDLModelSpec, params, column_stats)``, the params in
    ``models.wdl``'s flat layout: the round-trip oracle of
    ``export/reference_spec.write_reference_wdl``.  The reference scores
    ``sigmoid(wideLayer + finalLayer(deep))`` as ``models.wdl.forward``
    does (``WideAndDeep.java:163-199``)."""
    from .wdl import WDLModelSpec, from_columns

    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    d = _JavaDataInput(raw)
    version = d.read_int()
    if version != 1:
        raise ValueError(f"{path}: WDL format version {version} != 1")
    d.read_float()
    d.read_float()
    d.read_double()
    d.read_utf()
    norm_type = _read_java_string(d)
    col_stats: Dict[int, dict] = {}
    for _ in range(d.read_int()):                    # NNColumnStats
        num = d.read_int()
        name = _read_java_string(d)
        ctype = d.read_byte()
        cs = {"name": name, "type": ctype, "cutoff": d.read_double(),
              "mean": d.read_double(), "stddev": d.read_double(),
              "woe_mean": d.read_double(), "woe_stddev": d.read_double(),
              "woe_wgt_mean": d.read_double(),
              "woe_wgt_stddev": d.read_double(),
              "boundaries": _read_double_list(d)}
        cs["categories"] = [_read_java_string(d)
                            for _ in range(d.read_int())]
        cs["pos_rates"] = _read_double_list(d)
        cs["count_woes"] = _read_double_list(d)
        cs["weight_woes"] = _read_double_list(d)
        col_stats[num] = cs

    # ---- WideAndDeep.readFields (MODEL_SPEC)
    st = d.read_int()
    if st != 2:
        raise ValueError(f"{path}: serializationType {st} != MODEL_SPEC")
    _expect(d.read_boolean(), path, "null DenseInputLayer")
    numeric_dim = d.read_int()
    hidden = [_read_wdl_dense(d) for _ in range(d.read_int())]
    _expect(d.read_boolean(), path, "null finalLayer")
    final = _read_wdl_dense(d)
    _expect(d.read_boolean(), path, "null EmbedLayer")
    embed, embed_ids = [], []
    for _ in range(d.read_int()):
        cid, n_in, n_out = d.read_int(), d.read_int(), d.read_int()
        tab = _read_floats(d, (n_in, n_out)) if d.read_boolean() \
            else np.zeros((n_in, n_out), np.float32)
        embed.append(tab)
        embed_ids.append(cid)
    _expect(d.read_boolean(), path, "null WideLayer")
    wide_cat = []
    for _ in range(d.read_int()):                    # WideFieldLayer
        d.read_int()                                 # column id
        d.read_float()                               # l2reg
        n_in = d.read_int()
        wide_cat.append(_read_floats(d, (n_in,)) if d.read_boolean()
                        else np.zeros(n_in, np.float32))
    wide_num = np.zeros((numeric_dim, 1), np.float32)
    if d.read_boolean():                             # wide dense part
        wide_num, _ = _read_wdl_dense(d)
    bias = np.zeros(1, np.float32)
    if d.read_boolean():                             # BiasLayer
        bias = np.asarray([d.read_float()], np.float32)
    acts = [d.read_utf() for _ in range(d.read_int())]
    for _ in range(d.read_int()):                    # idBinCateSizeMap
        d.read_int()
        d.read_int()
    _expect(d.read_int() == numeric_dim, path, "numericalSize mismatch")
    num_ids = [d.read_int() for _ in range(d.read_int())]
    embed_ids2 = [d.read_int() for _ in range(d.read_int())]
    embed_outs = [d.read_int() for _ in range(d.read_int())]
    for _ in range(d.read_int()):                    # wide column ids
        d.read_int()
    hidden_nodes = [d.read_int() for _ in range(d.read_int())]
    d.read_float()                                   # l2reg

    spec = WDLModelSpec(
        numeric_dim=numeric_dim,
        cat_cardinalities=[t.shape[0] for t in embed],
        embed_dim=embed_outs[0] if embed_outs else
        (embed[0].shape[1] if embed else 8),
        hidden_nodes=hidden_nodes or [w.shape[1] for w, _ in hidden],
        activations=acts, column_nums=num_ids or None,
        cat_column_nums=embed_ids2 or embed_ids or None,
        extra={"source": "binary-wdl", "norm_type": norm_type})
    params = from_columns(spec, {
        "embed": embed,
        "deep": [{"w": w, "b": b} for w, b in hidden]
        + [{"w": final[0], "b": final[1]}],
        "wide_cat": wide_cat, "wide_num": wide_num, "bias": bias})
    return spec, params, col_stats
