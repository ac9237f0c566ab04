"""Writers for the reference's serialized model formats — the port's copy
of ``shifu_tpu.export.reference_spec`` (host-side byte streams, no device
work).

The mirror of :mod:`shifu_tpu_torch.models.reference_import`: emit trained
models
in the byte formats the reference's dependency-free Java consumers load in
production —

- ``model*.nn``: Encog 3.0 EG text (``PersistBasicFloatNetwork`` layout,
  the format ``core/alg/NNTrainer.java`` persists and the reference's
  bundled example models ship in, e.g.
  ``src/test/resources/model/model0.nn``);
- ``model*.gbt`` / ``model*.rf``: gzipped ``BinaryDTSerializer`` version-4
  forests (``core/dtrain/dt/BinaryDTSerializer.java:60-160``), loadable by
  ``dt/IndependentTreeModel.java:887-1075`` and ``shifu convert``;
- ``model*.wdl``: gzipped ``BinaryWDLSerializer`` streams
  (``core/dtrain/wdl/BinaryWDLSerializer.java:66-125``), loadable by
  ``wdl/IndependentWDLModel.loadFromStream``.

Round-trip oracle: ``models/reference_import.py`` re-reads every format,
and ``tests/test_torch_export.py`` and ``tests/test_torch_wdl.py`` pin the
payloads to the reference's.  The gzip header carries the time of
writing, so two writes of one model differ in those bytes only: compare
decompressed payloads.

Semantics note (inherent format difference, not a bug): our trees route a
MISSING numeric value through its own bin, while the reference format can
only impute missing to the column mean before walking
(``IndependentTreeModel.predictNode`` line 524).  Exported trees therefore
score identically on rows whose numeric values are present; rows with
missing numerics follow the reference's mean-imputation path.  Categorical
missing is exact either way (the reference's missing bucket
``index == categoricalSize`` maps 1:1 onto our missing bin).
"""

from __future__ import annotations

import gzip
import io
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import ioutil
from ..config.errors import ErrorCode, ShifuError
from ..models.nn import NNModelSpec
from ..models.tree import TreeModelSpec
from ..ops.tree import TreeArrays

# ----------------------------------------------------------- Encog EG (.nn)

_EG_ACT_NAMES = {
    "sigmoid": "ActivationSigmoid",
    "tanh": "ActivationTANH",
    "linear": "ActivationLinear",
    "relu": "ActivationReLU",
    "log": "ActivationLOG",
    "sin": "ActivationSIN",
}


def _eg_float(x: float) -> str:
    """Java ``Double.toString``-ish rendering: repr keeps round-trip
    precision; Encog's CSVFormat parses plain decimal/scientific forms."""
    return repr(float(x))


def write_encog_nn(path: str, spec: NNModelSpec, params: List[Dict]) -> None:
    """Write our NN params as an Encog 3.0 EG BasicNetwork text file.

    Layout (mirrors the reference's persisted models, e.g.
    ``src/test/resources/model/model0.nn``): layers stored OUTPUT-FIRST;
    ``layerCounts`` include one bias neuron everywhere but the output
    layer; each weight block is ``[feedCounts[L-1], layerCounts[L]]``
    row-major with the bias column last.  ``models.reference_import.
    load_encog_nn`` is the round-trip reader.
    """
    acts = [a.lower() for a in spec.activations]
    bad = [a for a in set(acts + [spec.output_activation.lower()])
           if a not in _EG_ACT_NAMES]
    if bad:
        raise ShifuError(ErrorCode.ERROR_UNSUPPORT_ALG,
                         f"activation(s) {bad} have no Encog equivalent — "
                         "EG export supports sigmoid/tanh/linear/relu/log/sin")
    # output-first structural arrays
    feed = [spec.output_dim] + list(reversed(spec.hidden_nodes)) \
        + [spec.input_dim]
    n_layers = len(feed)
    counts = [feed[0]] + [f + 1 for f in feed[1:]]       # bias everywhere
    bias_act = [0.0] + [1.0] * (n_layers - 1)            # but the output
    layer_index = [0]
    for c in counts[:-1]:
        layer_index.append(layer_index[-1] + c)
    # weight blocks output-first: block L-1 reads layer L (incl. bias)
    blocks: List[np.ndarray] = []
    for layer in range(1, n_layers):
        p = params[n_layers - 1 - layer]                 # params input-first
        w = np.asarray(p["w"], np.float64)               # [in, out]
        b = np.asarray(p["b"], np.float64)               # [out]
        blocks.append(np.concatenate([w.T, b[:, None]], axis=1))
    weights = np.concatenate([blk.reshape(-1) for blk in blocks])
    w_index = [0]
    for blk in blocks:
        w_index.append(w_index[-1] + blk.size)
    # layerOutput: bias neurons emit their biasActivation, others 0
    output = []
    for li, c in enumerate(counts):
        output.extend([0.0] * feed[li] + [1.0] * (c - feed[li]))
    act_names = [_EG_ACT_NAMES[spec.output_activation.lower()]] \
        + [_EG_ACT_NAMES[a] for a in reversed(acts)] \
        + [_EG_ACT_NAMES["linear"]]                      # input layer

    def ints(v):
        return ",".join(str(int(x)) for x in v)

    lines = [
        "encog,BasicNetwork,java,3.0.0,1,0",
        "[BASIC]",
        "[BASIC:PARAMS]",
        "[BASIC:NETWORK]",
        "beginTraining=0",
        "connectionLimit=0",
        "contextTargetOffset=" + ints([0] * n_layers),
        "contextTargetSize=" + ints([0] * n_layers),
        f"endTraining={n_layers - 1}",
        "hasContext=f",
        f"inputCount={spec.input_dim}",
        "layerCounts=" + ints(counts),
        "layerFeedCounts=" + ints(feed),
        "layerContextCount=" + ints([0] * n_layers),
        "layerIndex=" + ints(layer_index),
        "output=" + ",".join(_eg_float(x) if x else "0" for x in output),
        f"outputCount={spec.output_dim}",
        "weightIndex=" + ints(w_index),
        "weights=" + ",".join(_eg_float(x) for x in weights),
        "biasActivation=" + ",".join("1" if b else "0" for b in bias_act),
        "[BASIC:ACTIVATION]",
    ] + [f'"{n}"' for n in act_names]
    ioutil.atomic_write_text(path, "\n".join(lines) + "\n")


# ------------------------------------------- BinaryDTSerializer (.gbt/.rf)

class _JavaDataOutput:
    """DataOutput writer for the subset BinaryDTSerializer emits."""

    def __init__(self):
        self._b = io.BytesIO()

    def write_int(self, v: int) -> None:
        self._b.write(struct.pack(">i", int(v)))

    def write_short(self, v: int) -> None:
        self._b.write(struct.pack(">h", int(v)))

    def write_byte(self, v: int) -> None:
        self._b.write(struct.pack(">b", int(v)))

    def write_boolean(self, v: bool) -> None:
        self._b.write(b"\x01" if v else b"\x00")

    def write_double(self, v: float) -> None:
        self._b.write(struct.pack(">d", float(v)))

    def write_float(self, v: float) -> None:
        self._b.write(struct.pack(">f", float(v)))

    def write_utf(self, s: str) -> None:
        data = s.encode("utf-8")
        self._b.write(struct.pack(">H", len(data)))
        self._b.write(data)

    def write_category(self, s: str, max_len: int = 10000) -> None:
        """``BinaryDTSerializer`` category entry: plain writeUTF below the
        reference's ``MAX_CATEGORICAL_VAL_LEN``, else the -1 short marker +
        int length + raw bytes (the 16k writeUTF limit workaround)."""
        if len(s) < max_len:
            self.write_utf(s)
        else:
            data = s.encode("utf-8")
            self.write_short(-1)
            self.write_int(len(data))
            self._b.write(data)

    def getvalue(self) -> bytes:
        return self._b.getvalue()


def _write_bitset(d: _JavaDataOutput, cats: Sequence[int],
                  n_categories: int) -> None:
    """``SimpleBitSet.write``: byte-word count then words, bit ``i%8`` of
    word ``i/8`` = category index ``i`` (sized like the Java side: one
    spare slot past the category count, the missing bucket)."""
    n_words = (n_categories + 1 + 7) // 8 + 1
    words = bytearray(n_words)
    for c in cats:
        words[c // 8] |= (1 << (c % 8))
    d.write_int(n_words)
    for w in words:
        d.write_byte(w if w < 128 else w - 256)


def _write_node(d: _JavaDataOutput, trees_idx: int, spec: TreeModelSpec,
                tree: TreeArrays, i: int, col_info: Dict[int, dict]) -> None:
    """Recursive ``Node.write`` (``dt/Node.java:583-624``): array slot
    ``i`` maps to the reference's heap node id ``i + 1`` (root=1, left of
    id j = 2j, right = 2j+1 — exactly our complete-array children
    2i+1/2i+2)."""
    total = len(tree.split_feat)
    sf = int(tree.split_feat[i])
    is_leaf = sf < 0 or (2 * i + 2) >= total
    d.write_int(i + 1)                                   # node id
    d.write_float(0.0)                                   # gain (not stored)
    d.write_double(0.0)                                  # wgtCnt (not stored)
    if is_leaf:
        d.write_boolean(False)                           # no split
    else:
        info = col_info[sf]
        d.write_boolean(True)
        d.write_int(info["column_num"])                  # Split.write
        lm = np.asarray(tree.left_mask[i])
        if info["categories"] is not None:
            cats = info["categories"]
            nb = len(cats)
            d.write_byte(2)                              # CATEGORICAL
            left_cats = [b for b in range(nb) if lm[b]]
            if nb < len(lm) and lm[nb]:
                # missing bin goes LEFT: the format routes missing to the
                # non-bitset side, so store the RIGHT categories instead
                d.write_boolean(False)                   # isLeft = False
                right_cats = [b for b in range(nb) if not lm[b]]
                d.write_boolean(False)                   # categories != null
                _write_bitset(d, right_cats, nb)
            else:
                d.write_boolean(True)                    # isLeft = True
                d.write_boolean(False)                   # categories != null
                _write_bitset(d, left_cats, nb)
        else:
            d.write_byte(1)                              # CONTINUOUS
            bnd = info["boundaries"]
            nb = len(bnd)
            ks = [b for b in range(min(nb, len(lm))) if lm[b]]
            k = max(ks) if ks else -1
            # left bins 0..k ⟺ value < boundaries[k+1] (bin b spans
            # [bnd[b], bnd[b+1]) with bnd[0] = -inf)
            if k < 0:
                thr = float(bnd[0]) if nb else float("-inf")
            elif k + 1 < nb:
                thr = float(bnd[k + 1])
            else:
                thr = float("inf")                       # every value left
            d.write_double(thr)
    d.write_boolean(is_leaf)                             # isRealLeaf
    if is_leaf:
        d.write_boolean(True)                            # predict != null
        lv = np.asarray(tree.leaf_value[i])
        d.write_double(float(lv))                        # Predict.write
        d.write_byte(0)                                  # classValue
        d.write_boolean(False)                           # no left child
        d.write_boolean(False)                           # no right child
    else:
        d.write_boolean(True)
        _write_node(d, trees_idx, spec, tree, 2 * i + 1, col_info)
        d.write_boolean(True)
        _write_node(d, trees_idx, spec, tree, 2 * i + 2, col_info)


def _leaf_only_tree(predict: float) -> TreeArrays:
    """A root-leaf tree carrying a constant — the GBT prior ``f_0``
    becomes tree 0 with learningRate 1 (the format has no init slot)."""
    return TreeArrays(split_feat=np.full(1, -1, np.int32),
                      left_mask=np.zeros((1, 1), bool),
                      leaf_value=np.asarray([predict], np.float32), depth=0)


def write_reference_tree(path: str, spec: TreeModelSpec,
                         trees: List[TreeArrays], column_configs,
                         bags: Optional[List[List[TreeArrays]]] = None) -> None:
    """Write a forest as a gzipped ``BinaryDTSerializer`` version-4 stream
    (``BinaryDTSerializer.java:60-160``), loadable by the reference's
    ``IndependentTreeModel`` and by ``models.reference_import.
    load_reference_tree`` (the round-trip oracle).

    ``spec.column_nums[j]`` maps dense feature ``j`` to its columnNum;
    boundaries/categories come from the matching ColumnConfig (exactly the
    maps the Java writer takes from its ColumnConfig list).
    """
    if (spec.extra or {}).get("n_classes", 0) > 2:
        raise ShifuError(
            ErrorCode.ERROR_UNSUPPORT_ALG,
            "NATIVE multiclass forests have no BinaryDTSerializer layout "
            "(the reference trains multiclass trees as OVA) — export the "
            "OVA members instead")
    if spec.column_nums is None:
        raise ShifuError(ErrorCode.ERROR_MODEL_FILE_NOT_FOUND,
                         "tree spec lacks column_nums — retrain or pass "
                         "ColumnConfig-ordered features")
    by_num = {cc.columnNum: cc for cc in column_configs}
    col_info: Dict[int, dict] = {}
    for j, num in enumerate(spec.column_nums):
        cc = by_num[num]
        if cc.is_categorical():
            col_info[j] = {"column_num": num, "categories":
                           list(cc.bin_category or []), "boundaries": None}
        else:
            col_info[j] = {"column_num": num, "categories": None,
                           "boundaries": list(cc.bin_boundary or [])}

    d = _JavaDataOutput()
    d.write_int(4)                                       # TREE_FORMAT_VERSION
    d.write_utf(spec.algorithm)
    d.write_utf(spec.loss)
    d.write_boolean(False)                               # isClassification
    d.write_boolean(False)                               # isOneVsAll
    d.write_int(len(spec.column_nums))                   # inputCount

    selected = [by_num[n] for n in spec.column_nums]
    num_means = [(cc.columnNum, float(cc.columnStats.mean or 0.0))
                 for cc in column_configs
                 if not cc.is_categorical() and cc.columnStats.mean is not None]
    d.write_int(len(num_means))
    for num, mean in num_means:
        d.write_int(num)
        d.write_double(mean)
    d.write_int(len(selected))                           # columnIndexName
    for cc in selected:
        d.write_int(cc.columnNum)
        d.write_utf(cc.columnName)
    cats_cols = [cc for cc in column_configs
                 if cc.is_categorical() and cc.bin_category]
    d.write_int(len(cats_cols))
    for cc in cats_cols:
        d.write_int(cc.columnNum)
        cats = list(cc.bin_category)
        d.write_int(len(cats))
        for cat in cats:
            d.write_category(cat)
    d.write_int(len(spec.column_nums))                   # columnMapping
    for j, num in enumerate(spec.column_nums):
        d.write_int(num)
        d.write_int(j)

    if bags is None:
        out_trees = list(trees)
        if spec.algorithm == "GBT":
            # the format has no f_0 slot: the prior rides as a root-leaf
            # tree 0 with learningRate 1 (sum lr_i * predict_i reproduces
            # init_score + lr * sum predict exactly)
            out_trees = [_leaf_only_tree(spec.init_score)] + out_trees
        bags = [out_trees]
    d.write_int(len(bags))                               # version >= 4
    for bag in bags:
        d.write_int(len(bag))
        for t_i, tree in enumerate(bag):
            d.write_int(t_i)                             # treeId
            total = len(tree.split_feat)
            d.write_int(int(np.sum(np.asarray(tree.split_feat) >= 0)) * 2
                        + 1)                             # nodeNum
            _write_node(d, t_i, spec, tree, 0, col_info)
            is_prior = (spec.algorithm == "GBT" and t_i == 0
                        and total == 1)
            d.write_double(1.0 if spec.algorithm != "GBT" or is_prior
                           else spec.learning_rate)      # learningRate
            d.write_double(0.0)                          # rootWgtCnt (id 1)
            d.write_int(0)                               # per-tree features
    ioutil.atomic_write_bytes(path, gzip.compress(d.getvalue()))


# --------------------------------------- BinaryWDLSerializer (.wdl)

_WDL_ACTS = {"relu", "sigmoid"}         # reference buildHiddenLayers set


def _write_java_string(d: _JavaDataOutput, s: Optional[str]) -> None:
    """``dtrain/StringUtils.writeString``: int byte-length + raw UTF-8
    (0 = null), not writeUTF."""
    if not s:
        d.write_int(0)
        return
    data = s.encode("utf-8")
    d.write_int(len(data))
    d._b.write(data)


def _write_double_list(d: _JavaDataOutput, vals) -> None:
    """``NNColumnStats.writeDoubleList``: int count + doubles (0 = null)."""
    if vals is None:
        d.write_int(0)
        return
    vals = [0.0 if v is None else float(v) for v in vals]
    d.write_int(len(vals))
    for v in vals:
        d.write_double(v)


def _woe_mean_std(woes, neg, pos):
    """``Normalizer.calculateWoeMeanAndStdDev``: bin-count-weighted WOE
    mean and standard deviation (``core/Normalizer.java:728-754``)."""
    if not woes or len(woes) < 2 or not neg:
        return 0.0, 0.0
    w = np.asarray([0.0 if x is None else float(x) for x in woes])
    cnt = np.asarray(neg, np.float64) + np.asarray(pos, np.float64)
    total = cnt.sum()
    if total <= 1:
        return 0.0, 0.0
    s = float((w * cnt).sum())
    sq = float((w * w * cnt).sum())
    mean = s / total
    std = float(np.sqrt(abs((sq - s * s / total) / (total - 1))))
    return mean, std


def _write_floats(d: _JavaDataOutput, a: np.ndarray) -> None:
    """A big-endian f32 block in one buffer write."""
    d._b.write(np.ascontiguousarray(a, ">f4").tobytes())


def _write_dense_layer(d: _JavaDataOutput, w: np.ndarray, b: np.ndarray,
                       l2reg: float = 0.0) -> None:
    """``wdl/DenseLayer.write`` (WEIGHTS/MODEL_SPEC): l2reg, in, out,
    presence-flagged weights [in][out], then bias [out]."""
    w = np.asarray(w, np.float32)
    b = np.asarray(b, np.float32).reshape(-1)
    d.write_float(l2reg)
    d.write_int(w.shape[0])
    d.write_int(w.shape[1])
    d.write_boolean(True)
    _write_floats(d, w)
    d.write_boolean(True)
    _write_floats(d, b)


def write_reference_wdl(path: str, spec, params: Dict,
                        column_configs=None, norm_type: str = "ZSCALE",
                        cutoff: float = 4.0) -> None:
    """Write a WDL model (``models.wdl``'s spec and params, flat tables)
    as a gzipped ``BinaryWDLSerializer`` stream
    (``core/dtrain/wdl/BinaryWDLSerializer.java:66-125``), the format
    ``IndependentWDLModel.loadFromStream`` reads: version, reserved
    fields, the normType string, ``NNColumnStats`` a column, then the
    ``WideAndDeep`` graph as Bytable MODEL_SPEC (``WideAndDeep.java:
    558-621``).  ``models.reference_import.load_reference_wdl`` is the
    round-trip oracle."""
    from ..models.wdl import columns_of
    bad = [a for a in spec.activations if a.lower() not in _WDL_ACTS]
    if bad:
        raise ShifuError(ErrorCode.ERROR_UNSUPPORT_ALG,
                         f"activation(s) {bad}: the reference WDL runtime "
                         "only builds relu/sigmoid hidden activations")
    if not (spec.deep_enable and spec.wide_enable):
        raise ShifuError(ErrorCode.ERROR_UNSUPPORT_ALG,
                         "reference WideAndDeep scoring walks BOTH planes — "
                         "wide-only/deep-only specs have no faithful layout")
    cols = columns_of(spec, params)
    n_cat = len(spec.cat_cardinalities)
    cat_ids = list(spec.cat_column_nums or range(n_cat))
    num_ids = list(spec.column_nums or range(spec.numeric_dim))

    d = _JavaDataOutput()
    d.write_int(1)                                  # WDL_FORMAT_VERSION
    d.write_float(0.0)                              # reserved
    d.write_float(0.0)
    d.write_double(0.0)
    d.write_utf("Reserved field")
    _write_java_string(d, norm_type)

    by_num = {cc.columnNum: cc for cc in (column_configs or [])}
    cs_nums = [n for n in num_ids + cat_ids if n in by_num]
    d.write_int(len(cs_nums))
    for num in cs_nums:                             # NNColumnStats.write
        cc = by_num[num]
        st, bn = cc.columnStats, cc.columnBinning
        d.write_int(num)
        _write_java_string(d, cc.columnName)
        d.write_byte(2 if cc.is_categorical() else 1)   # ColumnType C/N
        d.write_double(cutoff)
        d.write_double(st.mean or 0.0)
        d.write_double(st.stdDev or 0.0)
        wm, ws = _woe_mean_std(bn.binCountWoe, bn.binCountNeg, bn.binCountPos)
        d.write_double(wm)
        d.write_double(ws)
        wwm, wws = _woe_mean_std(bn.binWeightedWoe, bn.binCountNeg,
                                 bn.binCountPos)
        d.write_double(wwm)
        d.write_double(wws)
        _write_double_list(d, None if cc.is_categorical() else bn.binBoundary)
        cats = bn.binCategory or []
        d.write_int(len(cats))
        for cat in cats:
            _write_java_string(d, cat)
        _write_double_list(d, bn.binPosRate)
        _write_double_list(d, bn.binCountWoe)
        _write_double_list(d, bn.binWeightedWoe)

    # ---- WideAndDeep.write, serializationType = MODEL_SPEC
    deep = cols["deep"]
    d.write_int(2)                                  # MODEL_SPEC
    d.write_boolean(True)                           # DenseInputLayer
    d.write_int(spec.numeric_dim)
    d.write_int(len(deep) - 1)                      # hidden DenseLayers
    for p in deep[:-1]:
        _write_dense_layer(d, p["w"], p["b"])
    d.write_boolean(True)                           # finalLayer
    _write_dense_layer(d, deep[-1]["w"], deep[-1]["b"])
    d.write_boolean(True)                           # EmbedLayer
    d.write_int(n_cat)
    for i, tab in enumerate(cols["embed"]):         # EmbedFieldLayer.write
        d.write_int(cat_ids[i])
        d.write_int(tab.shape[0])
        d.write_int(tab.shape[1])
        d.write_boolean(True)
        _write_floats(d, tab)
    d.write_boolean(True)                           # WideLayer
    d.write_int(n_cat)
    for i, wvec in enumerate(cols["wide_cat"]):     # WideFieldLayer.write
        d.write_int(cat_ids[i])
        d.write_float(0.0)                          # l2reg
        d.write_int(len(wvec))
        d.write_boolean(True)
        _write_floats(d, wvec)
    d.write_boolean(True)                           # wide dense (numeric)
    _write_dense_layer(d, cols["wide_num"], np.zeros(1, np.float32))
    d.write_boolean(True)                           # BiasLayer
    d.write_float(float(cols["bias"].reshape(-1)[0]))
    d.write_int(len(spec.activations))              # actiFuncs
    for a in spec.activations:
        d.write_utf(a.lower())
    # MODEL_SPEC extras
    d.write_int(n_cat)                              # idBinCateSizeMap
    for i, card in enumerate(spec.cat_cardinalities):
        d.write_int(cat_ids[i])
        d.write_int(int(card))
    d.write_int(spec.numeric_dim)
    for ids in (num_ids, cat_ids,
                [spec.embed_dim] * n_cat, cat_ids, list(spec.hidden_nodes)):
        d.write_int(len(ids))                       # SerializationUtil list
        for v in ids:
            d.write_int(int(v))
    d.write_float(0.0)                              # l2reg
    ioutil.atomic_write_bytes(path, gzip.compress(d.getvalue()))
