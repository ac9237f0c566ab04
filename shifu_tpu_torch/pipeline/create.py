"""`new` + `init` steps — the port of ``shifu_tpu.pipeline.create``.

Reference: ``CreateModelProcessor.java`` (scaffold a model-set dir with a
template ModelConfig.json) and ``InitModelProcessor.java:74,89`` (build the
initial ColumnConfig.json from the header, with auto-type inference standing
in for the reference's HyperLogLog distinct-count MR job,
``InitModelProcessor.java:334-347``).  Both run on the host: ``init`` reads
and sketches text and computes nothing on a device.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from .. import DeviceLike
from ..config import (ColumnConfig, ColumnType, ModelConfig,
                      build_initial_column_configs)
from ..config.validator import ModelStep
from ..data.reader import DataSource, parse_cells, parse_objects
from .processor import BasicProcessor

log = logging.getLogger(__name__)


def create_new_model(name: str, base_dir: str = ".", algorithm: str = "NN",
                     description: Optional[str] = None) -> str:
    """``new <name>``: scaffold the model-set directory (reference ``new
    -t <alg> -m <description>``)."""
    model_dir = os.path.join(base_dir, name)
    os.makedirs(model_dir, exist_ok=True)
    mc_path = os.path.join(model_dir, "ModelConfig.json")
    if os.path.isfile(mc_path):
        raise FileExistsError(f"{mc_path} already exists")
    mc = ModelConfig.create(name, description)
    from ..config.jsonbean import parse_enum
    from ..config.model_config import Algorithm
    mc.train.algorithm = parse_enum(Algorithm, algorithm)
    mc.save(mc_path)
    log.info("created model set at %s", model_dir)
    return model_dir


# per-algorithm train#params defaults (reference `shifu init -model`,
# ``BasicModelProcessor.java:404-500`` checkAlgorithmParam): when the
# sentinel key is absent the whole params map is replaced and saved
_ALG_DEFAULT_PARAMS = {
    "LR": ("LearningRate", {"LearningRate": 0.1}),
    "NN": ("Propagation", {"Propagation": "R", "LearningRate": 0.1,
                           "NumHiddenLayers": 2, "NumHiddenNodes": [20, 10],
                           "ActivationFunc": ["tanh", "tanh"]}),
    "SVM": ("Kernel", {"Kernel": "linear", "Gamma": 1.0, "Const": 1.0}),
    "RF": ("MaxDepth", {"TreeNum": 10,
                        "FeatureSubsetStrategy": "TWOTHIRDS",
                        "MaxDepth": 14, "MinInstancesPerNode": 1,
                        "MinInfoGain": 0.0, "Impurity": "entropy",
                        "Loss": "squared"}),
    "GBT": ("MaxDepth", {"TreeNum": 100,
                         "FeatureSubsetStrategy": "TWOTHIRDS",
                         "MaxDepth": 7, "MinInstancesPerNode": 5,
                         "MinInfoGain": 0.0, "DropoutRate": 0.0,
                         "Impurity": "variance", "LearningRate": 0.05,
                         "Loss": "squared"}),
}


def check_algorithm_param(model_dir: str) -> int:
    """``init -model``: fill the configured algorithm's default
    train#params when they are missing and save ModelConfig.json
    (reference ``ShifuCLI.java:632`` → checkAlgorithmParam).  DT /
    TENSORFLOW / WDL take no defaults, like the reference."""
    mc_path = os.path.join(model_dir, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    alg = (mc.train.algorithm.value if hasattr(mc.train.algorithm, "value")
           else str(mc.train.algorithm)).upper()
    entry = _ALG_DEFAULT_PARAMS.get(alg)
    if entry is None:
        if alg in ("DT", "TENSORFLOW", "WDL", "GENERIC"):
            log.info("init -model: no defaults for %s (reference parity)",
                     alg)
            return 0
        log.error("init -model: unsupported algorithm %s", alg)
        return 1
    sentinel, defaults = entry
    params = dict(mc.train.params or {})
    if sentinel in params:
        log.info("init -model: %s params already set (%s present)", alg,
                 sentinel)
        return 0
    mc.train.params = dict(defaults)
    if alg == "GBT":   # the reference also widens the epoch budget for GBT
        mc.train.numTrainEpochs = 10000
    mc.save(mc_path)
    log.info("init -model: filled %s default params into ModelConfig.json",
             alg)
    return 0


def _read_column_file(path: Optional[str], base_dir: str) -> List[str]:
    if not path:
        return []
    p = path if os.path.isabs(path) else os.path.join(base_dir, path)
    if not os.path.isfile(p):
        return []
    out = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


class InitProcessor(BasicProcessor):
    step = ModelStep.INIT
    require_columns = False

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None, device: DeviceLike = "cpu"):
        super().__init__(model_set_dir, params, device)

    # Columns whose distinct count / numeric-parse rate crosses these are
    # auto-typed categorical, standing in for the reference's
    # CountAndFrequentItemsWritable + 0.1*count heuristics (core/autotype).
    CATE_FREQ_THRESHOLD = 0.95

    def process(self) -> int:
        mc = self.model_config
        ds = mc.dataSet
        source = DataSource(self._abs(ds.dataPath), ds.dataDelimiter,
                            header_path=self._abs(ds.headerPath),
                            header_delimiter=ds.headerDelimiter)
        header = source.header
        if ds.targetColumnName:
            from ..config.column_config import ns_match
            hits = [h for h in header if ns_match(h, ds.targetColumnName)]
            if not hits:
                raise ValueError(
                    f"target column {ds.targetColumnName!r} not in header "
                    f"({len(header)} columns)")
            if len(hits) > 1:
                raise ValueError(
                    f"target column {ds.targetColumnName!r} is ambiguous: "
                    f"matches {hits} — use the full namespaced name")
        meta = _read_column_file(ds.metaColumnNameFile, self.dir)
        cate = _read_column_file(ds.categoricalColumnNameFile, self.dir)
        configs = build_initial_column_configs(
            header, ds.targetColumnName, meta_cols=meta, categorical_cols=cate,
            weight_col=ds.weightColumnName)
        if not cate:
            self._auto_type(source, configs)
        self.column_configs = configs
        self.backup(self.paths.column_config_path)
        self.save_column_configs()
        log.info("init: %d columns (%d categorical, %d meta)", len(configs),
                 sum(c.is_categorical() for c in configs), len(meta))
        return 0


    def _auto_type(self, source: DataSource, configs: List[ColumnConfig],
                   sample_rows: int = 200_000) -> None:
        """Numeric/categorical inference via streaming sketches — the
        reference's distinct-count MR job (``core/autotype/``): per-column
        HyperLogLog distinct estimate + bounded frequent items, then the
        ``InitModelProcessor.java:185-250`` rules: a 0/1 binary variable is
        numeric, a column whose frequent items all parse as double is
        numeric, everything else flips to categorical."""
        from ..data.cells import distinct, stripped_cells
        from ..ops.sketches import FrequentItems, HyperLogLog
        seen = 0
        parse_ok = np.zeros(len(configs), np.int64)
        non_empty = np.zeros(len(configs), np.int64)
        hlls = [HyperLogLog() for _ in configs]
        freqs = [FrequentItems() for _ in configs]
        for chunk in source.iter_chunks(chunk_rows=min(sample_rows, 262144)):
            for i, cc in enumerate(configs):
                vals = chunk.data[cc.columnName]
                cells = stripped_cells(vals)
                if cells is None:             # no S view: object arrays
                    s = np.empty(len(vals), dtype=object)
                    s[:] = [str(v).strip() for v in vals]
                    _, valid = parse_objects(list(s))
                    live = s[s != ""]
                    parse_ok[i] += int(valid.sum())
                    non_empty[i] += len(live)
                    hlls[i].update(live)
                    freqs[i].update(live)
                    continue
                _, valid = parse_cells(cells)
                parse_ok[i] += int(valid.sum())
                # one np.unique of the non-empty cells feeds both sketches
                d = distinct(cells, drop_empty=True)
                non_empty[i] += int(d.counts.sum())
                hlls[i].update_distinct(d)
                freqs[i].update_distinct(d)
            seen += len(chunk)
            if seen >= sample_rows:
                break
        if seen == 0:
            return

        def _all_double(items: List[str]) -> bool:
            # covers the reference's isBinaryVariable special case too: a
            # 0/1 column's frequent items all parse, so it stays numeric
            for v in items:
                try:
                    float(v)
                except ValueError:
                    return False
            return bool(items)

        for i, cc in enumerate(configs):
            distinct = hlls[i].estimate()
            cc.columnStats.distinctCount = distinct
            if cc.is_target() or cc.is_meta():
                continue
            if cc.columnType != ColumnType.N or non_empty[i] == 0:
                continue
            items = freqs[i].top()
            rate = parse_ok[i] / max(1, non_empty[i])
            if rate >= self.CATE_FREQ_THRESHOLD and _all_double(items):
                cc.columnType = ColumnType.N
            else:
                cc.columnType = ColumnType.C
            if cc.columnType == ColumnType.C or rate < 1.0:
                cc.sampleValues = sorted(items)[:20]
