"""Chunk extraction: raw string chunk -> typed arrays per the ColumnConfig
list — the port's copy of ``shifu_tpu.data.extract``.

Applies the row filter, parses the target tag, weight column and numeric
candidate columns into one [R, C] matrix, and leaves categorical columns as
string arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import ColumnConfig, ModelConfig
from .purifier import DataPurifier
from .reader import RawChunk, parse_numeric, parse_weight, tag_to_target


@dataclass
class ExtractedChunk:
    n: int
    target: np.ndarray                 # [R] 1/0
    weight: np.ndarray                 # [R]
    numeric: np.ndarray                # [R, C_num] float64 (NaN = missing)
    numeric_valid: np.ndarray          # [R, C_num] bool
    numeric_cols: List[ColumnConfig]
    categorical: Dict[str, np.ndarray]  # name -> [R] str values
    categorical_cols: List[ColumnConfig]
    # replay provenance: positional raw-row index of each kept row and the
    # chunk's pre-filter row count — every row-wise op in this extractor
    # commutes with row subsetting, so a full extraction plus (raw_rows,
    # kept_idx) replays any pre-parse Bernoulli sample bit-identically
    # (sample_mask[kept_idx] selects the rows the sample-then-extract order
    # keeps)
    kept_idx: Optional[np.ndarray] = None   # [R] int64
    raw_rows: int = 0
    # the kept rows' raw string columns (``extract(keep_raw=True)``: PSI
    # reads its unit column from them)
    raw: Optional[RawChunk] = None


class ChunkExtractor:
    def __init__(self, model_config: ModelConfig, column_configs: List[ColumnConfig],
                 columns: Optional[List[ColumnConfig]] = None,
                 for_eval_set: Optional[int] = None):
        self.mc = model_config
        ds = model_config.dataSet if for_eval_set is None else \
            model_config.evals[for_eval_set].dataSet
        self.ds = ds
        self.purifier = DataPurifier(ds.filterExpressions)
        # eval sets may rename the target / use different tags or missing
        # markers than the training source (reference EvalConfig dataSet)
        self.missing_values = ds.missingOrInvalidValues \
            or model_config.dataSet.missingOrInvalidValues
        if columns is None:
            columns = [c for c in column_configs if c.is_candidate()]
        self.numeric_cols = [c for c in columns if not c.is_categorical()]
        self.categorical_cols = [c for c in columns if c.is_categorical()]
        self.target_name = ds.targetColumnName \
            or model_config.dataSet.targetColumnName
        self.pos_tags = ds.posTags or model_config.dataSet.posTags
        self.neg_tags = ds.negTags or model_config.dataSet.negTags
        # multi-class: posTags lists every class, negTags empty — y becomes
        # the class index instead of a 0/1 target
        self.multiclass = len(self.pos_tags) > 1 and not self.neg_tags
        self.weight_name = ds.weightColumnName

    def row_identity(self) -> dict:
        """Everything that decides which rows survive extraction and how
        the shared target and weight columns parse: the raw cache's
        row-plane staleness key, the reference's dict, so both packages
        hash to one cache directory.  Column-independent: a cache serves
        any extractor whose row identity matches and whose columns are a
        subset of the cached set."""
        return {"filters": self.ds.filterExpressions,
                "missing": sorted(m for m in (self.missing_values or [])),
                "target": self.target_name,
                "posTags": [str(t) for t in self.pos_tags],
                "negTags": [str(t) for t in self.neg_tags],
                "multiclass": bool(self.multiclass),
                "weight": self.weight_name}

    def extract(self, chunk: RawChunk,
                keep_raw: bool = False) -> ExtractedChunk:
        df = chunk.data
        raw_rows = len(chunk)
        keep = self.purifier.mask(chunk)
        if self.target_name and self.target_name in df:
            raw_tags = df[self.target_name]
            if self.multiclass:
                from .reader import tag_to_class
                y = tag_to_class(raw_tags, self.pos_tags)
            else:
                y = tag_to_target(raw_tags, self.pos_tags, self.neg_tags)
            keep &= ~np.isnan(y)  # drop rows with unknown tags
        else:
            y = np.zeros(raw_rows)
        kept_idx = np.flatnonzero(np.asarray(keep, dtype=bool))
        chunk = chunk.take(keep)
        df = chunk.data
        y = y[keep]
        n = len(chunk)
        w = parse_weight(
            df[self.weight_name] if self.weight_name and
            self.weight_name in df else None, n)
        if self.numeric_cols:
            mats, valids = [], []
            for cc in self.numeric_cols:
                f, v = parse_numeric(df[cc.columnName], self.missing_values)
                mats.append(f)
                valids.append(v)
            numeric = np.stack(mats, axis=1)
            numeric_valid = np.stack(valids, axis=1)
        else:
            numeric = np.zeros((n, 0))
            numeric_valid = np.zeros((n, 0), dtype=bool)
        categorical = {cc.columnName: df[cc.columnName]
                       for cc in self.categorical_cols}
        return ExtractedChunk(
            n=n, target=y, weight=w, numeric=numeric, numeric_valid=numeric_valid,
            numeric_cols=self.numeric_cols, categorical=categorical,
            categorical_cols=self.categorical_cols,
            kept_idx=kept_idx, raw_rows=raw_rows,
            raw=chunk if keep_raw else None)
