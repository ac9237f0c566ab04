"""DatasetTransformer: raw chunks -> (normalized float matrix, binned int
matrix, target, weight) — the port of ``shifu_tpu.data.transform``, the
dual data plane trees and NN/LR read (reference
``TrainModelProcessor.java:1366-1372``).

Used by ``norm`` (materializes shards) and ``eval`` (normalizes eval sets
on the fly, like ``EvalNormUDF``).  The transform is host-side numpy f64,
as in the reference: the per-column tables of ``ops/normalize.py`` and the
binner of ``ops/binning.py`` are the same code, so the arrays are the
reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import ColumnConfig, ModelConfig, selected_columns
from ..ops.binning import ColumnBinner
from ..ops.normalize import NormalizedColumn, apply_precision
from .extract import ChunkExtractor, ExtractedChunk


def model_input_columns(model_config: ModelConfig,
                        column_configs: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns that feed the model: finalSelect if any, else all candidates
    with stats (norm can run before varselect)."""
    sel = selected_columns(column_configs)
    if sel:
        return sel
    return [c for c in column_configs
            if c.is_candidate() and c.num_bins() > 0]


@dataclass
class TransformedChunk:
    n: int
    x: np.ndarray          # [R, D] float32 normalized
    bins: np.ndarray       # [R, C] int32 bin indices (missing = num_bins)
    target: np.ndarray     # [R] float32
    weight: np.ndarray     # [R] float32


class DatasetTransformer:
    def __init__(self, model_config: ModelConfig,
                 column_configs: List[ColumnConfig],
                 columns: Optional[List[ColumnConfig]] = None,
                 for_eval_set: Optional[int] = None):
        self.mc = model_config
        self.columns = columns if columns is not None else \
            model_input_columns(model_config, column_configs)
        if not self.columns:
            raise ValueError("no input columns with binning stats — run "
                             "`stats` first")
        self.extractor = ChunkExtractor(model_config, column_configs,
                                        columns=self.columns,
                                        for_eval_set=for_eval_set)
        norm_type = model_config.normalize.normType
        cutoff = model_config.normalize.stdDevCutOff
        self.norm_cols = [NormalizedColumn(cc, norm_type, cutoff)
                          for cc in self.columns]
        self.binners = {}
        for cc in self.columns:
            if cc.is_categorical():
                self.binners[cc.columnNum] = ColumnBinner(
                    categories=cc.bin_category or [])
            elif cc.bin_boundary:
                self.binners[cc.columnNum] = ColumnBinner(
                    boundaries=np.asarray(cc.bin_boundary))
            else:
                self.binners[cc.columnNum] = None
        self.output_names = [n for nc in self.norm_cols
                             for n in nc.output_names()]

    @property
    def width(self) -> int:
        return len(self.output_names)

    def transform(self, chunk) -> TransformedChunk:
        """A raw chunk, or one the parse pool already extracted."""
        if isinstance(chunk, ExtractedChunk):
            return self.transform_extracted(chunk)
        return self.transform_extracted(self.extractor.extract(chunk))

    def transform_extracted(self, ex: ExtractedChunk) -> TransformedChunk:
        num_index = {c.columnNum: i for i, c in enumerate(ex.numeric_cols)}
        outs, bin_cols = [], []
        for nc in self.norm_cols:
            cc = nc.cc
            binner = self.binners[cc.columnNum]
            if cc.is_categorical():
                vals = ex.categorical[cc.columnName]
                bidx = binner.bin_categorical(vals) if binner else \
                    np.zeros(ex.n, dtype=np.int32)
                out = nc.transform(np.zeros(ex.n),
                                   np.zeros(ex.n, dtype=bool), bidx)
            else:
                j = num_index[cc.columnNum]
                v, valid = ex.numeric[:, j], ex.numeric_valid[:, j]
                bidx = binner.bin_numeric(v, valid) if binner else \
                    np.where(valid, 0, 1).astype(np.int32)
                out = nc.transform(v, valid, bidx)
            outs.append(out)
            bin_cols.append(bidx)
        x = np.concatenate(outs, axis=1) if outs else np.zeros((ex.n, 0))
        x = apply_precision(x, self.mc.normalize.precisionType)
        return TransformedChunk(
            n=ex.n, x=x.astype(np.float32),
            bins=np.stack(bin_cols, axis=1).astype(np.int32) if bin_cols
            else np.zeros((ex.n, 0), np.int32),
            target=ex.target.astype(np.float32),
            weight=ex.weight.astype(np.float32))
