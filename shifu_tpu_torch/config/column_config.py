"""ColumnConfig — per-column metadata (the port's copy of
``shifu_tpu.config.column_config``: the bean, its JSON io and
``selected_columns``; the init-time helpers stay in the reference).

Mirrors reference ``container/obj/ColumnConfig.java`` (+ ``ColumnStats.java``,
``ColumnBinning.java``): one entry per input column holding type, flag,
selection state, stats (ks/iv/woe/mean/std/...), and binning (boundaries,
per-bin counts / pos-rates / woe).  ``ColumnConfig.json`` is a JSON list of
these entries.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import jsonbean


class ColumnType(enum.Enum):
    """Reference ``container/obj/ColumnType.java:18-21``: A=auto, N=numerical,
    C=categorical, H=hybrid (numerical w/ categorical missing buckets)."""
    A = "A"
    N = "N"
    C = "C"
    H = "H"


class ColumnFlag(enum.Enum):
    """Reference ``ColumnConfig.java:38-40``."""
    ForceSelect = "ForceSelect"
    ForceRemove = "ForceRemove"
    Candidate = "Candidate"
    Meta = "Meta"
    Target = "Target"
    Weight = "Weight"


@dataclass
class ColumnStats:
    max: Optional[float] = None
    min: Optional[float] = None
    mean: Optional[float] = None
    median: Optional[float] = None
    p25th: Optional[float] = None
    p75th: Optional[float] = None
    totalCount: Optional[int] = None
    distinctCount: Optional[int] = None
    missingCount: Optional[int] = None
    validNumCount: Optional[int] = None
    stdDev: Optional[float] = None
    missingPercentage: Optional[float] = None
    woe: Optional[float] = None
    ks: Optional[float] = None
    iv: Optional[float] = None
    weightedKs: Optional[float] = None
    weightedIv: Optional[float] = None
    weightedWoe: Optional[float] = None
    skewness: Optional[float] = None
    kurtosis: Optional[float] = None
    psi: Optional[float] = None
    unitStats: Optional[List[str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ColumnBinning:
    length: int = 0
    binBoundary: Optional[List[float]] = None
    binCategory: Optional[List[str]] = None
    binCountNeg: Optional[List[int]] = None
    binCountPos: Optional[List[int]] = None
    binPosRate: Optional[List[float]] = None
    binAvgScore: Optional[List[int]] = None
    binWeightedNeg: Optional[List[float]] = None
    binWeightedPos: Optional[List[float]] = None
    binCountWoe: Optional[List[float]] = None
    binWeightedWoe: Optional[List[float]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ColumnConfig:
    columnNum: int = 0
    version: str = "0.1.0"
    columnName: str = ""
    columnType: ColumnType = ColumnType.N
    columnFlag: Optional[ColumnFlag] = None
    finalSelect: bool = False
    sampleValues: Optional[List[str]] = None
    hybridThreshold: Optional[float] = None
    columnStats: ColumnStats = field(default_factory=ColumnStats)
    columnBinning: ColumnBinning = field(default_factory=ColumnBinning)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ----------------------------------------------------------- predicates
    def is_numerical(self) -> bool:
        return self.columnType in (ColumnType.N, ColumnType.A)

    def is_categorical(self) -> bool:
        return self.columnType == ColumnType.C

    def is_hybrid(self) -> bool:
        return self.columnType == ColumnType.H

    def is_target(self) -> bool:
        return self.columnFlag == ColumnFlag.Target

    def is_meta(self) -> bool:
        return self.columnFlag == ColumnFlag.Meta

    def is_weight(self) -> bool:
        return self.columnFlag == ColumnFlag.Weight

    def is_force_select(self) -> bool:
        return self.columnFlag == ColumnFlag.ForceSelect

    def is_force_remove(self) -> bool:
        return self.columnFlag == ColumnFlag.ForceRemove

    def is_candidate(self) -> bool:
        """A column eligible for stats/training: not target/meta/weight."""
        return self.columnFlag not in (ColumnFlag.Target, ColumnFlag.Meta,
                                       ColumnFlag.Weight, ColumnFlag.ForceRemove)

    # ------------------------------------------------------------- binning
    @property
    def bin_boundary(self) -> Optional[List[float]]:
        return self.columnBinning.binBoundary

    @property
    def bin_category(self) -> Optional[List[str]]:
        return self.columnBinning.binCategory

    @property
    def bin_pos_rate(self) -> Optional[List[float]]:
        return self.columnBinning.binPosRate

    @property
    def bin_count_woe(self) -> Optional[List[float]]:
        return self.columnBinning.binCountWoe

    @property
    def bin_weighted_woe(self) -> Optional[List[float]]:
        return self.columnBinning.binWeightedWoe

    def num_bins(self) -> int:
        """Number of value bins (excluding the trailing missing-value bin)."""
        if self.is_categorical():
            return len(self.columnBinning.binCategory or [])
        return len(self.columnBinning.binBoundary or [])

    def mean(self) -> float:
        return self.columnStats.mean if self.columnStats.mean is not None else 0.0

    def std_dev(self) -> float:
        sd = self.columnStats.stdDev
        return sd if sd is not None and sd > 1e-12 else 1.0


# --------------------------------------------------------------------- io
def load_column_configs(path: str) -> List[ColumnConfig]:
    with open(path) as f:
        data = json.load(f)
    return [jsonbean.from_dict(ColumnConfig, d) for d in data]


def save_column_configs(configs: List[ColumnConfig], path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump([jsonbean.to_dict(c) for c in configs], f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def selected_columns(configs: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns in the model input, in columnNum order: finalSelect or ForceSelect."""
    out = [c for c in configs
           if (c.finalSelect or c.is_force_select()) and c.is_candidate()]
    return sorted(out, key=lambda c: c.columnNum)
