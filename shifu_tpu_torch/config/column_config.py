"""ColumnConfig — per-column metadata (the port's copy of
``shifu_tpu.config.column_config``: the bean, its JSON io, the init-time
helpers and NSColumn name matching).

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


# ----------------------------------------------------------------- helpers
def build_initial_column_configs(header: List[str], target: Optional[str],
                                 meta_cols: Optional[List[str]] = None,
                                 categorical_cols: Optional[List[str]] = None,
                                 weight_col: Optional[str] = None) -> List[ColumnConfig]:
    """``shifu init``: one ColumnConfig per header column with flags assigned
    (reference ``InitModelProcessor.java:74,89``)."""
    # NSColumn matching throughout: a bare name in a column file matches
    # its namespaced variants in the header and vice versa
    meta = set(meta_cols or [])
    cate = set(categorical_cols or [])
    configs = []
    for i, name in enumerate(header):
        cc = ColumnConfig(columnNum=i, columnName=name)
        if target is not None and ns_match(name, target):
            cc.columnFlag = ColumnFlag.Target
            cc.columnType = ColumnType.C
        elif weight_col is not None and ns_match(name, weight_col):
            cc.columnFlag = ColumnFlag.Weight
        elif ns_in(name, meta):
            cc.columnFlag = ColumnFlag.Meta
        if ns_in(name, cate):
            cc.columnType = ColumnType.C
        configs.append(cc)
    return configs


def candidate_columns(configs: List[ColumnConfig]) -> List[ColumnConfig]:
    return [c for c in configs if c.is_candidate()]


def target_column(configs: List[ColumnConfig]) -> Optional[ColumnConfig]:
    for c in configs:
        if c.is_target():
            return c
    return None


# -------------------------------------------------------- namespaced names
NS_DELIMITER = "::"          # reference Constants.NAMESPACE_DELIMITER


def ns_simple(name: str) -> str:
    """The simple (last) identifier of a possibly-namespaced column name —
    reference ``column/NSColumn.java``: 'raw::a::amount' -> 'amount'."""
    return name.rsplit(NS_DELIMITER, 1)[-1] if NS_DELIMITER in name else name


def read_column_name_file(path, base_dir: str = ".") -> set:
    """One-name-per-line column file (force/meta/candidate lists):
    blank lines and '#' comments skipped; the one reader of such files,
    so every step interprets a file alike."""
    if not path:
        return set()
    p = path if os.path.isabs(path) else os.path.join(base_dir, path)
    if not os.path.isfile(p):
        return set()
    out = set()
    with open(p) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def ns_match(a: str, b: str) -> bool:
    """NSColumn equality: exact full-name match, or a BARE name matching a
    namespaced variant of it (``NSColumn.equals``).  Two different
    namespaces never match — 'a::score' names a different column than
    'b::score'."""
    if a == b:
        return True
    if (NS_DELIMITER in a) != (NS_DELIMITER in b):
        return ns_simple(a) == ns_simple(b)
    return False


def ns_in(name: str, names) -> bool:
    """``name`` matches any entry of ``names`` under NSColumn equality."""
    if name in names:          # fast path: exact
        return True
    return any(ns_match(name, other) for other in names)
