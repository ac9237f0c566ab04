"""Column binner — the port's copy of ``shifu_tpu.ops.binning.ColumnBinner``
(the stats-time binning code stays in the reference until the stats slice).

``bin_categorical`` is rewritten without pandas; it keeps the reference's
rule exactly: strip, exact lookup (a bin label may hold several raw
categories joined by ``CATEGORY_GROUP_SEP``), unseen -> ``num_bins``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

#: separator of merged raw categories inside one bin label (dynamic rebin;
#: reference CategoricalBinInfo)
CATEGORY_GROUP_SEP = "\x01"


class ColumnBinner:
    """Maps raw column values -> bin indices given finalized binning.

    Numeric: searchsorted over binBoundary (boundary[0] = -inf); categorical:
    exact category index; missing/unseen -> ``num_bins`` (the trailing missing
    bin), matching reference ``BinUtils.getBinNum`` semantics.
    """

    def __init__(self, boundaries: Optional[np.ndarray] = None,
                 categories: Optional[List[str]] = None):
        assert (boundaries is None) != (categories is None)
        self.boundaries = None if boundaries is None else np.asarray(boundaries, np.float64)
        self.categories = categories
        if categories is None:
            self.cat_index = None
        else:
            self.cat_index = {}
            for i, c in enumerate(categories):
                for member in c.split(CATEGORY_GROUP_SEP):
                    self.cat_index[member] = i

    @property
    def num_bins(self) -> int:
        if self.boundaries is not None:
            return len(self.boundaries)
        return len(self.categories)

    def bin_numeric(self, x: np.ndarray, valid: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.boundaries, x, side="right") - 1
        idx = np.clip(idx, 0, self.num_bins - 1)
        return np.where(valid, idx, self.num_bins).astype(np.int32)

    def bin_categorical(self, values: Sequence) -> np.ndarray:
        nb = self.num_bins
        return np.fromiter((self.cat_index.get(str(v).strip(), nb)
                            for v in values), np.int32, len(values))
