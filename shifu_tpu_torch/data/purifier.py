"""Row filtering + sampling — the port's copy of
``shifu_tpu.data.purifier`` (reference ``core/DataPurifier.java`` and
``core/DataSampler.java``).

An empty ``filterExpressions`` keeps every row.  The reference evaluates a
non-empty one with ``pandas.eval``; the port has no expression evaluator
yet, so a non-empty filter raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DataPurifier:
    def __init__(self, filter_expression: Optional[str]):
        self.expr = (filter_expression or "").strip()
        if self.expr:
            raise NotImplementedError(
                f"dataSet.filterExpressions {self.expr!r}: filter "
                "expressions are not ported to shifu_tpu_torch yet "
                "(ROADMAP Queue 1 item 1)")

    def mask(self, chunk) -> np.ndarray:
        """Boolean keep-mask for the chunk: every row."""
        return np.ones(len(chunk), dtype=bool)


def sample_mask(n: int, rate: float, seed: int, neg_only: bool = False,
                targets: Optional[np.ndarray] = None) -> np.ndarray:
    """Bernoulli sampling mask; with ``neg_only`` positives are always kept
    (reference stats/norm ``sampleNegOnly`` semantics)."""
    if rate >= 1.0:
        return np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < rate
    if neg_only and targets is not None:
        keep |= targets == 1.0
    return keep
