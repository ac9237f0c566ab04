"""Pure stats math: KS / IV / WOE / PSI / pos-rate from per-bin counts —
the port's copy of ``shifu_tpu.ops.stats_math`` (pure numpy, so it is
copied as it stands).

Formula parity with reference ``core/ColumnStatsCalculator.java`` (long[]
variant, the one used by ``UpdateBinningInfoReducer.java:345``):

- per-bin WOE = ln((n_i + eps) / (p_i + eps)) with p_i, n_i the bin's share of
  total positives / negatives,
- IV = sum (n_i - p_i) * woe_i,
- column WOE = ln((sumNeg + eps) / (sumPos + eps)),
- KS = 100 * max_i |cum_p - cum_n|.

All functions are numpy-vectorized over the bin axis and over columns, so the
whole ColumnConfig list is computed in one shot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

EPS = 1e-10


class ColumnMetrics(NamedTuple):
    ks: np.ndarray          # [cols]
    iv: np.ndarray          # [cols]
    woe: np.ndarray         # [cols]
    bin_woe: np.ndarray     # [cols, bins]


def column_metrics(neg: np.ndarray, pos: np.ndarray) -> ColumnMetrics:
    """KS/IV/WOE for count (or weighted-count) bin arrays.

    Args:
      neg, pos: [cols, bins] arrays (missing bin included as the last entry,
        as the reference does).
    Columns with zero total pos or neg get NaN metrics (reference returns null).
    """
    neg = np.asarray(neg, dtype=np.float64)
    pos = np.asarray(pos, dtype=np.float64)
    sum_n = neg.sum(axis=-1, keepdims=True)
    sum_p = pos.sum(axis=-1, keepdims=True)
    ok = (sum_n[..., 0] > 0) & (sum_p[..., 0] > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = pos / np.where(sum_p == 0, 1, sum_p)
        n = neg / np.where(sum_n == 0, 1, sum_n)
        bin_woe = np.log((n + EPS) / (p + EPS))
        iv = ((n - p) * bin_woe).sum(axis=-1)
        woe = np.log((sum_n[..., 0] + EPS) / (sum_p[..., 0] + EPS))
        ks = 100.0 * np.abs(np.cumsum(p, axis=-1) - np.cumsum(n, axis=-1)).max(axis=-1)
    nanify = lambda a: np.where(ok, a, np.nan)
    return ColumnMetrics(ks=nanify(ks), iv=nanify(iv), woe=nanify(woe),
                         bin_woe=np.where(ok[..., None], bin_woe, np.nan))


def pos_rate(pos: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """binPosRate — reference ``UpdateBinningInfoReducer.computePosRate``:
    pos/(pos+neg), NaN for empty bins."""
    pos = np.asarray(pos, dtype=np.float64)
    neg = np.asarray(neg, dtype=np.float64)
    tot = pos + neg
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(tot > 0, pos / np.where(tot == 0, 1, tot), np.nan)


def psi(expected: np.ndarray, actual: np.ndarray) -> np.ndarray:
    """Population stability index between two per-bin count vectors
    (reference ``udf/PSICalculatorUDF``): sum((a%-e%)*ln(a%/e%))."""
    e = np.asarray(expected, dtype=np.float64)
    a = np.asarray(actual, dtype=np.float64)
    e = e / np.maximum(e.sum(axis=-1, keepdims=True), EPS)
    a = a / np.maximum(a.sum(axis=-1, keepdims=True), EPS)
    with np.errstate(divide="ignore", invalid="ignore"):
        term = (a - e) * np.log((a + EPS) / (e + EPS))
    return term.sum(axis=-1)


# ----------------------------------------------------------- dynamic rebin
def _iv_terms(neg: np.ndarray, pos: np.ndarray,
              sum_n: float, sum_p: float) -> np.ndarray:
    """Per-bin IV contribution given FIXED column totals.  Because merging
    adjacent bins never changes the totals, column IV decomposes as the sum
    of these terms — which is what makes the merge loop vectorizable."""
    if sum_n <= 0 or sum_p <= 0:
        return np.zeros_like(np.asarray(neg, np.float64))
    n = np.asarray(neg, np.float64) / sum_n
    p = np.asarray(pos, np.float64) / sum_p
    return (n - p) * np.log((n + EPS) / (p + EPS))


def merge_adjacent_by_iv(neg: np.ndarray, pos: np.ndarray,
                         target_bins: int, iv_keep: float = 0.95,
                         min_inst: int = 0) -> list:
    """IV-driven adjacent bin merge (reference ``DynamicBinning`` /
    ``AutoDynamicBinning``: merge bins while information value survives).

    neg/pos: per-VALUE-bin counts (missing bin excluded).  Greedily merges
    the adjacent pair whose merge preserves the most IV until ``target_bins``
    is reached; continues below that only while IV stays above
    ``iv_keep * original``.  Returns the list of merged index groups (each a
    list of original bin indices, in order).

    Each round evaluates ALL candidate merges in one vectorized pass: column
    totals are merge-invariant, so merging pair i changes the IV by
    ``t_merged(i) - t_i - t_{i+1}`` where ``t`` are per-bin IV terms —
    O(bins) per round instead of the naive O(bins^2).
    """
    neg = np.asarray(neg, np.float64).copy()
    pos = np.asarray(pos, np.float64).copy()
    groups = [[i] for i in range(len(neg))]
    sum_n, sum_p = float(neg.sum()), float(pos.sum())
    iv0 = float(_iv_terms(neg, pos, sum_n, sum_p).sum())
    while len(groups) > 2:
        t = _iv_terms(neg, pos, sum_n, sum_p)
        tm = _iv_terms(neg[:-1] + neg[1:], pos[:-1] + pos[1:], sum_n, sum_p)
        cand = float(t.sum()) - t[:-1] - t[1:] + tm  # IV after each merge
        i = int(np.argmax(cand))
        need_shrink = len(groups) > target_bins
        # reference -bic: bins under the minimum instance count must merge
        # regardless of IV (DynamicBinningUDF minimumBinInstCnt)
        tiny = (neg + pos) < min_inst if min_inst > 0 else None
        if tiny is not None and tiny.any() and not need_shrink:
            j = int(np.argmin(neg + pos))
            i = j if j < len(cand) and (j == 0 or cand[j] >= cand[j - 1]) \
                else max(j - 1, 0)
            need_shrink = True
        if not need_shrink and (iv0 <= 0 or cand[i] < iv_keep * iv0):
            break
        neg[i] += neg[i + 1]
        pos[i] += pos[i + 1]
        neg = np.delete(neg, i + 1)
        pos = np.delete(pos, i + 1)
        groups[i] = groups[i] + groups[i + 1]
        del groups[i + 1]
    return groups
