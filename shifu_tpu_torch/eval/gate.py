"""Old-vs-new holdout gate — the port's copy of ``shifu_tpu.eval.gate``,
the promotion decision in one place.

A retrained candidate reaches the serving fleet only if it is at least
as good as the incumbent on data neither of them trained on:

- :func:`load_holdout` slices the newest window of the materialized
  plane (the tail shards of ``NormalizedData`` and ``CleanedData``: the
  freshest rows, the distribution the candidate claims to fix);
- :func:`auc_gate` scores both ensembles on that holdout through the
  batch :class:`~shifu_tpu_torch.eval.scorer.Scorer` (forests walked by
  the ``tree_traverse`` kernel on the card) and compares AUC: the
  candidate passes iff ``new_auc >= old_auc + min_delta``
  (``-Dshifu.refresh.minAucDelta``, default 0: strict non-regression).

The result carries both AUCs and the verdict; the refresh journal keeps
it with every promote and reject decision.
"""

from __future__ import annotations

import logging
import os
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .. import DeviceLike

log = logging.getLogger(__name__)

DEFAULT_HOLDOUT_ROWS = 4096


@dataclass
class GateResult:
    old_auc: float
    new_auc: float
    delta: float                 # new - old
    min_delta: float             # the bar (non-regression at 0)
    passed: bool
    rows: int

    def report(self) -> Dict[str, Any]:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in asdict(self).items()}


@dataclass
class Holdout:
    x: np.ndarray                          # [n, d] normalized floats
    y: np.ndarray                          # [n] targets
    w: np.ndarray                          # [n] weights
    bins: Optional[np.ndarray] = None      # [n, c] bin ids (trees, WDL)

    @property
    def rows(self) -> int:
        return int(len(self.y))


def min_auc_delta(override: Optional[float] = None) -> float:
    """The promotion bar: ``shifu.refresh.minAucDelta`` (default 0: the
    candidate must not regress AUC; a positive bar demands a real win)."""
    if override is not None:
        return float(override)
    from ..config import environment
    return environment.get_float("shifu.refresh.minAucDelta", 0.0)


def load_holdout(model_set_dir: str,
                 max_rows: int = DEFAULT_HOLDOUT_ROWS) -> Holdout:
    """The newest rows of the materialized plane as an eval holdout: the
    tail shards of the norm plane (x, y, w) and, when present, of the
    row-aligned clean plane (bins).  One ``norm`` pass writes both, so
    shard k covers the same rows in each."""
    from ..data.shards import Shards
    norm = Shards.open(os.path.join(model_set_dir, "tmp",
                                    "NormalizedData"))
    rows = norm.shard_rows
    # walk the shards back to front until max_rows is covered
    start, have = len(rows), 0
    while start > 0 and have < max_rows:
        start -= 1
        have += rows[start]
    parts = list(norm.iter_shards(start=start, strict=True))
    x = np.concatenate([p["x"] for p in parts])[-max_rows:]
    y = np.concatenate([p["y"] for p in parts])[-max_rows:]
    w = np.concatenate([p["w"] for p in parts])[-max_rows:]
    bins = None
    clean_dir = os.path.join(model_set_dir, "tmp", "CleanedData")
    if os.path.isfile(os.path.join(clean_dir, "schema.json")):
        clean = Shards.open(clean_dir)
        if clean.n_shards == norm.n_shards:
            cparts = list(clean.iter_shards(start=start, strict=True))
            bins = np.concatenate([p["bins"] for p in cparts])[-max_rows:]
    return Holdout(x=x, y=y, w=w, bins=bins)


def holdout_auc(models: Sequence, holdout: Holdout,
                device: DeviceLike = None) -> float:
    """Weighted-mean ensemble AUC of ``models`` on the holdout (the mean
    score the serving plane answers with), scored on ``device``."""
    from .metrics import evaluate_scores
    from .scorer import Scorer
    scorer = Scorer(list(models), device=device)
    res = scorer.score(holdout.x,
                       holdout.bins if scorer.needs_bins else None)
    perf = evaluate_scores(res.mean, holdout.y, holdout.w)
    return float(perf.areaUnderRoc)


def auc_gate(old_models: Sequence, new_models: Sequence,
             holdout: Holdout, min_delta: Optional[float] = None,
             device: DeviceLike = None) -> GateResult:
    """Score incumbent and candidate on the same holdout; the candidate
    passes iff its AUC does not regress past ``min_delta``.  A holdout
    with a degenerate class mix (a NaN AUC) fails the gate: a candidate
    that cannot be measured never ships on a coin flip."""
    bar = min_auc_delta(min_delta)
    old_auc = holdout_auc(old_models, holdout, device)
    new_auc = holdout_auc(new_models, holdout, device)
    measurable = not (np.isnan(old_auc) or np.isnan(new_auc))
    delta = (new_auc - old_auc) if measurable else float("nan")
    passed = bool(measurable and delta >= bar)
    log.info("auc gate: old=%.6f new=%.6f delta=%+.6f bar=%+g -> %s",
             old_auc, new_auc, delta, bar,
             "PROMOTE" if passed else "REJECT")
    return GateResult(old_auc=old_auc, new_auc=new_auc, delta=delta,
                      min_delta=bar, passed=passed, rows=holdout.rows)
