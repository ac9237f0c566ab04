"""Device-resident ensemble scorer behind a padded batch-bucket ladder —
the port of ``shifu_tpu.serve.scorer``.

:class:`AOTScorer` pins the ensemble's forests on the device once and keeps
the reference's request contract: a batch pads to the smallest covering
rung of the bucket ladder, batches beyond the top rung chunk through it,
and the result is trimmed back to the request's rows.  Every launch is
eager PyTorch around the hand-written traversal kernel (one kernel launch
per forest per bucket); capturing each rung as a CUDA graph is later work.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..eval.scorer import SCORE_SCALE, Scorer

log = logging.getLogger(__name__)

# geometric bucket ladder default: request batches pad to the smallest
# covering rung (``-Dshifu.serve.buckets``)
DEFAULT_BUCKETS = (1, 8, 64, 512)


def bucket_ladder() -> Tuple[int, ...]:
    """The configured bucket ladder, ascending and deduplicated
    (property ``shifu.serve.buckets`` = comma-separated sizes)."""
    from ..config import environment
    spec = environment.get_property("shifu.serve.buckets")
    if not spec:
        return DEFAULT_BUCKETS
    try:
        sizes = sorted({int(s) for s in spec.split(",") if s.strip()})
        if not sizes or any(s <= 0 for s in sizes):
            raise ValueError(spec)
        return tuple(sizes)
    except ValueError:
        log.warning("ignoring unparseable shifu.serve.buckets=%r", spec)
        return DEFAULT_BUCKETS


def covering_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest rung >= n (the largest rung when n exceeds the ladder —
    the caller chunks oversize batches)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def infer_dims(models: Sequence) -> Tuple[int, int]:
    """(n_features, n_bin_cols) the ensemble's inputs must provide, derived
    from the saved specs.  Tree forests consume bins only, so
    ``n_features`` stays 0 until float-input models are ported."""
    n_bins_cols = 0
    for m in models:
        if type(m).__name__ != "IndependentTreeModel":
            raise NotImplementedError(
                f"{type(m).__name__} is not ported to shifu_tpu_torch yet")
        feats = max((int(np.max(t.split_feat)) for t in m.trees),
                    default=-1)
        n_bins_cols = max(n_bins_cols, feats + 1)
    return 0, n_bins_cols


def _tree_column(m, device: torch.device) -> Callable:
    """Score column of a saved forest on ``device``: the narrow traversal
    (kernel on CUDA, over the ensemble's uint8 or int32 bin plane) then the
    model's f32 link — the device twin of ``IndependentTreeModel.compute``."""
    from ..ops import tree_quant as tq
    depth = m.trees[0].depth
    arrays = m.quant_arrays(device)

    def col(x, bins):
        preds = tq.predict_forest_quant(*arrays, bins, depth)
        out = m.link(preds)
        return out[:, 0] if out.dim() > 1 else out
    return col


def build_ensemble_fn(scorer: Scorer, device: torch.device) -> Callable:
    """``fn(x, bins) -> [n, M]`` scaled scores over the whole ensemble on
    ``device`` (tree columns only here, so it always consumes bins)."""
    cols: List[Callable] = []
    for m in scorer.models:
        if getattr(m, "input_kind", "norm") != "bins":
            raise NotImplementedError(
                f"{type(m).__name__} columns are not ported yet")
        cols.append(_tree_column(m, device))
    scale = scorer.scale

    def fn(x, bins):
        return torch.stack([col(x, bins) for col in cols], dim=1) * scale
    return fn


class AOTScorer:
    """The modelset's ensemble pinned on the device behind the bucket
    ladder (see module docs).  ``warm()`` launches every rung once;
    :meth:`score_batch` then pads to the covering rung, launches and trims.
    Thread-safe for concurrent callers: the pinned arrays are read-only."""

    def __init__(self, models: Sequence, scale: float = SCORE_SCALE,
                 buckets: Optional[Sequence[int]] = None,
                 transform=None, device=None):
        self.device = resolve_device(device)
        self.scorer = Scorer(models, scale, device=self.device)
        self.buckets = tuple(sorted(set(buckets or bucket_ladder())))
        self.n_features, self.n_bins_cols = infer_dims(models)
        from ..ops import tree_quant as tq
        self.bins_dtype = tq.ensemble_bins_dtype(models)
        self._fn = build_ensemble_fn(self.scorer, self.device)
        self.needs_bins = True          # every ported model reads bins
        self.transform = transform
        self.accepts_raw = transform is not None
        if transform is not None:
            if transform.width < self.n_features:
                raise ValueError(
                    f"transform emits {transform.width} features but the "
                    f"ensemble consumes {self.n_features} — the ColumnConfig "
                    "snapshot does not match the models")
            if transform.n_columns < self.n_bins_cols:
                raise ValueError(
                    f"transform emits {transform.n_columns} bin columns but "
                    f"the ensemble consumes {self.n_bins_cols}")

    @property
    def models(self) -> List:
        return self.scorer.models

    # -------------------------------------------------------------- warm
    def warm(self) -> None:
        """Launch every rung once (both families), so the first request
        pays no lazy kernel build or allocator growth."""
        for b in self.buckets:
            self.score_batch(np.zeros((b, self.n_features), np.float32),
                             np.zeros((b, self.n_bins_cols), np.int32))
            if self.accepts_raw:
                # a zero wire row decodes as all-missing — a legal record
                self.score_batch_raw(np.zeros(
                    (b, self.transform.wire_width), self.transform.wire_dtype))

    # ------------------------------------------------------------- score
    def _launch(self, x: torch.Tensor, bins: torch.Tensor) -> np.ndarray:
        return self._fn(x, bins).cpu().numpy()

    def score_batch(self, x: np.ndarray,
                    bins: Optional[np.ndarray] = None) -> np.ndarray:
        """raw scaled scores [n, M] for a request batch; pads to the
        covering bucket, chunks batches beyond the top rung."""
        n = len(x)
        top = self.buckets[-1]
        if n > top:
            return np.concatenate(
                [self.score_batch(x[s:s + top],
                                  None if bins is None else bins[s:s + top])
                 for s in range(0, n, top)], axis=0)
        if bins is None:
            raise ValueError("ensemble contains bin-consuming models "
                             "— requests must carry bins")
        if x.shape[1] != self.n_features \
                or bins.shape[1] != self.n_bins_cols:
            raise ValueError(
                f"request carries {x.shape[1]} features and {bins.shape[1]} "
                f"bin columns; the ensemble takes {self.n_features} and "
                f"{self.n_bins_cols}")
        bucket = covering_bucket(self.buckets, n)
        xb = np.zeros((bucket, self.n_features), np.float32)
        xb[:n] = x
        bb = torch.zeros((bucket, self.n_bins_cols), dtype=self.bins_dtype)
        bb[:n] = torch.tensor(np.asarray(bins))
        return self._launch(torch.from_numpy(xb).to(self.device),
                            bb.to(self.device))[:n]

    def score_batch_raw(self, packed: np.ndarray) -> np.ndarray:
        """raw scaled scores [n, M] for PACKED raw-record rows (the
        ``serve/transform.py`` wire format): the transform runs on the
        device and feeds the same ensemble.  Same pad/chunk/trim contract
        as :meth:`score_batch`; pad rows are all-missing."""
        if not self.accepts_raw:
            raise ValueError("this scorer was built without a norm "
                             "transform — raw records need the "
                             "ColumnConfig snapshot")
        n = len(packed)
        top = self.buckets[-1]
        if n > top:
            return np.concatenate(
                [self.score_batch_raw(packed[s:s + top])
                 for s in range(0, n, top)], axis=0)
        bucket = covering_bucket(self.buckets, n)
        wire = np.zeros((bucket, self.transform.wire_width),
                        self.transform.wire_dtype)
        wire[:n] = packed
        xx, bb = self.transform.apply_device(
            torch.from_numpy(wire).to(self.device),
            need_x=self.n_features > 0)
        return self._launch(
            xx[:, :self.n_features],
            bb[:, :self.n_bins_cols].to(self.bins_dtype).contiguous())[:n]
