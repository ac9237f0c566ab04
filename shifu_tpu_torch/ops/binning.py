"""Streaming binning + per-column stats accumulation, and the column
binner — the port of ``shifu_tpu.ops.binning``.

The stats plane sweeps columnar chunks on the accumulator's device:
per-column count/min/max and centred moments M2..M4 (Chan et al. pairwise
combine in f64 on the host), and a fine equal-width histogram per column
(pos/neg counts and weighted counts) built by kernel B3
(:mod:`shifu_tpu_torch.ops.stats_hist`: the hand-written CUDA kernel on
``cuda``, its plain version on ``cpu``).  Bin boundaries for every binning
method are read off the fine histogram's cumulative sums; final per-bin
counts are sums of whole fine buckets.  Categorical bins are exact dict
aggregations.

The reference's jitted XLA helpers (``_moments_kernel``,
``_missing_agg_kernel``, ``_refine_prov_kernel``,
``_finalize_sketch_kernel``) are plain torch here.  Every step keeps the
f32 arithmetic XLA gives the reference where the result is read bit for
bit: the bucket id ``clip((x - lo) * (B / max(hi - lo, 1e-30)), 0, B - 1)``
truncated, the edges ``lo + (hi - lo) * k / B`` and the quantile targets.
XLA turns a division by a constant into a multiply by its f32 reciprocal
and fuses a multiply-add into one singly rounded op, and the port does the
same (:func:`_rcp`, :func:`_fma`), so bucket ids, counts, boundaries and
percentiles come out the same bits.  The one-hot and missing-cell
products run in true f32 (TF32 off for the call).

MunroPat / MunroPatI (``exact=True``) keep each column's valid values
on the host as well and read TRUE quantiles off them
(:meth:`NumericAccumulator.compute_boundaries_exact`,
:meth:`NumericAccumulator.bin_counts_exact`), as the reference does.  The
fused sweep checkpoints through :meth:`NumericAccumulator.checkpoint_state`
/ :meth:`NumericAccumulator.restore_checkpoint` (the provisional grid) and
:meth:`CategoricalAccumulator.state_lists` / ``load_state``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike
from ..config.model_config import BinningMethod
from ..parallel.mesh import (all_gather, all_reduce, data_sharded,
                             shard_chunk_rows)
from .stats_hist import stats_histograms

#: separator of merged raw categories inside one bin label (dynamic rebin;
#: reference CategoricalBinInfo)
CATEGORY_GROUP_SEP = "\x01"

NEG_INF = float("-inf")
_F32_MAX = float(np.finfo(np.float32).max)


@contextlib.contextmanager
def _true_f32():
    """Matmuls in true f32 (no TF32) for the duration, whatever the
    process-wide setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE f32 division (Python ``num / tensor``
    is ``reciprocal(den) * num`` in torch, which rounds twice)."""
    return torch.full_like(den, num) / den


def _rcp(n: int) -> float:
    """The f32 reciprocal of ``n``: XLA turns a division by a constant
    into a multiply by it."""
    return float(np.float32(1) / np.float32(n))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA's fused multiply-add
    (the f64 product of two f32 is exact)."""
    return (a.double() * b + c.double()).float()


# ----------------------------------------------------------------- kernels
def _moments_kernel(x: torch.Tensor, valid: torch.Tensor):
    """Per-column count/mean/M2/M3/M4/min/max for one chunk, f32.
    Centering by the chunk mean keeps the f32 power sums small."""
    v = valid.to(x.dtype)
    cnt = v.sum(0)
    xv = torch.where(valid, x, 0.0)
    mean = xv.sum(0) / torch.clamp(cnt, min=1.0)
    d = torch.where(valid, x - mean, 0.0)
    d2 = d * d
    m2 = d2.sum(0)
    m3 = (d2 * d).sum(0)
    m4 = (d2 * d * d).sum(0)
    mn = torch.where(valid, x, _F32_MAX).amin(0)
    mx = torch.where(valid, x, -_F32_MAX).amax(0)
    return torch.stack([cnt, mean, m2, m3, m4, mn, mx])


def _stat_channels(target: torch.Tensor, weight: torch.Tensor,
                   unit_weight: bool):
    """Per-row stat channels + their exactness flags: [pos, neg] (0/1
    indicators, exact) or [pos, neg, w_pos, w_neg] — the ONE place that
    knows the channel order."""
    is_pos = (target >= 0.5)[:, None]
    one = torch.ones_like(is_pos, dtype=torch.float32)
    pos_i = torch.where(is_pos, one, 0.0)
    neg_i = torch.where(is_pos, 0.0, one)
    if unit_weight:
        return torch.cat([pos_i, neg_i], 1), (True, True)
    w = weight[:, None]
    return torch.cat([pos_i, neg_i, torch.where(is_pos, w, 0.0),
                      torch.where(is_pos, 0.0, w)], 1), \
        (True, True, False, False)


def _bucket_ids(x, valid, lo, hi, num_buckets: int) -> torch.Tensor:
    """[R, C] int32 fine-bucket id of every valid cell, -1 elsewhere."""
    scale = _div(float(num_buckets), torch.clamp(hi - lo, min=1e-30))
    idx = torch.clamp((x - lo) * scale, 0, num_buckets - 1).to(torch.int32)
    return torch.where(valid, idx, -1)


def _histogram_kernel(x, valid, target, weight, lo, hi, num_buckets: int,
                      unit_weight: bool = False, expand: bool = True,
                      mesh=None):
    """Fine histogram of one chunk through kernel B3: [C, B, 4] (#pos,
    #neg, w_pos, w_neg), or [C, B, 2] counts with ``unit_weight`` and
    ``expand=False`` (the weighted slots then mirror the counts).  On a
    ``mesh`` whose data axis splits the rows, the histogram of every
    rank's rows (``stats_histograms_sharded``)."""
    vals, exact = _stat_channels(target, weight, unit_weight)
    h = stats_histograms(_bucket_ids(x, valid, lo, hi, num_buckets), vals,
                         num_buckets, exact, mesh)
    if unit_weight and expand:
        h = torch.cat([h, h], 2)
    return h


def _missing_agg_kernel(valid, target, weight, unit_weight: bool = False,
                        expand: bool = True):
    """[C, S] channel sums over INVALID cells — the missing bin — as one
    true-f32 product (counts stay exact integers below 2^24)."""
    vals, _ = _stat_channels(target, weight, unit_weight)
    with _true_f32():
        magg = (~valid).to(torch.float32).t() @ vals
    if unit_weight and expand:
        magg = torch.cat([magg, magg], 1)
    return magg


def _method_weight_col(hist, method_value: str, nch: int):
    """[C, K] per-fine-bucket weight measure of a binning method."""
    pos, neg = hist[..., 0], hist[..., 1]
    wpos = hist[..., 2] if nch == 4 else pos
    wneg = hist[..., 3] if nch == 4 else neg
    return {
        "EqualPositive": lambda: pos,
        "EqualNegtive": lambda: neg,
        "WeightEqualTotal": lambda: wpos + wneg,
        "WeightEqualPositive": lambda: wpos,
        "WeightEqualNegative": lambda: wneg,
    }.get(method_value, lambda: pos + neg)()


def _refine_prov_kernel(prov, plo, phi, lo, hi, num_buckets: int):
    """Re-bin a PROVISIONAL-grid fine histogram onto the exact grid: each
    provisional bucket lands whole in the final bucket its centre falls in
    (counts conserved exactly).  The centres rise with the bucket, so each
    final bucket takes a contiguous run of provisional ones: sums are
    differences of an f64 prefix sum, deterministic on every device."""
    c, k, s = prov.shape
    kk = torch.arange(num_buckets, dtype=torch.float32, device=prov.device)
    centers = _fma((phi - plo)[:, None] * (kk[None, :] + 0.5),
                   _rcp(num_buckets), plo[:, None])            # [C, K]
    scale = _div(float(num_buckets), torch.clamp(hi - lo, min=1e-30))
    idx = torch.clamp((centers - lo[:, None]) * scale[:, None], 0,
                      num_buckets - 1).to(torch.int64)         # [C, K]
    cum = torch.cat([torch.zeros((c, 1, s), dtype=torch.float64,
                                 device=prov.device),
                     torch.cumsum(prov.double(), 1)], 1)       # [C, K+1, S]
    ends = torch.searchsorted(idx, kk.to(torch.int64).expand(c, -1)
                              .contiguous(), right=True)       # [C, K]
    at = torch.gather(cum, 1, ends[..., None].expand(-1, -1, s))
    return (at - torch.cat([cum[:, :1], at[:, :-1]], 1)).float()


def _finalize_sketch_kernel(hist, magg, lo, hi, method_value: str,
                            max_bins: int, num_buckets: int, nch: int,
                            interval: bool = False) -> torch.Tensor:
    """The sketch → ColumnStats reduction on the device, packed for one
    fetch: boundaries [C, max_bins] (leading -inf, maybe duplicates), agg
    [C, max_bins+1, nch] (missing bin last), pct [C, 3], distinct [C],
    totals [C] of the method measure."""
    c = hist.shape[0]
    dev = hist.device
    weight_col = _method_weight_col(hist, method_value, nch)   # [C, K]
    edges = _fma((hi - lo)[:, None] * torch.arange(
        num_buckets + 1, dtype=torch.float32, device=dev),
        _rcp(num_buckets), lo[:, None])                         # [C, K+1]
    cum = torch.cumsum(weight_col, 1)                          # [C, K]
    total = cum[:, -1]
    frac = torch.arange(1, max_bins, dtype=torch.float32, device=dev) \
        * _rcp(max_bins)
    if interval:
        bnd = _fma((hi - lo)[:, None], frac.double(), lo[:, None])
    else:
        targets = total[:, None] * frac                        # [C, B-1]
        pos = torch.searchsorted(cum.contiguous(), targets.contiguous())
        bnd = torch.gather(edges, 1, pos + 1)
    bnd_full = torch.cat([torch.full((c, 1), NEG_INF, device=dev), bnd], 1)
    bucket_bin = torch.clamp(torch.searchsorted(
        bnd_full.contiguous(), edges[:, :-1].contiguous(), right=True) - 1,
        0, max_bins - 1)                                       # [C, K]
    onehot = (bucket_bin[:, :, None] == torch.arange(
        max_bins, device=dev)[None, None, :]).to(hist.dtype)  # [C, K, B]
    with _true_f32():
        agg_bins = torch.einsum("ckb,cks->cbs", onehot, hist)
    agg = torch.cat([agg_bins, magg[:, None, :]], 1)
    cnt_cum = torch.cumsum(hist[..., 0] + hist[..., 1], 1)     # [C, K]
    q = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float32, device=dev)
    qpos = torch.searchsorted(cnt_cum.contiguous(),
                              (cnt_cum[:, -1:] * q[None, :]).contiguous())
    pct = torch.gather(edges, 1, torch.clamp(qpos + 1, max=num_buckets))
    distinct = (hist.sum(2) > 0).sum(1)
    return torch.cat([bnd_full.reshape(-1), agg.reshape(-1),
                      pct.reshape(-1), distinct.to(torch.float32), total])


# ------------------------------------------------------- moment combination
def _combine_moments(a: dict, b: Tuple[np.ndarray, ...]) -> dict:
    """Chan et al. pairwise combination of (count, mean, M2, M3, M4)."""
    cb, mb, M2b, M3b, M4b, mnb, mxb = [np.asarray(t, np.float64) for t in b]
    if not a:
        return {"count": cb, "mean": mb, "M2": M2b, "M3": M3b, "M4": M4b,
                "min": mnb, "max": mxb}
    ca, ma, M2a, M3a, M4a = a["count"], a["mean"], a["M2"], a["M3"], a["M4"]
    n = ca + cb
    safe_n = np.maximum(n, 1.0)
    delta = mb - ma
    mean = ma + delta * cb / safe_n
    M2 = M2a + M2b + delta ** 2 * ca * cb / safe_n
    M3 = (M3a + M3b + delta ** 3 * ca * cb * (ca - cb) / safe_n ** 2
          + 3 * delta * (ca * M2b - cb * M2a) / safe_n)
    M4 = (M4a + M4b
          + delta ** 4 * ca * cb * (ca ** 2 - ca * cb + cb ** 2) / safe_n ** 3
          + 6 * delta ** 2 * (ca ** 2 * M2b + cb ** 2 * M2a) / safe_n ** 2
          + 4 * delta * (ca * M3b - cb * M3a) / safe_n)
    return {"count": n, "mean": np.where(n > 0, mean, 0.0), "M2": M2, "M3": M3,
            "M4": M4, "min": np.minimum(a["min"], mnb),
            "max": np.maximum(a["max"], mxb)}


# ------------------------------------------------------------- accumulators
@dataclass
class NumericAccumulator:
    """Streaming accumulator over numeric columns on ``device``.

    Per-chunk results stay on the device and drain to host float64 in one
    packed fetch per pass, or every ``DRAIN_ROWS`` rows (which keeps f32
    bucket counts integer-exact).  Two sweeps:

    - fused one-pass (:meth:`update_fused` / :meth:`finalize_fused`, the
      default): moments accumulate and the chunk's device tensors are kept
      up to ``fused_budget`` bytes; past it, chunks go at once into a
      PROVISIONAL-range histogram (``RangeSketch``) that re-bins onto the
      exact grid at finalize;
    - two-pass (:meth:`update_moments`, :meth:`finalize_range`,
      :meth:`update_histogram`).

    ``exact`` (MunroPat): pass 2 also keeps every column's valid values,
    pos flags and weights on the host (O(valid values) memory, as the
    reference's ``MunroPatBinning`` materializes the column).

    ``mesh`` (reference ``binning.py:117-121,369-371``): every rank passes
    the whole chunk and keeps its block of the rows
    (``parallel.mesh.shard_chunk_rows``); each chunk's per-rank moments
    are gathered and combined in rank order (counts, min and max exact,
    the rest in float64), the fine histogram sums every rank's rows
    (``stats_histograms_sharded``: bit for bit one launch over the
    chunk), and the missing-bin sums are all_reduced in float64.  Every
    rank ends with the same state."""
    n_cols: int
    num_buckets: int = 4096
    unit_weight: bool = False       # no weight column: w channels mirror counts
    device: DeviceLike = "cpu"
    moments: dict = field(default_factory=dict)
    total_rows: int = 0
    missing: Optional[np.ndarray] = None
    hist: Optional[np.ndarray] = None          # [C, K, 4] float64
    missing_agg: Optional[np.ndarray] = None   # [C, 4] pos/neg/wpos/wneg
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    fused_budget: int = 1 << 30
    exact: bool = False
    _exact_cols: Optional[list] = None     # [C] lists of (vals, pos, w)
    _pend_moments: list = field(default_factory=list)  # [7, C] device
    _pend_moment_rows: int = 0
    _hist_dev: Optional[torch.Tensor] = None
    _magg_dev: Optional[torch.Tensor] = None
    _pend_hist_rows: int = 0
    _lo_d: Optional[torch.Tensor] = None
    _hi_d: Optional[torch.Tensor] = None
    _fused_chunks: list = field(default_factory=list)
    _fused_bytes: int = 0
    _prov_hist_dev: Optional[torch.Tensor] = None
    _prov_magg_dev: Optional[torch.Tensor] = None
    _prov_lo_d: Optional[torch.Tensor] = None
    _prov_hi_d: Optional[torch.Tensor] = None
    mesh: Optional[object] = None

    # f32 histogram counts are exact integers up to 2^24; drain to host
    # float64 well before that
    DRAIN_ROWS = 8_000_000

    def __post_init__(self):
        if self.num_buckets % 64 != 0 or not \
                (64 <= self.num_buckets <= 4096):
            raise ValueError(
                f"num_buckets={self.num_buckets}: the stats fine histogram "
                "takes a multiple of 64 in [64, 4096] "
                "(ops/stats_hist.stats_histograms)")
        self.device = torch.device(self.device)

    def _put(self, *arrays):
        """The chunk's arrays on the device (x, target and weight as f32,
        valid as bool); a tensor already there stays put.  On a mesh, this
        rank's block of the rows (its padding trimmed)."""
        if data_sharded(self.mesh):
            blocks = shard_chunk_rows(self.mesh, *[
                a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                for a in arrays])
            live = int(blocks[-1].sum())
            arrays = [b[:live] for b in blocks[:-1]]
        out = []
        for a, dtype in zip(arrays, (torch.float32, torch.bool,
                                     torch.float32, torch.float32)):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(
                    a, np.bool_ if dtype == torch.bool else np.float32))
            out.append(a.to(self.device, dtype))
        return out

    def _push_moments(self, xd, vd, rows: int) -> None:
        """Queue the chunk's moments (``rows``: the chunk's rows over
        every rank); on a mesh every rank's, in rank order."""
        if xd.shape[0]:
            m = _moments_kernel(xd, vd)
        else:                              # a rank with no rows of the chunk
            m = torch.zeros((7, self.n_cols), device=xd.device)
            m[5], m[6] = _F32_MAX, -_F32_MAX
        if data_sharded(self.mesh):
            self._pend_moments.extend(all_gather(self.mesh, m[None]))
        else:
            self._pend_moments.append(m)
        self.total_rows += rows
        self._pend_moment_rows += rows
        if self._pend_moment_rows >= self.DRAIN_ROWS:
            self._drain_moments()

    def _add_hist(self, xd, vd, td, wd, lo, hi, prov: bool = False,
                  rows: Optional[int] = None):
        """Add a chunk's histogram (``rows``: its rows over every rank,
        which decide the drains alike on every rank)."""
        h = _histogram_kernel(xd, vd, td, wd, lo, hi, self.num_buckets,
                              unit_weight=self.unit_weight, expand=False,
                              mesh=self.mesh)
        magg = _missing_agg_kernel(vd, td, wd, unit_weight=self.unit_weight,
                                   expand=False)
        if data_sharded(self.mesh):
            magg = all_reduce(self.mesh, magg.double()).float()
        if prov:
            self._prov_hist_dev = h if self._prov_hist_dev is None \
                else self._prov_hist_dev + h
            self._prov_magg_dev = magg if self._prov_magg_dev is None \
                else self._prov_magg_dev + magg
            return
        self._hist_dev = h if self._hist_dev is None else self._hist_dev + h
        self._magg_dev = magg if self._magg_dev is None \
            else self._magg_dev + magg
        self._pend_hist_rows += xd.shape[0] if rows is None else rows
        if self._pend_hist_rows >= self.DRAIN_ROWS:
            self._drain_hist()

    # ---- pass 1
    def update_moments(self, x: np.ndarray, valid: np.ndarray) -> None:
        xd, vd = self._put(x, valid)
        self._push_moments(xd, vd, x.shape[0])

    def _drain_moments(self) -> None:
        if not self._pend_moments:
            return
        chunks = torch.stack(self._pend_moments).cpu().numpy() \
            .astype(np.float64)
        self._pend_moments.clear()
        self._pend_moment_rows = 0
        for m in chunks:                               # Chan combine in f64
            self.moments = _combine_moments(self.moments, tuple(m))
        # invalid cells among processed rows = rows - valid count
        self.missing = self.total_rows - self.moments["count"]

    def finalize_range(self) -> None:
        self._drain_moments()
        mn, mx = self.moments["min"].copy(), self.moments["max"].copy()
        empty = self.moments["count"] == 0
        mn[empty], mx[empty] = 0.0, 1.0
        same = mx <= mn
        mx[same] = mn[same] + 1.0
        self.lo, self.hi = mn, mx
        self._lo_d = torch.as_tensor(self.lo, dtype=torch.float32) \
            .to(self.device)
        self._hi_d = torch.as_tensor(self.hi, dtype=torch.float32) \
            .to(self.device)

    # ---- pass 2
    def update_histogram(self, x: np.ndarray, valid: np.ndarray,
                         target: np.ndarray, weight: np.ndarray) -> None:
        assert self.lo is not None, "call finalize_range() after pass 1"
        self._add_hist(*self._put(x, valid, target, weight), self._lo_d,
                       self._hi_d, rows=x.shape[0])
        if self.exact:
            if self._exact_cols is None:
                self._exact_cols = [[] for _ in range(self.n_cols)]
            x, valid = np.asarray(x), np.asarray(valid)
            pos_r = np.asarray(target, np.float64) >= 0.5
            w64 = np.asarray(weight, np.float64)
            for c in range(self.n_cols):
                v = valid[:, c]
                self._exact_cols[c].append(
                    (np.asarray(x[v, c], np.float64), pos_r[v], w64[v]))

    # ---- fused one-pass sweep (moments + histogram in ONE disk pass)
    def update_fused(self, x: np.ndarray, valid: np.ndarray,
                     target: np.ndarray, weight: np.ndarray) -> None:
        """One-pass chunk update: moments accumulate as in pass 1 and the
        chunk's device tensors are kept (up to ``fused_budget`` bytes) for
        :meth:`finalize_fused`; chunks past the budget accumulate at once
        into the provisional-range histogram.  The resident path gives the
        two-pass sweep's results bit for bit."""
        assert not self.exact, \
            "the fused sweep serves the sketch path; exact (MunroPat) " \
            "binning keeps the two-pass flow"
        xd, vd, td, wd = self._put(x, valid, target, weight)
        self._push_moments(xd, vd, x.shape[0])
        nbytes = x.shape[0] * (5 * self.n_cols + 8)   # f32 x + bool v + t/w
        if self._fused_bytes + nbytes <= self.fused_budget:
            self._fused_chunks.append((xd, vd, td, wd, x.shape[0]))
            self._fused_bytes += nbytes
            return
        if self._prov_lo_d is None:
            self._freeze_provisional()     # ONE sync, at first overflow
        self._add_hist(xd, vd, td, wd, self._prov_lo_d, self._prov_hi_d,
                       prov=True)

    def _freeze_provisional(self) -> None:
        """Freeze the provisional range from the running range sketch
        (drains the pending moments: the overflow path's one host sync)."""
        from .sketches import RangeSketch
        self._drain_moments()
        rs = RangeSketch(self.n_cols)
        rs.update(self.moments["min"], self.moments["max"])
        plo, phi = rs.provisional_bounds()
        self._prov_lo_d = torch.as_tensor(plo, dtype=torch.float32) \
            .to(self.device)
        self._prov_hi_d = torch.as_tensor(phi, dtype=torch.float32) \
            .to(self.device)

    def finalize_fused(self) -> None:
        """Close the fused sweep: the exact [lo, hi] from the moments, the
        kept chunks through the histogram on the exact grid, and the
        provisional histogram re-binned onto it — the state pass 2 would
        have left."""
        self.finalize_range()
        for xd, vd, td, wd, rows in self._fused_chunks:
            self._add_hist(xd, vd, td, wd, self._lo_d, self._hi_d,
                           rows=rows)
        self._fused_chunks.clear()
        self._fused_bytes = 0
        if self._prov_hist_dev is not None:
            refined = _refine_prov_kernel(
                self._prov_hist_dev, self._prov_lo_d, self._prov_hi_d,
                self._lo_d, self._hi_d, self.num_buckets)
            self._hist_dev = refined if self._hist_dev is None \
                else self._hist_dev + refined
            self._magg_dev = self._prov_magg_dev \
                if self._magg_dev is None \
                else self._magg_dev + self._prov_magg_dev
            self._prov_hist_dev = None
            self._prov_magg_dev = None

    # ---- mid-sweep checkpointing (stats-step crash resume)
    def spill_resident(self) -> None:
        """Move the kept fused chunks into the PROVISIONAL histogram
        (freezing its range on first use) and zero the budget, so the
        sweep's state is a few arrays and every later chunk accumulates
        provisionally too: an uninterrupted checkpointing run and a resumed
        one refine the same provisional grid at finalize."""
        if self._prov_lo_d is None:
            self._freeze_provisional()
        for xd, vd, td, wd, _ in self._fused_chunks:
            self._add_hist(xd, vd, td, wd, self._prov_lo_d,
                           self._prov_hi_d, prov=True)
        self._fused_chunks.clear()
        self._fused_bytes = 0
        self.fused_budget = 0

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """Host snapshot of the fused sweep (moments and the provisional
        histogram); restoring it and replaying the remaining chunks gives
        an uninterrupted checkpointing run's results (f32 provisional
        counts round-trip bit for bit)."""
        assert not self.exact, "exact (MunroPat) stats do not checkpoint"
        self.spill_resident()
        self._drain_moments()
        out: Dict[str, np.ndarray] = {
            "total_rows": np.asarray(self.total_rows, np.int64)}
        for k, v in self.moments.items():
            out[f"m_{k}"] = np.asarray(v)
        out["prov_lo"] = self._prov_lo_d.cpu().numpy()
        out["prov_hi"] = self._prov_hi_d.cpu().numpy()
        if self._prov_hist_dev is not None:
            out["prov_hist"] = self._prov_hist_dev.cpu().numpy()
            out["prov_magg"] = self._prov_magg_dev.cpu().numpy()
        return out

    def restore_checkpoint(self, state: Dict[str, np.ndarray]) -> None:
        self.total_rows = int(state["total_rows"])
        self.moments = {k[2:]: np.asarray(state[k], np.float64)
                        for k in state if k.startswith("m_")}
        if "count" in self.moments:
            self.missing = self.total_rows - self.moments["count"]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)) \
                .to(self.device)
        self._prov_lo_d = dev(state["prov_lo"])
        self._prov_hi_d = dev(state["prov_hi"])
        if "prov_hist" in state:
            self._prov_hist_dev = dev(state["prov_hist"])
            self._prov_magg_dev = dev(state["prov_magg"])
        self._fused_chunks.clear()
        self._fused_bytes = 0
        self.fused_budget = 0          # continue in provisional mode

    def _drain_hist(self) -> None:
        if self._hist_dev is None:
            return
        # ONE packed fetch for both accumulators
        nch = 2 if self.unit_weight else 4
        packed = torch.cat([self._hist_dev.reshape(-1),
                            self._magg_dev.reshape(-1)]).cpu().numpy() \
            .astype(np.float64)
        self._hist_dev = None
        self._magg_dev = None
        self._pend_hist_rows = 0
        n_h = self.n_cols * self.num_buckets * nch
        h = packed[:n_h].reshape(self.n_cols, self.num_buckets, nch)
        magg = packed[n_h:].reshape(self.n_cols, nch)
        if self.unit_weight:                 # w_pos = #pos, w_neg = #neg
            h = np.concatenate([h, h], axis=2)
            magg = np.concatenate([magg, magg], axis=1)
        self.hist = h if self.hist is None else self.hist + h
        self.missing_agg = (magg if self.missing_agg is None
                            else self.missing_agg + magg)

    # ---- device-side finalize (the default stats path)
    def finalize_sketch(self, method: BinningMethod, max_bins: int):
        """Boundaries + per-bin stats + percentiles + distinct counts for
        every column, reduced on the device and fetched once.

        Returns (boundaries: list of deduped [nb] arrays, aggs: list of
        [nb+1, 4] bin stats incl. trailing missing bin, pct: [C, 3]
        p25/median/p75, distinct: [C] ints) — element-exact with
        ``compute_boundaries`` + ``bin_counts`` + ``percentile`` +
        ``distinct_estimate``."""
        if self.hist is not None:
            # a mid-pass drain already moved counts to host float64;
            # re-uploading as f32 would round counts past 2^24 — stay on
            # the exact host path
            self._drain_hist()
            boundaries = self.compute_boundaries(method, max_bins)
            aggs = [self.bin_counts(c, boundaries[c])
                    for c in range(self.n_cols)]
            pct = np.stack([self.percentile(c, [0.25, 0.5, 0.75])
                            for c in range(self.n_cols)])
            distinct = np.array([self.distinct_estimate(c)
                                 for c in range(self.n_cols)])
            return boundaries, aggs, pct, distinct
        nch = 2 if self.unit_weight else 4
        assert self._hist_dev is not None, "finalize_sketch needs pass-2 data"
        C, B = self.n_cols, max_bins
        interval = method == BinningMethod.EqualInterval
        packed = _finalize_sketch_kernel(
            self._hist_dev, self._magg_dev, self._lo_d, self._hi_d,
            method.value, B, self.num_buckets, nch, interval) \
            .cpu().numpy().astype(np.float64)
        bnd_all, agg_all, pct, distinct, totals = np.split(
            packed, np.cumsum([C * B, C * (B + 1) * nch, C * 3, C]))
        bnd_all = bnd_all.reshape(C, B)
        agg_all = agg_all.reshape(C, B + 1, nch)
        pct = pct.reshape(C, 3)
        # all-missing columns have no percentiles (NaN, written as null)
        pct[np.asarray(self.moments["count"]) <= 0] = np.nan
        if nch == 2:                  # w_pos/w_neg mirror the counts
            agg_all = np.concatenate([agg_all, agg_all], axis=2)
        boundaries, aggs = [], []
        for c in range(C):
            if totals[c] <= 0 and not interval:
                # reference single-bin shape for a zero-measure column
                boundaries.append(np.array([NEG_INF]))
                agg = np.zeros((2, 4))
                agg[0] = agg_all[c, :B].sum(axis=0)
                agg[1] = agg_all[c, B]
                aggs.append(agg)
                continue
            bnds = bnd_all[c]
            keep = np.ones(B, bool)
            keep[1:] = np.diff(bnds) > 0              # _dedupe semantics
            # undeduped bin j collapses onto the last kept boundary <= j
            dd = np.cumsum(keep) - 1
            nb = int(keep.sum())
            agg = np.zeros((nb + 1, 4))
            np.add.at(agg, dd, agg_all[c, :B])
            agg[nb] = agg_all[c, B]
            boundaries.append(bnds[keep])
            aggs.append(agg)
        return boundaries, aggs, pct, distinct.astype(np.int64)

    # ---- host fallbacks (after a drain)
    def bucket_edges(self, col: int) -> np.ndarray:
        return np.linspace(self.lo[col], self.hi[col], self.num_buckets + 1)

    def compute_boundaries(self, method: BinningMethod,
                           max_bins: int) -> List[np.ndarray]:
        """Per-column bin boundaries; element 0 is -inf like the
        reference's ``binBoundary`` (v falls in bin i when b[i] <= v <
        b[i+1])."""
        self._drain_hist()
        out = []
        for c in range(self.n_cols):
            h = self.hist[c]  # [K, 4]
            if method == BinningMethod.EqualInterval:
                inner = np.linspace(self.lo[c], self.hi[c], max_bins + 1)[:-1]
                out.append(_dedupe(np.concatenate([[NEG_INF], inner[1:]])))
                continue
            weight_col = _method_weight_col(h[None], method.value, 4)[0]
            total = weight_col.sum()
            if total <= 0:
                out.append(np.array([NEG_INF]))
                continue
            cum = np.cumsum(weight_col)
            targets = total * np.arange(1, max_bins) / max_bins
            pos = np.searchsorted(cum, targets, side="left")
            edges = self.bucket_edges(c)
            out.append(_dedupe(np.concatenate([[NEG_INF], edges[pos + 1]])))
        return out

    # ---- exact (MunroPat) boundaries from the kept values
    def _exact_col(self, col: int):
        chunks = self._exact_cols[col] if self._exact_cols else []
        return (np.concatenate([c[0] for c in chunks]) if chunks
                else np.empty(0),
                np.concatenate([c[1] for c in chunks]) if chunks
                else np.empty(0, bool),
                np.concatenate([c[2] for c in chunks]) if chunks
                else np.empty(0))

    @staticmethod
    def _measure(method: BinningMethod):
        """Weight measure of one (pos, w) row set for a binning method."""
        return {
            BinningMethod.EqualTotal: lambda p, w: np.ones(len(p)),
            BinningMethod.EqualPositive: lambda p, w: p.astype(np.float64),
            BinningMethod.EqualNegtive: lambda p, w: (~p).astype(np.float64),
            BinningMethod.WeightEqualTotal: lambda p, w: w,
            BinningMethod.WeightEqualPositive: lambda p, w: w * p,
            BinningMethod.WeightEqualNegative: lambda p, w: w * ~p,
        }.get(method, lambda p, w: np.ones(len(p)))

    def compute_boundaries_exact(self, method: BinningMethod,
                                 max_bins: int) -> List[np.ndarray]:
        """Exact equal-frequency boundaries from the kept values: TRUE
        data quantiles of the method's weight measure, not fine-bucket
        edges (reference ``MunroPatBinning``).  Pair with
        :meth:`bin_counts_exact`."""
        assert self._exact_cols is not None or self.n_cols == 0, \
            "exact boundaries need exact=True collection during pass 2"
        measure = self._measure(method)
        out = []
        for c in range(self.n_cols):
            vals, pos, ws = self._exact_col(c)
            if vals.size == 0:
                out.append(np.array([NEG_INF]))
                continue
            if method == BinningMethod.EqualInterval:
                inner = np.linspace(vals.min(), vals.max(), max_bins + 1)[:-1]
                out.append(_dedupe(np.concatenate([[NEG_INF], inner[1:]])))
                continue
            wrow = measure(pos, ws)
            order = np.argsort(vals, kind="stable")
            sv, sw = vals[order], wrow[order]
            cum = np.cumsum(sw)
            total = cum[-1]
            if total <= 0:
                out.append(np.array([NEG_INF]))
                continue
            targets = total * np.arange(1, max_bins) / max_bins
            pos_idx = np.searchsorted(cum, targets, side="left")
            pos_idx = np.minimum(pos_idx, len(sv) - 1)
            out.append(_dedupe(np.concatenate([[NEG_INF], sv[pos_idx]])))
        return out

    def bin_counts_exact(self, col: int, boundaries: np.ndarray) -> np.ndarray:
        """Per-bin (pos, neg, wpos, wneg) from the kept rows, by the rule
        scoring uses (``ColumnBinner.bin_numeric``: b[i] <= v < b[i+1]),
        and the trailing missing bin."""
        self._drain_hist()
        vals, pos, ws = self._exact_col(col)
        nb = len(boundaries)
        idx = np.clip(np.searchsorted(boundaries, vals, side="right") - 1,
                      0, nb - 1)
        agg = np.zeros((nb + 1, 4))
        np.add.at(agg, (idx, 0), pos.astype(np.float64))
        np.add.at(agg, (idx, 1), (~pos).astype(np.float64))
        np.add.at(agg, (idx, 2), ws * pos)
        np.add.at(agg, (idx, 3), ws * ~pos)
        if self.missing_agg is not None:
            agg[nb] = self.missing_agg[col]
        return agg

    def bin_counts(self, col: int, boundaries: np.ndarray) -> np.ndarray:
        """Per-bin (pos, neg, wpos, wneg) incl. the trailing missing bin,
        summed from whole fine buckets."""
        self._drain_hist()
        edges = self.bucket_edges(col)
        bucket_bin = np.searchsorted(boundaries, edges[:-1], side="right") - 1
        bucket_bin = np.clip(bucket_bin, 0, len(boundaries) - 1)
        n_bins = len(boundaries)
        agg = np.zeros((n_bins + 1, 4))
        np.add.at(agg, bucket_bin, self.hist[col])
        if self.missing_agg is not None:
            agg[n_bins] = self.missing_agg[col]
        return agg

    def percentile(self, col: int, q: Sequence[float]) -> np.ndarray:
        """Percentiles to fine-bucket resolution from the sketch."""
        self._drain_hist()
        h = self.hist[col][:, 0] + self.hist[col][:, 1]
        total = h.sum()
        if total <= 0:
            return np.full(len(q), np.nan)
        cum = np.cumsum(h)
        edges = self.bucket_edges(col)
        pos = np.searchsorted(cum, np.asarray(q) * total, side="left")
        return edges[np.minimum(pos + 1, self.num_buckets)]

    def distinct_estimate(self, col: int) -> int:
        """Lower-bound distinct estimate = occupied fine buckets."""
        self._drain_hist()
        return int((self.hist[col].sum(axis=1) > 0).sum())


def _dedupe(bnds: np.ndarray) -> np.ndarray:
    keep = np.ones(len(bnds), dtype=bool)
    keep[1:] = np.diff(bnds) > 0
    return bnds[keep]


_MISSING_KEY = "\x00__missing__"


@dataclass
class CategoricalAccumulator:
    """Exact per-category pos/neg/weight aggregation (dict-based,
    streamed): one sorted unique + four weighted bincounts per chunk."""
    stats: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)

    def update(self, col_name: str, values: Sequence, valid: np.ndarray,
               target: np.ndarray, weight: np.ndarray,
               stripped: bool = False) -> None:
        """``values`` may be pre-stripped (``stripped=True`` skips the
        string pass)."""
        vals = np.empty(len(values), dtype=object)
        vals[:] = list(values) if stripped else \
            [str(v).strip() for v in values]
        cats, codes = np.unique(vals, return_inverse=True)
        self._add(col_name, list(cats), codes.reshape(-1), valid, target,
                  weight)

    def update_cells(self, col_name: str, cells: np.ndarray,
                     valid: np.ndarray, target: np.ndarray,
                     weight: np.ndarray) -> None:
        """:meth:`update` with the values' ``S`` view of stripped cells
        (``data.cells.stripped_cells``): one ``np.unique`` over it."""
        from ..data.cells import distinct
        d = distinct(cells)
        self._add(col_name, d.values, d.inverse, valid, target, weight)

    def _add(self, col_name: str, cats: List[str], codes: np.ndarray,
             valid: np.ndarray, target: np.ndarray,
             weight: np.ndarray) -> None:
        """Adds a batch's categories (sorted) and each row's code."""
        d = self.stats.setdefault(col_name, {})
        k = len(cats)
        idx = np.where(valid, codes, k)
        posf = (target >= 0.5).astype(np.float64)
        w = np.asarray(weight, np.float64)
        stacked = np.stack([
            np.bincount(idx, weights=posf, minlength=k + 1),
            np.bincount(idx, weights=1.0 - posf, minlength=k + 1),
            np.bincount(idx, weights=w * posf, minlength=k + 1),
            np.bincount(idx, weights=w * (1.0 - posf), minlength=k + 1)],
            axis=1)                                  # [k+1, 4]
        for i, cat in enumerate(cats):
            row = stacked[i]
            if not row.any():          # a missing-marker string: all rows
                continue               # of this category were invalid
            prev = d.get(cat)
            d[cat] = row if prev is None else prev + row
        m = stacked[k]
        if m.any():
            prev = d.get(_MISSING_KEY)
            d[_MISSING_KEY] = m if prev is None else prev + m

    def state_lists(self):
        """(meta, arrays) host snapshot for mid-sweep checkpoints: per
        column a category list (JSON side) and a [k, 4] count matrix."""
        meta, arrays = {}, {}
        for i, (col, d) in enumerate(self.stats.items()):
            cats = list(d.keys())
            meta[col] = {"i": i, "cats": cats}
            arrays[f"cat_{i}"] = (np.stack([d[c] for c in cats])
                                  if cats else np.zeros((0, 4)))
        return meta, arrays

    def load_state(self, meta, arrays) -> None:
        self.stats = {
            col: {c: np.asarray(arrays[f"cat_{m['i']}"][j], np.float64)
                  for j, c in enumerate(m["cats"])}
            for col, m in meta.items()}

    def finalize(self, col_name: str, max_cates: int = 0):
        """(categories, counts[cats+1, 4], n_distinct, n_missing) — last
        counts row = missing bin; categories by frequency desc, then name;
        past ``max_cates`` > 0 the rest fold into the missing bin.
        ``n_distinct`` / ``n_missing`` are the PRE-cap truths."""
        d = self.stats.get(col_name, {})
        items = [(k, v) for k, v in d.items() if k != _MISSING_KEY]
        n_distinct = len(items)
        items.sort(key=lambda kv: (-(kv[1][0] + kv[1][1]), kv[0]))
        missing = d.get(_MISSING_KEY, np.zeros(4))
        n_missing = int(missing[0] + missing[1])
        if max_cates and len(items) > max_cates:
            for _, v in items[max_cates:]:
                missing = missing + v
            items = items[:max_cates]
        cats = [k for k, _ in items]
        counts = np.stack([v for _, v in items] + [missing]) if items else \
            missing[None, :]
        return cats, counts, n_distinct, n_missing


# ----------------------------------------------------------------- binner
class ColumnBinner:
    """Maps raw column values -> bin indices given finalized binning.

    Numeric: searchsorted over binBoundary (boundary[0] = -inf); categorical:
    exact category index after a strip (a bin label may hold several raw
    categories joined by ``CATEGORY_GROUP_SEP``); missing/unseen ->
    ``num_bins`` (the trailing missing bin), matching reference
    ``BinUtils.getBinNum`` semantics.
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
