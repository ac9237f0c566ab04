"""Pearson correlation across every candidate column with pairwise-complete
semantics — the port of ``shifu_tpu.ops.correlation``.

Each pair's sums count only the rows where BOTH columns are valid (the
reference's ``CorrelationWritable`` adjustCount): per chunk four GEMMs
over the validity-masked matrix give every pair's count, sum, cross sum
and square sum, accumulated on the host.  The GEMMs are ``torch.matmul``
on the accumulator's device in float64, where the reference's are f32:
the categorical pos-rate encodings sit near 0.1 and are shifted by 0.5,
so an f32 ``n * sxx - sx * sx`` keeps only about three digits of their
variance (the reference's cells with a categorical column are off the
exact Pearson by up to ~4e-4 on the test fixture; numeric cells, shifted
by their means, agree to 1e-6).  Categorical columns take part through
their bin pos-rate encoding, which the caller supplies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import DeviceLike


def _pair_sums(x: torch.Tensor, v: torch.Tensor, offset: torch.Tensor):
    """Per-pair running sums for one chunk: x [R, C] (invalid entries may
    hold anything), v [R, C] validity, offset [C] per-column shift.
    Returns (n, sx, sxy, sxx) each [C, C], where cell (i, j) sums over rows
    valid in both i and j: n = count, sx = sum x_i, sxy = sum x_i x_j,
    sxx = sum x_i^2 — all over the shifted values (Pearson is
    shift-invariant; a shift near the column mean keeps the f32 power sums
    from cancelling)."""
    vf = v.to(x.dtype)
    xv = torch.where(v, x - offset, 0.0)
    x2v = xv * xv
    return (vf.T @ vf, xv.T @ vf, xv.T @ xv, x2v.T @ vf)


@dataclass
class CorrelationAccumulator:
    """Streaming pairwise-complete Pearson (sy/syy come free as sx^T /
    sxx^T).  ``offset`` [C] shifts each column before the sums; None = no
    shift."""
    n_cols: int
    offset: Optional[np.ndarray] = None
    device: DeviceLike = "cpu"
    n: Optional[np.ndarray] = None
    sx: Optional[np.ndarray] = None
    sxy: Optional[np.ndarray] = None
    sxx: Optional[np.ndarray] = None

    def update(self, x: np.ndarray, valid: np.ndarray) -> None:
        dev = torch.device(self.device)
        off = np.zeros(self.n_cols) if self.offset is None else self.offset
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float64)).to(dev)
        vd = torch.from_numpy(np.ascontiguousarray(valid, np.bool_)).to(dev)
        od = torch.from_numpy(np.asarray(off, np.float64)).to(dev)
        out = _pair_sums(xd, vd, od)
        n, sx, sxy, sxx = (a.cpu().numpy() for a in out)
        if self.n is None:
            self.n, self.sx, self.sxy, self.sxx = n, sx, sxy, sxx
        else:
            self.n += n
            self.sx += sx
            self.sxy += sxy
            self.sxx += sxx

    def finalize(self) -> np.ndarray:
        """[C, C] Pearson over each pair's both-valid rows; degenerate pairs
        (no overlap / zero variance) give NaN."""
        if self.n is None:
            return np.full((self.n_cols, self.n_cols), np.nan)
        n, sx, sxy, sxx = self.n, self.sx, self.sxy, self.sxx
        sy, syy = sx.T, sxx.T
        with np.errstate(invalid="ignore", divide="ignore"):
            cov = n * sxy - sx * sy
            varx = n * sxx - sx * sx
            vary = n * syy - sy * sy
            denom = np.sqrt(np.where(varx > 0, varx, np.nan)
                            * np.where(vary > 0, vary, np.nan))
            corr = cov / denom
        np.fill_diagonal(corr, 1.0)
        return corr
