"""Kernel C-SVC trainer — the port of ``shifu_tpu.train.svm_trainer`` (the
reference's local libsvm SVM, ``core/alg/SVMTrainer.java:80-145``).

The JAX package departs from libsvm's SMO on purpose, and the port keeps
its formulation: the soft-margin dual as a box-constrained QP solved by
diagonally scaled projected gradient ascent, every iteration one [n, n]
kernel matvec,

    max_a  1.a - 1/2 a^T Q a,   0 <= a_i <= C,   Q = (y y^T) o (K + 1)

where ``K + 1`` folds the bias into the kernel (so libsvm's equality
constraint drops) and the decision is ``f(x) = sum_i a_i y_i (K(x_i, x) +
1)``.  Margins agree with libsvm to the optimisation tolerance; support
sets can differ on ties.  The kernel matrix is materialised, so the rows
are capped (``MAX_KERNEL_ROWS``); the loop makes no host sync, and the
one fetch is the duals at the end.
"""

from __future__ import annotations

import logging
import time
from typing import Tuple

import numpy as np
import torch

from .. import obs, resolve_device
from ..models.svm import SVMModelSpec, kernel_matrix

log = logging.getLogger(__name__)

# kernel matrix rows cap: [n, n] f32 must sit in device memory next to
# the solver state (16384^2 x 4 B = 1 GiB)
MAX_KERNEL_ROWS = 16384


def _solve_dual(x: torch.Tensor, y_pm: torch.Tensor,
                train_mask: torch.Tensor, c_box: torch.Tensor,
                spec: SVMModelSpec, iters: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Projected gradient ascent on the augmented dual.  ``c_box`` is the
    per-row box bound (0 for validation rows, which so cannot become
    support vectors: that is the train/validation split).  Returns the
    duals, the decision values on every row and the train and validation
    hinge losses, all on the device."""
    k = kernel_matrix(spec, x, x) + 1.0          # bias fold
    q = (y_pm[:, None] * y_pm[None, :]) * k
    # Gershgorin step: 1/sum_j |Q_ij| makes the simultaneous projected
    # update contract (a plain 1/Q_ii Jacobi step oscillates)
    eta = 1.0 / torch.clamp(torch.abs(q).sum(dim=1), min=1e-8)
    alpha = torch.zeros_like(y_pm)
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    for _ in range(iters):
        g = 1.0 - q @ alpha
        alpha = torch.minimum(torch.maximum(alpha + eta * g, zero), c_box)
    f = k @ (alpha * y_pm)                       # decision on all rows
    hinge = torch.clamp(1.0 - y_pm * f, min=0.0)
    va_w = 1.0 - train_mask
    tr_err = (hinge * train_mask).sum() / torch.clamp(train_mask.sum(),
                                                      min=1e-9)
    va_err = (hinge * va_w).sum() / torch.clamp(va_w.sum(), min=1e-9)
    return alpha, f, tr_err, va_err


def train_kernel_svm(x: np.ndarray, y01: np.ndarray, train_mask: np.ndarray,
                     spec: SVMModelSpec, c_penalty: float = 1.0,
                     iters: int = 2000, device=None):
    """(sv_x, alpha_y, train_hinge, valid_hinge, n_sv): solve the dual on
    the training rows on ``device`` (default CUDA) and keep the rows whose
    dual exceeds 1e-6 as support vectors."""
    n = x.shape[0]
    if n > MAX_KERNEL_ROWS:
        from ..config.errors import ErrorCode, ShifuError
        raise ShifuError(
            ErrorCode.ERROR_MODELCONFIG_NOT_VALIDATION,
            f"kernel SVM materializes an [n, n] kernel matrix; {n} rows "
            f"exceed the {MAX_KERNEL_ROWS}-row local-scale cap (the "
            "reference's libsvm SVM is local-only too) — sample the data "
            "or use NN/GBT for cluster-scale nonlinear training")
    dev = resolve_device(device)
    y_pm = torch.from_numpy(
        2.0 * np.asarray(y01, np.float32) - 1.0).to(dev)
    tm = torch.from_numpy(np.asarray(train_mask, np.float32)).to(dev)
    c_box = tm * float(c_penalty)
    t0 = time.perf_counter()
    alpha, _, tr, va = _solve_dual(
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev),
        y_pm, tm, c_box, spec, iters)
    alpha_h, tr, va = (v.cpu().numpy() for v in (alpha, tr, va))  # the sync
    solve_s = time.perf_counter() - t0
    keep = alpha_h > 1e-6
    sv_x = np.asarray(x, np.float32)[keep]
    alpha_y = (alpha_h * y_pm.cpu().numpy())[keep].astype(np.float32)
    obs.counter("train.epochs").inc(iters)   # dual iterations ~ epochs
    obs.event("svm_solve", trainer="svm", kernel=spec.kernel,
              n_sv=int(keep.sum()), rows=int(np.asarray(train_mask).sum()),
              iters=iters, train_err=round(float(tr), 6),
              valid_err=round(float(va), 6), dur_s=round(solve_s, 3))
    log.info("kernel SVM (%s) on %s: %d SVs of %d train rows, train hinge "
             "%.6f valid hinge %.6f, %d iterations in %.3f s", spec.kernel,
             dev, int(keep.sum()), int(np.asarray(train_mask).sum()),
             float(tr), float(va), iters, solve_s)
    return sv_x, alpha_y, float(tr), float(va), int(keep.sum())
