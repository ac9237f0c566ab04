"""SE/ST sensitivity — the port of ``shifu_tpu.ops.sensitivity`` (the
reference's varselect MR job, ``core/varselect/VarSelectMapper.java:93-120``:
re-score every record with candidate column *i* frozen to its mean and
accumulate the squared-error rise), as a streamed, mask-batched program.

- The norm plane streams window by window through ``ShardStream`` and
  ``ResidentCache`` (windows under ``shifu.train.deviceCacheBytes`` stay
  on the device between the two passes; the rest re-stream).
- Pass 1 accumulates the feature sums (the means) and the unfrozen base
  error.  Pass 2 scores ``MaskBatch`` masks a launch: freezing block *i*
  only moves the first layer's pre-activation by ``dx[:, block] @
  W0[block]`` (``dx = mean - x``), so ``z = x @ W0 + b0`` is computed once
  a window and each mask adds its rank-``|block|`` update; deeper layers
  run per mask.
- Every partial sum is weighted by row validity (1 real, 0 padded), which
  gives the resident loop's unweighted mean, and accumulates across
  windows in float64 on the device; the scores come back in ONE fetch at
  the end.
- On a mesh (``mesh``, the data axis above 1) each rank keeps its block of
  every window's rows (``row_block``; the caller's windows are a
  multiple of the data axis, as the reference's are); the feature sums and
  base error sum over the data group in one all_reduce after pass 1, the
  per-candidate squared-error sums in one after pass 2.

The forward is plain ``torch.matmul`` (the reference computes it outside
any Pallas kernel).  :func:`per_column_scores` is the resident
per-column loop, kept as the oracle.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import nn as nn_model


def mask_batch_size(params: Optional[dict] = None,
                    override: Optional[int] = None) -> int:
    """The mask batch B: an explicit override, else varSelect param
    ``MaskBatch``, else ``-Dshifu.varsel.maskBatch=N``, else 32."""
    if override is not None:
        return max(1, int(override))
    p = params or {}
    if "MaskBatch" in p:
        return max(1, int(p["MaskBatch"]))
    from ..config import environment
    return max(1, environment.get_int("shifu.varsel.maskBatch", 32))


def mask_matrix(n_features: int,
                blocks: Sequence[Sequence[int]]) -> np.ndarray:
    """[C, D] bool masks from each candidate's feature-index block (a
    one-hot or WOE block freezes whole)."""
    masks = np.zeros((len(blocks), n_features), bool)
    for i, idx in enumerate(blocks):
        masks[i, list(idx)] = True
    return masks


def _sq_err(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row squared error over the score vector ``[..., N]``."""
    return ((pred - y.unsqueeze(-1)) ** 2).sum(dim=-1)


def _on(params, dev: torch.device):
    return [{k: torch.as_tensor(layer[k], dtype=torch.float32).to(dev)
             for k in ("b", "w")} for layer in params]


def per_column_scores(spec, params, x, y, masks: np.ndarray,
                      device=None) -> Tuple[np.ndarray, float]:
    """The resident per-column loop (the oracle): one frozen forward over
    the whole plane a candidate.  (frozen MSE [C] float64, base MSE)."""
    dev = resolve_device(device)
    p = _on(params, dev)
    xd = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    yd = torch.as_tensor(np.asarray(y, np.float32)).to(dev)
    with torch.no_grad():
        base = float(_sq_err(nn_model.forward(p, spec, xd), yd).mean())
        mean_x = xd.mean(dim=0)
        mse = []
        for m in masks:
            md = torch.as_tensor(np.asarray(m, bool)).to(dev)
            xf = torch.where(md, mean_x, xd)
            mse.append(float(_sq_err(nn_model.forward(p, spec, xf),
                                     yd).mean()))
    return np.asarray(mse, np.float64), base


def streamed_sensitivity(stream, spec, params, masks: np.ndarray,
                         mask_batch: Optional[int] = None,
                         cache_budget: Optional[int] = None, device=None,
                         mesh=None) -> Tuple[np.ndarray, float, int]:
    """The streamed, mask-batched job over ``stream`` (a ``ShardStream``
    over the norm plane with keys ``("x", "y")``) for the [C, D] candidate
    ``masks``.  Returns (frozen MSE [C] float64, base MSE, rows seen); on
    resident data the scores are :func:`per_column_scores`' up to the
    order of the sums."""
    from ..data.streaming import PreparedWindow, ResidentCache
    from ..parallel.mesh import all_reduce, data_sharded
    from ..train.dt_trainer import _WindowCopier

    dev = resolve_device(device)
    sharded = data_sharded(mesh)
    C, D = masks.shape
    if C == 0:
        raise ValueError("streamed_sensitivity: no candidate masks")
    B = min(mask_batch_size(override=mask_batch), C)
    n_batches = math.ceil(C / B)
    # block indices padded to the widest block: index D points at a zero
    # column of dx and a zero row of W0, so padded slots add nothing
    k_max = max(int(m.sum()) for m in masks) or 1
    idx_pad = np.full((n_batches * B, k_max), D, np.int64)
    for i, m in enumerate(masks):
        nz = np.flatnonzero(m)
        idx_pad[i, :len(nz)] = nz
    idx_d = torch.from_numpy(idx_pad).to(dev).reshape(n_batches, B, k_max)
    p = _on(params, dev)
    w0p = torch.cat([p[0]["w"], torch.zeros_like(p[0]["w"][:1])])
    acts = [nn_model.activation(a) for a in spec.activations]
    out_act = nn_model.activation(spec.output_activation)

    def mask_sse(idx_b, z, dxp, y, w):
        """[B] validity-weighted squared errors of B frozen forwards that
        share the window's base pre-activation ``z``."""
        zf = z + torch.einsum("nbk,bkh->bnh", dxp[:, idx_b], w0p[idx_b])
        if len(p) == 1:                       # 0-hidden-layer net (LR)
            pred = out_act(zf)
        else:
            h = acts[0](zf)
            for i, layer in enumerate(p[1:-1], start=1):
                h = acts[i % max(1, len(acts))](h @ layer["w"] + layer["b"])
            pred = out_act(h @ p[-1]["w"] + p[-1]["b"])
        return (_sq_err(pred, y) * w).sum(dim=-1)

    copier = _WindowCopier(dev)

    def prepare(win):
        valid = np.zeros(win.rows, np.float32)
        valid[:win.n_valid] = 1.0            # padded rows weigh zero
        r0, r1 = mesh.row_block(win.rows) if sharded else (0, win.rows)
        arrays, sync = copier(
            {"y": np.asarray(win.arrays["y"][r0:r1], np.float32),
             "w": valid[r0:r1]},
            extra={"x": np.asarray(win.arrays["x"][r0:r1], np.float32)})
        return PreparedWindow(win.start, win.n_valid, win.rows, win.index,
                              arrays, on_consume=sync)

    if cache_budget is None:
        from ..config import environment
        cache_budget = environment.get_int("shifu.train.deviceCacheBytes",
                                           1 << 30)
    cache = ResidentCache(stream, cache_budget, prepare)
    f64 = torch.float64
    sum_x = torch.zeros(D, dtype=f64, device=dev)
    stats = torch.zeros(2, dtype=f64, device=dev)
    n_windows = 0
    with torch.no_grad():
        for it in cache.items():                       # pass 1
            x, y, w = it.arrays["x"], it.arrays["y"], it.arrays["w"]
            per = _sq_err(nn_model.forward(p, spec, x), y)
            sum_x += (x * w[:, None]).sum(dim=0).to(f64)
            stats += torch.stack([(per * w).sum(), w.sum()]).to(f64)
            n_windows += 1
        if n_windows == 0:
            raise RuntimeError("streamed sensitivity: empty shard stream")
        if sharded:
            both = all_reduce(mesh, torch.cat([sum_x, stats]))
            sum_x, stats = both[:D], both[D:]
        mean_x = (sum_x / torch.clamp(stats[1], min=1.0)).float()
        acc = torch.zeros((n_batches, B), dtype=f64, device=dev)
        for it in cache.items():                       # pass 2
            x, y, w = it.arrays["x"], it.arrays["y"], it.arrays["w"]
            z = x @ p[0]["w"] + p[0]["b"]
            dxp = torch.cat([mean_x[None, :] - x,
                             torch.zeros_like(x[:, :1])], dim=1)
            for bi in range(n_batches):
                acc[bi] += mask_sse(idx_d[bi], z, dxp, y, w).to(f64)
        if sharded:
            all_reduce(mesh, acc)
        # the one fetch: per-mask SSE, then (base SSE, weight sum)
        packed = torch.cat([acc.reshape(-1), stats]).cpu().numpy()
    wsum = max(float(packed[-1]), 1e-12)
    return packed[:C] / wsum, float(packed[-2] / wsum), \
        int(round(float(packed[-1])))
