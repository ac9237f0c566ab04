"""WDL trainer — the port of ``shifu_tpu.train.wdl_trainer`` (reference
``WDLWorker``/``WDLMaster``/``WDLOutput``, ``core/dtrain/wdl/``): the BSP
gradient loop over the dual data planes, normalized numerics from
``tmp/NormalizedData`` and categorical bin ids from ``tmp/CleanedData``.

It has the NN trainer's shape (``train/nn_trainer.py``): bagging members
stack on a leading axis and share every launch, one ``torch.autograd``
pass over the members' summed losses gives each its own gradient, and the
epoch bookkeeping (best epochs on the device, early stop, trainer
checkpoints and ``train -resume``) is the NN trainer's ``_EpochLedger``.

- :func:`train_wdl_ensemble` holds both planes on the device: one host
  shuffle of the rows, padding to the batch multiple with zero-weight
  rows, then full-batch steps or ``MiniBatchs`` batches in an order drawn
  each epoch (``default_rng([seed, 1])``, replayed on resume).  The plane's
  categorical ids map to the flat tables' rows once
  (``models.wdl.global_ids``), so a step is one gather a table.
- :func:`train_wdl_streamed` streams both planes window by window
  (:class:`ZippedPlanes`): full-batch gradient sums accumulate on the
  device, one update an epoch, each epoch's errors measured on the params
  entering it, and a closing eval-only sweep.  With ``elastic`` (the
  reference's ``shifu.dcn.elastic``, ``parallel/elastic.py``) each epoch
  closes through the quorum step protocol, each controller a world of
  one on its own card.

L2 (deep weights and embeddings) is added to the gradient analytically;
``TrainPrecision`` (``f32`` / ``bf16`` / ``mixed``) narrows the params as
the NN trainer does.

On a ``torch.distributed`` mesh (``parallel/mesh.py``) both trainers take
the reference's geometry: members on the ensemble axis, each batch's (or
window's) rows split over the data axis, the dense gradients and error
sums summed over the data group.  The tables are replicated (their
gradients join the dense all_reduce) or, with ``shifu.wdl.shardTables``
(``on`` on any world, ``auto`` past ``shifu.wdl.shardMinBytes`` on a
data axis above 1), row-sharded (``train/wdl_shard.py``): a rank holds
``ceil(card / D)`` rows of every table and of its optimizer state, and
steps only those.  The ledger keeps a rank's own layout (its members,
its shards) for the best params too; checkpoints and saved models gather
every member's true-layout params only when they are written, so files
keep their shapes whatever the world and no epoch gathers a whole
table.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, resolve_device
from ..data.shards import Shards
from ..data.streaming import PreparedWindow, ShardStream
from ..models import wdl as wdl_model
from ..ops import prng
from ..parallel import mesh as meshlib
from .checkpoint import tree_leaves, tree_unflatten
from .nn_trainer import (EnsembleResult, TrainSettings, _EpochLedger,
                         _flat_all_reduce, _mesh_rows, _upload)
from .optimizers import (cast_tree, make_optimizer, mixed_apply, mixed_init,
                         per_member, resolve_precision, tree_map)
from .sampling import member_masks

log = logging.getLogger(__name__)


def plane_indices(schema: dict, column_configs
                  ) -> Tuple[List[int], List[int], List[int], List[int]]:
    """Column index lists of the dual planes, from the schema and
    ColumnConfig only (no data read): the numeric feature columns of the
    norm plane and the categorical bin columns of the clean plane, with
    their column numbers."""
    col_nums = schema["columnNums"]
    names = schema["outputNames"]
    by_num = {c.columnNum: c for c in column_configs}
    # output features map back to source columns by name prefix
    name_to_num = {by_num[cn].columnName: cn for cn in col_nums
                   if cn in by_num}
    blocks: Dict[int, List[int]] = {}
    for i, n in enumerate(names):
        base = n
        if base not in name_to_num and "_" in base:
            stem, suf = base.rsplit("_", 1)
            if stem in name_to_num and suf.isdigit():
                base = stem
        cn = name_to_num.get(base)
        if cn is not None:
            blocks.setdefault(cn, []).append(i)

    num_feat_idx: List[int] = []
    num_col_nums: List[int] = []
    cat_col_idx: List[int] = []
    cat_col_nums: List[int] = []
    for j, cn in enumerate(col_nums):
        cc = by_num.get(cn)
        if cc is None:
            continue
        if cc.is_categorical():
            cat_col_idx.append(j)
            cat_col_nums.append(cn)
        else:
            num_feat_idx.extend(blocks.get(cn, []))
            num_col_nums.append(cn)
    return num_feat_idx, cat_col_idx, num_col_nums, cat_col_nums


def split_planes(x: np.ndarray, bins: np.ndarray, schema: dict,
                 column_configs):
    """(numeric features, categorical bin ids, num_feat_idx, cat_col_idx,
    num_col_nums, cat_col_nums) of the materialized planes."""
    num_feat_idx, cat_col_idx, num_col_nums, cat_col_nums = \
        plane_indices(schema, column_configs)
    x_num = x[:, num_feat_idx] if num_feat_idx else \
        np.zeros((len(x), 0), np.float32)
    x_cat = bins[:, cat_col_idx] if cat_col_idx else \
        np.zeros((len(x), 0), np.int32)
    return x_num, x_cat, num_feat_idx, cat_col_idx, num_col_nums, \
        cat_col_nums


# ------------------------------------------------------------ shared step
def _init_stack(spec, settings: TrainSettings, bags: int,
                dev: torch.device):
    """(key, optimizer, precision, stacked params, optimizer state) on
    ``dev``: member ``i`` from ``split(PRNGKey(seed), bags)[i]``."""
    key = prng.prng_key(settings.seed)
    init_list = [wdl_model.init_params(k, spec)
                 for k in prng.split(key, bags)]
    opt = make_optimizer(settings.optimizer, settings.learning_rate,
                         **settings.opt_kwargs)
    precision = resolve_precision(settings.precision)
    if precision != "f32":
        init_list = [cast_tree(p, torch.bfloat16) for p in init_list]
    stacked = tree_map(lambda *ts: torch.stack(ts).to(dev), *init_list)
    opt_state = mixed_init(opt, stacked, bags) if precision == "mixed" \
        else opt.init(stacked, bags)
    return key, opt, precision, stacked, opt_state


def _grads(stacked, loss_fn):
    """(loss_fn's extra output, the gradient tree of ``loss_fn(params)``'s
    first output) for stacked params (the members' losses summed)."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), stacked)
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, extra = loss_fn(params)
        flat = torch.autograd.grad(loss, leaves)
    return extra, tree_unflatten(params, list(flat))


def _add_l2(grads, stacked, l2: float):
    """``l2_grads`` added where it is non-zero: the deep weights and the
    embedding tables."""
    if not l2:
        return grads
    for g, layer in zip(grads.get("deep", []), stacked.get("deep", [])):
        g["w"] = g["w"] + 2.0 * l2 * layer["w"]
    if "embed" in grads:
        grads["embed"] = grads["embed"] + 2.0 * l2 * stacked["embed"]
    return grads


def _apply(opt, precision: str, stacked, opt_state, grads):
    if precision == "mixed":
        return mixed_apply(opt, grads, opt_state)
    delta, opt_state = opt.update(grads, opt_state, stacked)
    # applied in the PARAM dtype (a bf16 ladder keeps bf16 params)
    return tree_map(lambda p, d: p + d.to(p.dtype), stacked, delta), \
        opt_state


def _errors(per: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    return (per * mw).sum(-1) / torch.clamp(mw.sum(-1), min=1e-9)


# ------------------------------------------------------------ resident
class _Layout:
    """Where a run's rows, members and tables live: the mesh's data group
    splits the rows (``sharded``), its ensemble group the members (``ens``,
    this rank's ``m0:m1``), and the row-sharded plane (``plane``, or None:
    replicated tables) the tables' rows.  :meth:`whole` turns a local tree
    into every member's true-layout tree (a checkpoint's, the result's)
    and :meth:`local` back."""

    def __init__(self, mesh, spec, bags: int, precision: str,
                 shard: Optional[bool]):
        from . import wdl_shard
        self.mesh = mesh
        self.sharded = meshlib.data_sharded(mesh)
        self.n_data = mesh.n_data if self.sharded else 1
        self.ens = mesh is not None and mesh.n_ensemble > 1
        self.m0, self.m1 = mesh.member_block(bags) if self.ens else (0, bags)
        self.plane = wdl_shard.WDLShardPlane(mesh, spec, bags) \
            if wdl_shard.shard_enabled(spec, mesh, bags, precision,
                                       override=shard) else None
        if self.plane is not None:
            extra = spec.extra or {}
            wdl_shard.record_shard_gauges(
                self.plane, precision, int(extra.get("hash_buckets", 0) or 0),
                len(extra.get("hashed_cols") or []))
            log.info("WDL tables row-sharded over %d rank(s): %d of %d rows "
                     "a rank", self.plane.d, self.plane.local_rows,
                     int(self.plane.offsets[-1]))

    def local(self, tree):
        if self.ens:
            tree = tree_map(lambda t: t[self.m0:self.m1].clone(), tree)
        return self.plane.local(tree) if self.plane is not None else tree

    def whole(self, tree):
        if self.plane is not None:
            tree = self.plane.whole(tree)
        return meshlib.gather_members(self.mesh, tree) if self.ens else tree

    def reduce_grads(self, grads):
        """The data group's gradient: the dense leaves (and replicated
        tables) summed in one all_reduce; sharded tables are complete."""
        if not self.sharded:
            return grads
        if self.plane is None:
            return _flat_all_reduce(self.mesh, grads)
        from .wdl_shard import split_grads
        dense, tables = split_grads(grads)
        return {**_flat_all_reduce(self.mesh, dense), **tables}

    def every_member(self, t: torch.Tensor) -> torch.Tensor:
        """[B, ...] of every member from this rank's [m, ...]."""
        return meshlib.all_gather(self.mesh, t.contiguous(),
                                  axis="ensemble") if self.ens else t


def train_wdl_ensemble(x_num, x_cat, y, w, spec: wdl_model.WDLModelSpec,
                       settings: TrainSettings, bags: int = 1,
                       valid_rate: float = 0.2,
                       sample_rate: float = 1.0, replacement: bool = False,
                       stratified: bool = False,
                       up_sample_weight: float = 1.0,
                       progress=None, shard: Optional[bool] = None,
                       device=None, mesh=None) -> EnsembleResult:
    """``bags`` members trained stacked on ``device`` (default CUDA) over
    the resident planes.

    ``mesh`` (``parallel.mesh.device_mesh(n_ensemble=bags)``; every rank
    passes the whole arrays) follows the reference's geometry: the batch
    size rounds down to a multiple of the data axis, the rows pad once to
    the batch multiple with zero weight, and a rank keeps its block of
    every minibatch and its members (the ensemble axis).  ``shard``
    overrides ``shifu.wdl.shardTables``: the row-sharded plane
    (``train/wdl_shard.py``), else replicated tables whose gradients sum
    in one flat all_reduce a step.  Errors sum over the data group in
    float64; the ledger keeps this rank's layout and gathers every
    member's true-layout params only to write them."""
    dev = resolve_device(device)
    n = len(y)
    # hashed-ID columns fold into bucket space once, on the raw bins
    x_cat = wdl_model.apply_hash_host(spec, np.asarray(x_cat, np.int32))
    train_w, valid_w = member_masks(
        n, bags, valid_rate=valid_rate, sample_rate=sample_rate,
        replacement=replacement, stratified=stratified,
        up_sample_weight=up_sample_weight, targets=y, seed=settings.seed)
    train_w = train_w * np.asarray(w, np.float32)[None, :]
    valid_w = valid_w * np.asarray(w, np.float32)[None, :]
    key, opt, precision, stacked, opt_state = _init_stack(
        spec, settings, bags, dev)
    lay = _Layout(mesh, spec, bags, precision, shard)
    bs = settings.batch_size
    if bs:
        bs = max(bs - bs % lay.n_data, lay.n_data)
    # one host shuffle, so contiguous minibatches mix classes; the batch
    # ORDER is redrawn every epoch
    perm = np.random.default_rng(settings.seed).permutation(n)
    xn = np.asarray(x_num, np.float32)[perm]
    xc = x_cat[perm]
    yv = np.asarray(y, np.float32)[perm]
    train_w, valid_w = train_w[:, perm], valid_w[:, perm]
    extra = (-n) % (bs or lay.n_data)
    if extra:                       # zero-weight rows to the batch multiple
        xn = np.concatenate([xn, np.zeros((extra, xn.shape[1]), xn.dtype)])
        xc = np.concatenate([xc, np.zeros((extra, xc.shape[1]), xc.dtype)])
        yv = np.concatenate([yv, np.zeros(extra, yv.dtype)])
        zpad = np.zeros((bags, extra), np.float32)
        train_w = np.concatenate([train_w, zpad], axis=1)
        valid_w = np.concatenate([valid_w, zpad], axis=1)
    n_padded = len(yv)
    batched = bool(bs) and bs < n_padded
    nb = n_padded // bs if batched else 1
    if lay.sharded:
        rows = _mesh_rows(mesh, n_padded, bs if batched else 0)
        xn, xc, yv = xn[rows], xc[rows], yv[rows]
        train_w, valid_w = train_w[:, rows], valid_w[:, rows]
    train_w = train_w[lay.m0:lay.m1]
    valid_w = valid_w[lay.m0:lay.m1]
    n_local = len(yv)
    lb = n_local // nb                              # a rank's batch rows

    whole_init = stacked, opt_state         # the checkpoint's template
    stacked, opt_state = lay.local(stacked), lay.local(opt_state)
    xnd = _upload(xn, dev)
    yd = _upload(yv, dev).unsqueeze(-1)
    twd, vwd = _upload(train_w, dev), _upload(valid_w, dev)
    ids = None
    if spec.cat_cardinalities:
        xcd = torch.from_numpy(np.ascontiguousarray(xc)).to(dev)
        if lay.plane is None:
            ids = wdl_model.global_ids(spec, xcd)
        else:
            # every rank's ids, gathered once (they do not change between
            # epochs): [D, n_local, C] rows of this rank's shard and masks
            lid, owned = lay.plane.gathered_ids(xcd)
            ids = (lid.reshape(lay.n_data, n_local, -1),
                   owned.reshape(lay.n_data, n_local, -1))
    if lay.sharded:
        # every rank's weight sums: each batch's train weight (the loss
        # denominator) and the train and valid totals (the errors')
        den = meshlib.all_reduce(mesh, torch.cat([
            twd.double().reshape(twd.shape[0], nb, -1).sum(-1).T,
            twd.double().sum(-1)[None], vwd.double().sum(-1)[None]]))
        batch_den = den[:nb].float().clamp_min(1e-9)
        err_den = den[nb:].clamp_min(1e-9)

    def logits(params, s: int, e: int):
        if lay.plane is None:
            return wdl_model.logits_from_ids(
                params, spec, xnd[s:e], None if ids is None else ids[s:e],
                e - s)
        blk = None if ids is None else tuple(
            t[:, s:e].reshape(-1, t.shape[-1]) for t in ids)
        return lay.plane.logits(params, xnd[s:e], blk, e - s)

    def step(stacked, opt_state, bi: int):
        s, e = bi * lb, (bi + 1) * lb
        tw = twd[:, s:e]
        # the normaliser stays outside the gradient; L2 is added after
        inv = 1.0 / (batch_den[bi] if lay.sharded
                     else torch.clamp(tw.sum(-1), min=1e-9))

        def loss(params):
            per = wdl_model.per_row_bce(torch.sigmoid(logits(params, s, e)),
                                        yd[s:e])
            return ((per * tw).sum(-1) * inv).sum(), None
        _, grads = _grads(stacked, loss)
        grads = _add_l2(lay.reduce_grads(grads), stacked, settings.l2)
        return _apply(opt, precision, stacked, opt_state, grads)

    def eval_errors(stacked) -> torch.Tensor:
        per = wdl_model.per_row_bce(
            torch.sigmoid(logits(stacked, 0, n_local)), yd)
        if lay.sharded:
            num = meshlib.all_reduce(mesh, torch.stack([
                (per * mw).double().sum(-1) for mw in (twd, vwd)]))
            errs = (num / err_den).float()
        else:
            errs = torch.stack([_errors(per, twd), _errors(per, vwd)])
        return lay.every_member(errs.T).T

    ledger = _EpochLedger(settings, stacked, bags, precision, progress,
                          None, dev, layout=lay)
    ledger.trainer = "wdl"
    order_rng = np.random.default_rng([settings.seed, 1])
    # the reference draws each epoch's order over the batches' first rows
    starts_of = np.arange(0, n_padded - bs + 1, bs).astype(np.int32) \
        if batched else None
    epochs_run = start_epoch = 0
    epochs_target = settings.epochs
    restored = ledger.resume(*whole_init) \
        if settings.resume and settings.checkpoint_dir else None
    del whole_init
    if restored is not None:
        start_epoch, epochs_target, stacked, opt_state, key = restored
        stacked, opt_state = lay.local(stacked), lay.local(opt_state)
        del restored
        # replay the batch-order stream up to the resume point
        for _ in range(min(start_epoch, epochs_target) if batched else 0):
            order_rng.permutation(starts_of)
    for epoch in range(start_epoch, epochs_target):
        for s in (order_rng.permutation(starts_of).tolist() if batched
                  else [0]):
            stacked, opt_state = step(stacked, opt_state, s // max(bs, 1))
        with torch.no_grad():
            errs = eval_errors(stacked)
            tr, va = errs.cpu().numpy()                    # the one fetch
            stop_now = ledger.record(epoch, tr, va, stacked,
                                     va_dev=errs[1])
        epochs_run = epoch + 1
        if lay.plane is not None and obs.enabled():
            from .wdl_shard import record_epoch_launches
            record_epoch_launches(lay.plane, n_padded, nb, precision)
        ledger.end_epoch(epoch, stacked, opt_state, key, stop_now)
        if stop_now:
            log.info("WDL early stop at epoch %d", epoch)
            break
    return ledger.result(stacked, epochs_run)


# ------------------------------------------------------------- streaming
class ZippedPlanes:
    """The norm (``x``, ``y``, ``w``) and clean (``bins``) planes zipped
    into joint windows: both were written by the norm step with the same
    rows in the same order, which every window checks."""

    #: window assembly and the trainer's ``prepare`` on a background
    #: thread, as for one plane
    prepared = ShardStream.prepared

    def __init__(self, norm_shards: Shards, clean_shards: Shards,
                 window_rows: int, remainder_multiple: int = 0):
        # one remainder ladder, so the zipped tail windows agree
        self.norm = ShardStream(norm_shards, ("x", "y", "w"), window_rows,
                                remainder_multiple=remainder_multiple)
        self.clean = ShardStream(clean_shards, ("bins",), window_rows,
                                 remainder_multiple=remainder_multiple)
        self.window_rows = window_rows
        self.prefetch = self.norm.prefetch

    @property
    def num_rows(self) -> int:
        return self.norm.num_rows

    def windows(self, start_shard: int = 0, shard_offset: int = 0,
                start_row: int = 0):
        for nw, cw in zip(self.norm.windows(), self.clean.windows()):
            if nw.start != cw.start or nw.rows != cw.rows:
                raise ValueError("norm/clean planes disagree on row layout")
            nw.arrays["bins"] = cw.arrays["bins"]
            yield nw


def train_wdl_streamed(planes: ZippedPlanes, spec: wdl_model.WDLModelSpec,
                       settings: TrainSettings, bags: int, mask_fn,
                       num_feat_idx, cat_col_idx, progress=None,
                       elastic=None, shard: Optional[bool] = None,
                       device=None, mesh=None) -> EnsembleResult:
    """Out-of-core WDL on ``device`` (default CUDA): full-batch gradient
    sums over ``planes``' windows, one update an epoch (the reference's
    BSP iteration, ``WDLMaster``'s aggregation).  ``mask_fn(index,
    targets)`` gives each window's ``[bags, rows]`` sampling masks.

    ``mesh``: every rank reads each window and keeps its block of the rows
    (padded to ``ceil(rows / data)`` with zero-weight rows, so every
    rank's block has one size) and its members; the data group sums the
    epoch's dense gradients and error sums in one all_reduce (the tables'
    too where they are replicated; ``shard`` / ``shifu.wdl.shardTables``
    row-shards them, ``train/wdl_shard.py``).  ``elastic`` (a
    ``parallel.elastic.ElasticContext``) closes each epoch through the
    quorum step protocol: the epoch's unnormalised gradient and error sums
    post as one contribution, the update applies the committed aggregate,
    a closed epoch replays from the journal without streaming, and the
    closing sweep is one more step."""
    from .dt_trainer import _WindowCopier
    dev = resolve_device(device)
    key, opt, precision, stacked, opt_state = _init_stack(
        spec, settings, bags, dev)
    lay = _Layout(mesh, spec, bags, precision, shard)
    whole_init = stacked, opt_state         # the checkpoint's template
    stacked, opt_state = lay.local(stacked), lay.local(opt_state)
    m = lay.m1 - lay.m0
    # mixed sums the windows' gradients in f32
    acc_dtype = torch.float32 if precision == "mixed" else None
    nf = np.asarray(num_feat_idx, np.int64)
    cf = np.asarray(cat_col_idx, np.int64)
    copier = _WindowCopier(dev)

    def block(a: np.ndarray, rows: int, axis: int = 0) -> np.ndarray:
        """This rank's rows of a window's array, zero-padded to the equal
        block of ``ceil(rows / data)``."""
        if not lay.sharded:
            return a
        per = -(-rows // lay.n_data)
        r0, r1 = mesh.row_block(rows)
        shape = list(a.shape)
        shape[axis] = per
        out = np.zeros(shape, a.dtype)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(0, r1 - r0)
        src = [slice(None)] * a.ndim
        src[axis] = slice(r0, r1)
        out[tuple(idx)] = a[tuple(src)]
        return out

    def prepare(win):
        """Plane split, hashing and masks on the host (this rank's rows
        and members), then the window's copies to the device."""
        x = np.asarray(win.arrays["x"], np.float32)
        bins = np.asarray(win.arrays["bins"]).astype(np.int32)
        tm, vm = mask_fn(win.index, win.arrays["y"])
        wcol = np.asarray(win.arrays["w"], np.float32)
        if win.n_valid < win.rows:                 # zero the padded tail
            wcol = wcol.copy()
            wcol[win.n_valid:] = 0.0
        tw = np.asarray(tm * wcol[None, :], np.float32)[lay.m0:lay.m1]
        vw = np.asarray(vm * wcol[None, :], np.float32)[lay.m0:lay.m1]
        r = win.rows
        arrays, sync = copier(
            {"y": block(np.asarray(win.arrays["y"], np.float32), r)},
            extra={
                "x": block(np.ascontiguousarray(x[:, nf]), r),
                "cat": block(wdl_model.apply_hash_host(spec, bins[:, cf]),
                             r),
                "tw": block(tw, r, 1), "vw": block(vw, r, 1)})
        return PreparedWindow(win.start, win.n_valid, win.rows, win.index,
                              arrays, on_consume=sync)

    def forward_per(params, a):
        n = a["y"].shape[0]
        if lay.plane is not None:
            ids = lay.plane.gathered_ids(a["cat"]) \
                if spec.cat_cardinalities else None
            logit = lay.plane.logits(params, a["x"], ids, n)
        else:
            ids = wdl_model.global_ids(spec, a["cat"]) \
                if spec.cat_cardinalities else None
            logit = wdl_model.logits_from_ids(params, spec, a["x"], ids, n)
        return wdl_model.per_row_bce(torch.sigmoid(logit),
                                     a["y"].unsqueeze(-1))

    def sums(per, a) -> torch.Tensor:
        tw, vw = a["tw"], a["vw"]
        return torch.stack([(per * tw).sum(-1), tw.sum(-1),
                            (per * vw).sum(-1), vw.sum(-1)], dim=1)

    def grad_eval_window(stacked, a):
        def loss(params):
            per = forward_per(params, a)
            return (per * a["tw"]).sum(), sums(per.detach(), a)
        return _grads(stacked, loss)

    def apply_update(stacked, opt_state, grad_acc, wsum):
        inv = 1.0 / torch.clamp(wsum, min=1e-9)
        g = tree_map(lambda t: t * per_member(inv, t), grad_acc)
        g = _add_l2(g, stacked, settings.l2)
        return _apply(opt, precision, stacked, opt_state, g)

    def data_sums(stats_acc, grad_acc=None):
        """The data group's epoch sums: the error sums and the gradients
        the group shares, in one all_reduce."""
        if not lay.sharded:
            return stats_acc, grad_acc
        if grad_acc is None:
            return _flat_all_reduce(mesh, stats_acc), None
        if lay.plane is None:
            return _flat_all_reduce(mesh, (stats_acc, grad_acc))
        from .wdl_shard import split_grads
        dense, tables = split_grads(grad_acc)
        stats_acc, dense = _flat_all_reduce(mesh, (stats_acc, dense))
        return stats_acc, {**dense, **tables}

    ledger = _EpochLedger(settings, stacked, bags, precision, progress,
                          None, dev, layout=lay)
    ledger.trainer = "wdl_streamed"
    if elastic is not None:
        from ..parallel.elastic import grad_codec
        ravel, unravel = grad_codec(tree_map(lambda a: torch.zeros(
            a.shape, dtype=acc_dtype or a.dtype, device=dev), stacked))

    def bookkeep(epoch_done: int, stats: torch.Tensor, snapshot) -> bool:
        stats = lay.every_member(stats).cpu().numpy().astype(np.float64)
        return ledger.record(
            epoch_done, stats[:, 0] / np.maximum(stats[:, 1], 1e-9),
            stats[:, 2] / np.maximum(stats[:, 3], 1e-9), snapshot)

    start_epoch = 0
    epochs_target = settings.epochs
    stopped = False
    restored = ledger.resume(*whole_init) \
        if settings.resume and settings.checkpoint_dir else None
    del whole_init
    if restored is not None:
        start_epoch, epochs_target, stacked, opt_state, key = restored
        stacked, opt_state = lay.local(stacked), lay.local(opt_state)
        del restored
        stopped = settings.early_stop_window > 0 and all(
            w.since_best >= w.window_size for w in ledger.stops)
    epochs_run = start_epoch

    def posted(payload) -> torch.Tensor:
        """The [B, 4] error sums of an elastic step's aggregate."""
        return torch.from_numpy(np.asarray(payload["stats"],
                                           np.float32)).to(dev)

    for epoch in range(start_epoch, epochs_target):
        entering = stacked         # the params this epoch's stats measure
        grad_acc = None
        replayed = elastic.closed_step(epoch) if elastic is not None \
            else None
        if replayed is not None:
            # a rejoiner's catch-up: apply the committed aggregate
            stats_acc = posted(replayed.payload)
            grad_acc = unravel(replayed.payload["grads"])
        else:
            stats_acc = torch.zeros((m, 4), device=dev)
            grad_acc = tree_map(lambda a: torch.zeros(
                a.shape, dtype=acc_dtype or a.dtype, device=dev), stacked)
            n_win = 0
            for win in planes.prepared(prepare):
                stats, grads = grad_eval_window(stacked, win.arrays)
                grad_acc = tree_map(torch.add, grad_acc, grads)
                stats_acc += stats
                n_win += 1
            if n_win == 0:
                raise RuntimeError("streamed WDL: empty shard stream")
            stats_acc, grad_acc = data_sums(stats_acc, grad_acc)
            if elastic is not None:
                res = elastic.step(epoch, {
                    "grads": ravel(grad_acc),
                    "stats": stats_acc.cpu().numpy()})
                stats_acc = posted(res.payload)
                grad_acc = unravel(res.payload["grads"])
        # measured on the params entering this epoch: its own ledger line
        # (the one fetch)
        stopped = bookkeep(epoch, stats_acc, entering)
        stacked, opt_state = apply_update(stacked, opt_state, grad_acc,
                                          stats_acc[:, 1])
        epochs_run = epoch + 1
        if lay.plane is not None and obs.enabled():
            from .wdl_shard import record_epoch_launches
            record_epoch_launches(lay.plane, planes.num_rows, 1, precision)
        ledger.end_epoch(epoch, stacked, opt_state, key, stopped)
        if stopped:
            log.info("WDL early stop at epoch %d (streamed)", epoch)
            break
    if not stopped:
        # a closing eval-only sweep: the last update's params compete too
        # (elastic: one more step, id ``epochs_run``)
        final = elastic.closed_step(epochs_run) if elastic is not None \
            else None
        if final is None:
            stats_acc = torch.zeros((m, 4), device=dev)
            with torch.no_grad():
                for win in planes.prepared(prepare):
                    stats_acc += sums(forward_per(stacked, win.arrays),
                                      win.arrays)
            stats_acc, _ = data_sums(stats_acc)
            if elastic is not None:
                final = elastic.step(epochs_run,
                                     {"stats": stats_acc.cpu().numpy()})
        if final is not None:
            stats_acc = posted(final.payload)
        bookkeep(epochs_run, stats_acc, stacked)
    return ledger.result(stacked, epochs_run)


# ------------------------------------------------------------ train step
def _wdl_settings(mc, p: Dict[str, Any]) -> TrainSettings:
    return TrainSettings(
        optimizer=str(p.get("Optimizer", "ADAM")),
        learning_rate=float(p.get("LearningRate", 0.002)),
        l2=float(p.get("RegularizedConstant", p.get("L2Const", 1e-5))),
        epochs=int(mc.train.numTrainEpochs),
        batch_size=int(p.get("MiniBatchs", 128)),
        early_stop_window=int(p.get("WindowSize", 10))
        if mc.train.earlyStopEnable else 0,
        seed=int(p.get("Seed", 0)),
        precision=str(p.get("TrainPrecision", "") or ""))


def _clear_models(proc) -> None:
    os.makedirs(proc.paths.models_dir, exist_ok=True)
    for f in os.listdir(proc.paths.models_dir):
        if f.startswith("model"):
            os.remove(os.path.join(proc.paths.models_dir, f))


def run_wdl_training(proc) -> int:
    """The ``train`` step for ``WDL``: grid trials one after another,
    otherwise every bagging member as one stacked run, resident or
    streamed; ``model{i}.wdl`` a member."""
    mc = proc.model_config
    trials = proc._trials(dict(mc.train.params or {}))
    if len(trials) > 1:
        return _run_wdl_grid(proc, trials)
    # a 1-trial grid (file or one-element axis) applies its values
    mc.train.params = trials[0]
    norm = proc._open_shards(proc.paths.norm_dir)
    clean = proc._open_shards(proc.paths.clean_dir)
    schema = norm.schema
    p = mc.train.params or {}
    bags = max(1, mc.train.baggingNum)
    settings = _wdl_settings(mc, p)
    from ..parallel.mesh import device_mesh
    # members on the ensemble axis, rows on the data axis (reference
    # ``device_mesh(n_ensemble=bags)``); a world of one: one card
    mesh = device_mesh(n_ensemble=bags)
    settings.checkpoint_dir = proc.paths.checkpoint_dir
    settings.checkpoint_every = int(p.get("CheckpointInterval", 25))
    settings.resume = bool(proc.params.get("resume"))
    settings.resume_extra = int(proc.params.get("refresh_extra") or 0)
    by_num = {c.columnNum: c for c in proc.column_configs}
    streaming = proc._use_streaming(norm, schema)

    with open(proc.paths.progress_path, "w") as pf:
        def progress(epoch, tr, va):
            line = (f"Epoch #{epoch + 1} Train Error: {tr:.6f} "
                    f"Validation Error: {va:.6f}")
            pf.write(line + "\n")
            pf.flush()
            log.info(line)

        if streaming:
            from ..data.streaming import (mask_fn_from_settings,
                                          stream_window_rows)
            from ..parallel.elastic import elastic_context_for
            d = len(schema.get("outputNames") or [])
            window_rows = stream_window_rows(6 * (d + 2), mesh.n_data,
                                             norm)
            # full batch: the tail window shrinks to a remainder rung
            planes = ZippedPlanes(norm, clean, window_rows,
                                  remainder_multiple=1)
            num_feat_idx, cat_col_idx, num_nums, cat_nums = \
                plane_indices(schema, proc.column_configs)
            spec = _make_spec(len(num_feat_idx), by_num, cat_nums, num_nums,
                              num_feat_idx, cat_col_idx, p)
            log.info("train WDL STREAMED on %s: %d rows, window %d, %d "
                     "members", proc.device, planes.num_rows, window_rows,
                     bags)
            if mc.train.stratifiedSample:
                log.warning("streaming: stratified validation degrades to "
                            "a Bernoulli split (it needs a global pass)")
            mask_fn = mask_fn_from_settings(
                bags, valid_rate=mc.train.validSetRate,
                sample_rate=mc.train.baggingSampleRate,
                replacement=mc.train.baggingWithReplacement,
                up_sample_weight=mc.train.upSampleWeight,
                seed=settings.seed)
            # the elastic combine (the NN path's opt-in; WDL streams full
            # batch, so it needs no gate): each controller a world of one
            ectx = elastic_context_for(proc.dir)
            with proc.phase("train"), \
                    ectx if ectx is not None else contextlib.nullcontext():
                res = train_wdl_streamed(planes, spec, settings, bags,
                                         mask_fn, num_feat_idx, cat_col_idx,
                                         progress=progress, elastic=ectx,
                                         device=proc.device, mesh=mesh)
        else:
            with proc.phase("load_data"):
                ndata = norm.load_all()
                cdata = clean.load_all()
            x, y, w = ndata["x"], ndata["y"], ndata["w"]
            bins = np.asarray(cdata["bins"]).astype(np.int32)
            x_num, x_cat, num_feat_idx, cat_col_idx, num_nums, cat_nums = \
                split_planes(x, bins, schema, proc.column_configs)
            spec = _make_spec(x_num.shape[1], by_num, cat_nums, num_nums,
                              num_feat_idx, cat_col_idx, p)
            log.info("train WDL on %s: %d rows, %d numeric + %d "
                     "categorical cols (embed %d), %d members", proc.device,
                     len(y), x_num.shape[1], len(spec.cat_cardinalities),
                     spec.embed_dim, bags)
            with proc.phase("train"):
                res = train_wdl_ensemble(
                    x_num, x_cat, y, w, spec, settings, bags=bags,
                    valid_rate=mc.train.validSetRate,
                    sample_rate=mc.train.baggingSampleRate,
                    replacement=mc.train.baggingWithReplacement,
                    stratified=mc.train.stratifiedSample,
                    up_sample_weight=mc.train.upSampleWeight,
                    progress=progress, device=proc.device, mesh=mesh)

    with proc.phase("save_models"):
        _clear_models(proc)
        for i, params in enumerate(res.params):
            wdl_model.save_model(proc.paths.model_path(i, "wdl"), spec,
                                 params)
    log.info("train WDL done: %d model(s), valid errors %s (%d epochs)",
             len(res.params), np.round(res.valid_errors, 6).tolist(),
             res.epochs_run)
    return 0


def _run_wdl_grid(proc, trials) -> int:
    """WDL grid search: trials may differ in structure (embed dim, hidden
    shape), so they train one after another, resident (the reference's
    job queue, ``gs/GridSearch.java:62``).  ``tmp/grid_search.json`` ranks
    them and the best trial's model is ``model0``."""
    from ..parallel.mesh import device_mesh
    from .grid_search import rank_and_report
    mc = proc.model_config
    mesh = device_mesh(n_ensemble=1)
    norm = Shards.open(proc.paths.norm_dir)
    clean = Shards.open(proc.paths.clean_dir)
    schema = norm.schema
    by_num = {c.columnNum: c for c in proc.column_configs}
    if proc._use_streaming(norm, schema):
        log.warning("WDL grid trials train in RAM (structural trials "
                    "cannot share a stream)")
    ndata = norm.load_all()
    cdata = clean.load_all()
    x, y, w = ndata["x"], ndata["y"], ndata["w"]
    bins = np.asarray(cdata["bins"]).astype(np.int32)
    x_num, x_cat, num_feat_idx, cat_col_idx, num_nums, cat_nums = \
        split_planes(x, bins, schema, proc.column_configs)
    results = []
    with open(proc.paths.progress_path, "w") as pf:
        for ti, p in enumerate(trials):
            spec = _make_spec(x_num.shape[1], by_num, cat_nums, num_nums,
                              num_feat_idx, cat_col_idx, p)
            settings = _wdl_settings(mc, p)

            def progress(epoch, tr, va, ti=ti):
                pf.write(f"Trial [{ti}] Epoch #{epoch + 1} Train Error: "
                         f"{tr:.6f} Validation Error: {va:.6f}\n")
                pf.flush()

            with proc.phase("train"):
                res = train_wdl_ensemble(
                    x_num, x_cat, y, w, spec, settings, bags=1,
                    valid_rate=mc.train.validSetRate,
                    sample_rate=mc.train.baggingSampleRate,
                    replacement=mc.train.baggingWithReplacement,
                    stratified=mc.train.stratifiedSample,
                    up_sample_weight=mc.train.upSampleWeight,
                    progress=progress, device=proc.device, mesh=mesh)
            results.append((float(res.valid_errors[0]), spec,
                            res.params[0], p))
            log.info("WDL grid trial %d/%d: valid err %.6f", ti + 1,
                     len(trials), res.valid_errors[0])
    order = rank_and_report(proc.paths.tmp_dir, [r[0] for r in results],
                            [r[3] for r in results])
    best = order[0]
    _clear_models(proc)
    wdl_model.save_model(proc.paths.model_path(0, "wdl"), results[best][1],
                         results[best][2])
    log.info("WDL grid search: best trial #%d valid error %.6f params %s",
             best, results[best][0], results[best][3])
    return 0


def _make_spec(numeric_dim: int, by_num, cat_nums, num_nums, num_feat_idx,
               cat_col_idx, p: Dict[str, Any]) -> wdl_model.WDLModelSpec:
    """The run's spec, with the hashed-ID plan (``HashBuckets`` /
    ``shifu.wdl.hashBuckets``) in ``spec.extra``: a categorical column
    wider than the bucket space maps its ids through splitmix64 into
    ``[0, buckets)`` and its tables shrink to the bucket count, so train,
    checkpoint and serve hash alike."""
    from ..config import environment
    from ..ops.hashing import column_hash_key
    cards = [by_num[cn].num_bins() + 1 for cn in cat_nums]
    extra: Dict[str, Any] = {"num_feat_idx": num_feat_idx,
                             "cat_col_idx": cat_col_idx}
    buckets = int(p.get("HashBuckets", 0) or 0) or \
        environment.get_int("shifu.wdl.hashBuckets", 0)
    if buckets > 0:
        hashed = [i for i, c in enumerate(cards) if c > buckets]
        if hashed:
            extra.update(
                hash_buckets=int(buckets), hashed_cols=hashed,
                hash_keys=[column_hash_key(cat_nums[i]) for i in hashed])
            cards = [buckets if i in hashed else c
                     for i, c in enumerate(cards)]
    return wdl_model.WDLModelSpec(
        numeric_dim=numeric_dim, cat_cardinalities=cards,
        embed_dim=int(p.get("EmbedColumnNum", p.get("EmbedDim", 8))),
        hidden_nodes=[int(v) for v in p.get("NumHiddenNodes", [64, 32])],
        activations=[str(a).lower()
                     for a in p.get("ActivationFunc", ["relu", "relu"])],
        wide_enable=bool(p.get("WideEnable", True)),
        deep_enable=bool(p.get("DeepEnable", True)),
        column_nums=num_nums, cat_column_nums=cat_nums,
        extra=extra)
