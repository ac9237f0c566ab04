"""Resident tree training — the port of ``shifu_tpu.train.dt_trainer``'s
single-member GBT, RF and DT paths (reference ``DTMaster``/``DTWorker``).

- GBT: sequential trees; per-tree gradients (squared: y - f, log: y -
  sigmoid(f)) refit by a variance/Friedman tree grown level-wise on the
  device (``ops.tree.grow_tree``, kernel B1 on the card), shrinkage
  ``LearningRate``, moving-average early stop.
- RF: independent trees over Poisson row weights (bags drawn from
  ``fold_in(PRNGKey(seed), tree)`` on JAX's threefry stream, reproduced
  in ``ops.prng``), entropy/gini impurity, per-tree feature subsets, and
  out-of-bag votes as validation.  A chunk of at least ``TreeBatch`` trees
  grows in batches through ``ops.tree.grow_forest`` (one kernel B2 launch
  a level for the whole batch), the rest one by one through ``grow_tree``
  (B1); every tree equals its sequential grow bit for bit.
- DT: one RF tree over the full data, no bag.
- Native multi-class RF (``n_classes > 2``): per-class stat channels, leaf
  class distributions, misclassification errors; one-vs-all (GBT, or
  ``multiClassifyMethod ONEVSALL``) trains one binary forest per class.
- Members: bagging, k-fold and grid-search trials.  A bagged GBT grows
  the B members' trees of one boosting round together through
  ``grow_forest`` (one B2 launch a level with TB = B, where the reference
  runs B1 under ``jax.vmap``); a bagged RF trains its members one after
  the other, each in its own ``TreeBatch`` batches, on one uploaded
  plane.  Every member equals a single ``train_gbt``/``train_rf`` run on
  its weights bit for bit.

The reference grows a chunk of trees as ONE ``lax.scan`` executable with
one fetch.  PyTorch runs eagerly, so here a chunk is a Python loop over
trees with every tensor on the device and no host sync inside the growth
(no ``.item()``, no ``.cpu()``, no branch on a tensor, no boolean-mask
indexing): each tree packs its arrays into one device byte row, and the
chunk's rows cross to the host in one copy.  RF draws its chunk's bags
before growth, asking the device once a block of Poisson iterations
whether every row is done.  The chunk rules are the reference's —
checkpoint boundaries, bursts of 8 trees for progress,
``EarlyStopCheckInterval`` (GBT) — and an early stop inside a chunk
truncates the forest to the exact tree a per-tree loop would have stopped
at.

Mid-forest checkpoints (forest npz + meta json, plus GBT's per-row score
sidecar) are the reference's files, so ``train -resume`` continues a
forest either package wrote; with deterministic sums on the card a
resumed forest is bit-identical to an uninterrupted one.

A plane over ``shifu.train.memoryBudgetBytes`` (or with
``shifu.train.streaming`` on) trains out of core:
:func:`train_gbt_streamed` and :func:`train_rf_streamed` sweep it in
windows through a ``data.streaming.ResidentCache`` (the windows that fit
``shifu.train.deviceCacheBytes`` stay on the device, the tail re-streams
from the mmap'd plane), GBT's disk tail coarse-to-fine or by exact
per-level sweeps, RF's in super-batches of trees a sweep.  Members,
one-vs-all classes and OVA x bagging run as sequential streamed jobs.

On a mesh (``parallel.mesh``) the single GBT, RF and DT train resident or
streamed with their rows split over the data axis and the one-rank forest
bit for bit: the sharded B1/B2 (the kernel's int64 raw mode, one exact
all_reduce, the flush) inside the growth and the window loop.  Bagged,
k-fold, grid, one-vs-all and native multi-class runs on a mesh raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import warnings
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, ContextManager, Dict, List, Optional,
                    Tuple)

import numpy as np
import torch

from .. import faults, ioutil, obs
from ..config.model_config import Algorithm
from ..data.shards import bins_wire_dtype
from ..models import tree as tree_model
from ..ops import prng
from ..ops import tree as tree_ops
from ..parallel import mesh as meshlib
from ..ops.hashing import hash_poisson_traced, row_key_i64, thresholds_i64
from ..ops.hist import widen_bins
from ..ops.tree import (TreeArrays, _left_child_index,
                        _subtract, best_splits, build_histograms,
                        build_histograms_batch, build_path_histograms,
                        cap_splits_by_leaves, forest_predictions,
                        grow_forest, grow_tree, leaf_values_from_raw,
                        level_gain_fi,
                        n_tree_nodes, node_index_at_level, predict_forest,
                        predict_tree)
from .early_stop import GBTEarlyStopDecider
from .sampling import member_masks, validation_split

log = logging.getLogger(__name__)


@dataclass
class DTSettings:
    n_trees: int = 100
    depth: int = 7
    impurity: str = "variance"
    loss: str = "squared"
    learning_rate: float = 0.05          # GBT shrinkage
    min_instances: float = 1.0
    min_gain: float = 0.0
    feature_subset: str = "ALL"
    valid_rate: float = 0.2
    bagging_rate: float = 1.0            # RF Poisson rate
    poisson_bagging: bool = True         # False: plain single tree (DT)
    early_stop: bool = False
    seed: int = 0
    checkpoint_every: int = 25           # trees between checkpoints
    resume: bool = False
    n_classes: int = 0                   # >2: RF native multi-class
    max_leaves: int = 0                  # >0: leaf-wise node budget
    # weights promised small-integer (no weight column): the reference's
    # Pallas kernels then skip their f32-recovery dots.  Accepted for
    # parity and ignored: B1/B2 find their integer channels on the device
    # (ops/hist.py::channel_meta) and sum those in 32 bits on their own
    stats_exact: bool = False
    tree_batch: int = 0                  # RF trees a batched grow; 0 =
                                         # auto (RF_TREE_BATCH)
    early_stop_check: int = 8            # trees between early-stop checks
    tail_tree_batch: int = 0             # streamed RF trees a tail sweep;
                                         # 0 = auto (_tail_super_batch)


def settings_from_params(params: Dict[str, Any], train_conf,
                         alg: Algorithm) -> DTSettings:
    """Reference train#params tree keys: TreeNum / MaxDepth / Impurity /
    Loss / LearningRate / FeatureSubsetStrategy / MinInstancesPerNode /
    MinInfoGain / MaxLeaves / Seed / CheckpointInterval / TreeBatch /
    EarlyStopCheckInterval / TailTreeBatch, and the train section's
    validSetRate,
    baggingSampleRate and earlyStopEnable."""
    p = params or {}
    default_impurity = "variance" if alg == Algorithm.GBT else "entropy"
    return DTSettings(
        n_trees=int(p.get("TreeNum", 10 if alg != Algorithm.DT else 1)),
        depth=int(p.get("MaxDepth", 7)),
        impurity=str(p.get("Impurity", default_impurity)).lower(),
        loss=str(p.get("Loss", "squared")).lower(),
        learning_rate=float(p.get("LearningRate", 0.05)),
        min_instances=float(p.get("MinInstancesPerNode", 1)),
        min_gain=float(p.get("MinInfoGain", 0.0)),
        feature_subset=str(p.get("FeatureSubsetStrategy", "ALL")).upper(),
        max_leaves=max(0, int(p.get("MaxLeaves", -1))),
        valid_rate=float(train_conf.validSetRate),
        bagging_rate=float(train_conf.baggingSampleRate),
        poisson_bagging=alg != Algorithm.DT,  # plain DT = one tree, full data
        early_stop=bool(train_conf.earlyStopEnable),
        seed=int(p.get("Seed", 0)),
        checkpoint_every=int(p.get("CheckpointInterval", 25)),
        tree_batch=int(p.get("TreeBatch", 0)),
        early_stop_check=max(1, int(p.get("EarlyStopCheckInterval", 8))),
        tail_tree_batch=int(p.get("TailTreeBatch", 0)))


def subset_count(strategy: str, c: int) -> int:
    s = strategy.upper()
    if s == "ALL":
        return c
    if s == "HALF":
        return max(1, c // 2)
    if s == "SQRT":
        return max(1, int(np.sqrt(c)))
    if s == "LOG2":
        return max(1, int(np.log2(max(c, 2))))
    if s == "ONETHIRD":
        return max(1, c // 3)
    if s == "TWOTHIRDS":
        return max(1, 2 * c // 3)
    return c


def _tree_rng(seed: int, tree_idx: int) -> np.random.Generator:
    """Stateless per-tree RNG: a resume from tree k draws the exact feature
    subsets an uninterrupted run would."""
    return np.random.default_rng([seed, tree_idx])


def _feat_subset(settings: DTSettings, c: int, tree_idx: int) -> np.ndarray:
    k = subset_count(settings.feature_subset, c)
    fa = np.zeros(c, bool)
    fa[_tree_rng(settings.seed, tree_idx).choice(c, size=k,
                                                 replace=False)] = True
    return fa


@dataclass
class ForestResult:
    trees: List[TreeArrays]
    spec_kwargs: Dict[str, Any]
    train_error: float
    valid_error: float
    feature_importance: np.ndarray       # [C] summed split gains
    trees_built: int = 0
    history: List[Tuple[float, float]] = field(default_factory=list)
    disk_passes: int = 0                 # streamed: stream traversals
    tail_sweeps: int = 0                 # streamed: disk-tail re-streams
    bytes_read: int = 0                  # streamed: host bytes this run read
    tail_repairs: int = 0                # streamed GBT: coarse-to-fine trees
                                         # repaired below a divergence
    tail_surrender: int = -1             # streamed GBT: the tree at which
                                         # coarse-to-fine gave up (-1: never)


# ------------------------------------------------------------- one round
def _loss_grad(y, f, loss: str):
    if loss == "log":
        return y - torch.sigmoid(f)
    if loss == "absolute":
        return torch.sign(y - f)
    return y - f


def _per_row_loss(y, f, loss: str):
    if loss == "log":
        p = torch.sigmoid(f).clamp(1e-9, 1 - 1e-9)
        return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if loss == "absolute":
        return (y - f).abs()
    return (y - f) ** 2


def _gbt_stats(y, tw, f, loss: str):
    """A GBT tree's stat channels [N, 2] ``[tw, tw * grad]``."""
    return torch.stack([tw, tw * _loss_grad(y, f, loss)], dim=1).float()


def _gbt_update(y, tw, vw, f, lv, leaf_glob, settings: DTSettings):
    """Score update after one tree and the train/valid errors: (f2, tr,
    va) device tensors."""
    f2 = f + settings.learning_rate * lv[leaf_glob.long()]
    per = _per_row_loss(y, f2, settings.loss)
    tr = (per * tw).sum() / tw.sum().clamp_min(1e-9)
    va = (per * vw).sum() / vw.sum().clamp_min(1e-9)
    return f2, tr, va


def gbt_round(bins, y, tw, vw, f, fa, cat, settings: DTSettings,
              n_bins: int, impurity: str, has_cat: bool, mesh=None):
    """One GBT tree end to end on the device: residual grad -> grow ->
    score update -> train/valid error.  Returns (split_feat, left_mask,
    leaf_value, gain_fi, f2, train_err, valid_err), all device tensors.
    On a ``mesh`` the rows are this rank's block and the errors every
    rank's (float64 sums, one all_reduce)."""
    sf, lm, lv, gfi, leaf_glob = grow_tree(
        bins, _gbt_stats(y, tw, f, settings.loss), cat, fa, n_bins,
        settings.depth, impurity, settings.min_instances, settings.min_gain,
        settings.max_leaves, has_cat, mesh=mesh)
    if meshlib.data_sharded(mesh):
        f2 = f + settings.learning_rate * lv[leaf_glob.long()]
        s = meshlib.all_reduce(mesh, _error_sums(
            _per_row_loss(y, f2, settings.loss), tw, vw, torch.float64))
        return sf, lm, lv, gfi, f2, \
            (s[0] / s[1].clamp_min(1e-9)).float(), \
            (s[2] / s[3].clamp_min(1e-9)).float()
    f2, tr, va = _gbt_update(y, tw, vw, f, lv, leaf_glob, settings)
    return sf, lm, lv, gfi, f2, tr, va


def _pack_tree(sf, lm, lv, gfi, tr, va) -> torch.Tensor:
    """One tree's arrays as one device byte row: split_feat int32, left
    mask one byte per bin, leaf values ([nodes] or [nodes, K]) and gains
    f32, [train, valid] f32."""
    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([raw(sf.to(torch.int32)), lm.reshape(-1).to(torch.uint8),
                      raw(lv.float()), raw(gfi.float()),
                      raw(torch.stack([tr, va]).float())])


def _unpack_tree(row: np.ndarray, total: int, n_bins: int, c: int,
                 depth: int, n_classes: int = 0):
    """Host-side inverse of :func:`_pack_tree`: (tree, gain_fi f64,
    train_err, valid_err)."""
    k = n_classes if n_classes > 2 else 1
    sizes = [4 * total, total * n_bins, 4 * total * k, 4 * c, 8]
    sf, lm, lv, gfi, err = np.split(row, np.cumsum(sizes)[:-1])
    lv = lv.view(np.float32).copy()
    tree = TreeArrays(split_feat=sf.view(np.int32).copy(),
                      left_mask=lm.reshape(total, n_bins) > 0,
                      leaf_value=lv.reshape(total, k) if k > 1 else lv,
                      depth=depth)
    err = err.view(np.float32)
    return tree, gfi.view(np.float32).astype(np.float64), float(err[0]), \
        float(err[1])


def _with_mesh_errors(packed, sums, mesh) -> torch.Tensor:
    """``packed`` [T, L] trees with the [train, valid] errors of every
    rank's rows: ``sums`` [T, 4] float64 (:func:`_error_sums` of this
    rank's rows) summed over the data group in one all_reduce, each error
    divided in float64 and written as the rows' last two f32."""
    meshlib.all_reduce(mesh, sums)
    err = torch.stack([sums[:, 0] / sums[:, 1].clamp_min(1e-9),
                       sums[:, 2] / sums[:, 3].clamp_min(1e-9)], dim=1)
    packed[:, -8:] = err.float().contiguous().view(torch.uint8)
    return packed


def gbt_forest_chunk(bins, y, tw, vw, f, fa_all, cat, settings: DTSettings,
                     n_bins: int, impurity: str, has_cat: bool, mesh=None):
    """A chunk of the forest: one :func:`gbt_round` per row of ``fa_all``
    ([T, C] bool, on the device), with no host sync.  Returns (f after the
    chunk, packed [T, L] uint8 device tensor).  On a ``mesh`` whose data
    axis splits the rows, the tensors are this rank's block: the trees
    grow from every rank's rows, f stays the rank's own, and the errors
    are every rank's, all_reduced once a chunk in float64."""
    rows, sums = [], []
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    for j in range(fa_all.shape[0]):
        if meshlib.data_sharded(mesh):
            sf, lm, lv, gfi, leaf_glob = grow_tree(
                bins, _gbt_stats(y, tw, f, settings.loss), cat, fa_all[j],
                n_bins, settings.depth, impurity, settings.min_instances,
                settings.min_gain, settings.max_leaves, has_cat, mesh=mesh)
            f = f + settings.learning_rate * lv[leaf_glob.long()]
            sums.append(_error_sums(
                _per_row_loss(y, f, settings.loss).double(), tw.double(),
                vw.double()))
            rows.append(_pack_tree(sf, lm, lv, gfi, zero, zero))
            continue
        sf, lm, lv, gfi, f, tr, va = gbt_round(
            bins, y, tw, vw, f, fa_all[j], cat, settings, n_bins, impurity,
            has_cat)
        rows.append(_pack_tree(sf, lm, lv, gfi, tr, va))
    packed = torch.stack(rows)
    return f, _with_mesh_errors(packed, torch.stack(sums), mesh) \
        if sums else packed


def put_bins(bins, n_bins: int, device: torch.device) -> torch.Tensor:
    """The bin plane on ``device`` in the compact wire dtype — uint8 up to
    256 bins, int32 beyond (a uint16 plane widens on the device).  A plane
    in another dtype than the wire's is range-checked first: a stale clean
    dir must fail loudly, not wrap ids through the narrowing cast.  A
    tensor is a plane already put (members and classes share one upload)
    and passes as it is."""
    if isinstance(bins, torch.Tensor):
        return bins
    wire = bins_wire_dtype(n_bins)
    if bins.dtype != wire and bins.size:
        lo, hi = int(bins.min()), int(bins.max())
        if lo < 0 or hi >= n_bins:
            raise ValueError(
                f"bin ids [{lo}, {hi}] out of range for n_bins={n_bins} — "
                "the materialized clean data does not match the current "
                "ColumnConfig binning; re-run `norm`")
        bins = bins.astype(wire)
    host = bins.view(np.int16) if bins.dtype == np.uint16 else bins
    with warnings.catch_warnings():
        # a read-only memmap: torch warns that writes would be undefined,
        # and the plane is never written
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    if bins.dtype == np.uint16:
        t = widen_bins(t.view(torch.uint16))
    return t


def _replay(trees: List[TreeArrays], bins_d, f, lr: float):
    """Continuous/resume replay of restored GBT trees: the walks (kernel
    B4, ``ops.tree.forest_predictions``), then the per-tree adds in forest
    order, as the reference's eager loop does."""
    for p in forest_predictions(trees, bins_d):
        f = f + lr * p
    return f


def train_gbt(bins, y, w, n_bins: int, cat_mask, settings: DTSettings,
              progress=None, init_trees: Optional[List[TreeArrays]] = None,
              init_score: Optional[float] = None,
              checkpoint_fn: Optional[Callable] = None,
              start_history: Optional[List] = None,
              init_scores: Optional[np.ndarray] = None,
              device: Optional[torch.device] = None,
              phase: Optional[Callable[[str], ContextManager]] = None,
              mesh=None) -> ForestResult:
    """Boost ``settings.n_trees`` trees (minus restored ones) over the
    resident plane ``bins`` [N, C] (wire dtype; a memmap is fine, or a
    plane already on the device, :func:`put_bins`) on ``device``.
    On a ``mesh`` whose data axis splits the rows (the reference's
    ``device_mesh(n_ensemble=1)``), every rank passes the whole host plane
    and keeps its block (:meth:`Mesh.row_block`) on its device: the
    validation split and the prior come from the global rows on the host,
    scores and residuals stay local, and the trees grow from every rank's
    rows (:func:`gbt_forest_chunk`) — the one-rank forest, bit for bit.
    ``phase(name)`` (the step's profile timer) times the parts:
    ``train/upload`` (plane and labels to the device), ``train/replay``
    (launching restored trees through B4; the device
    finishes them inside the first chunk), ``train/grow`` (the chunks,
    each up to its one copy to the host, which waits for the device) and
    ``train/checkpoint`` (scores to the host, files)."""
    dev = torch.device(device if device is not None else "cuda")
    phase = phase or (lambda name: contextlib.nullcontext())
    n, c = bins.shape
    vmask = validation_split(n, settings.valid_rate, settings.seed)
    wt = np.asarray(w, np.float64) * ~vmask
    wv = np.asarray(w, np.float64) * vmask
    y64 = np.asarray(y, np.float64)
    sharded = meshlib.data_sharded(mesh)
    r0, r1 = mesh.row_block(n) if sharded else (0, n)

    if init_score is None:  # continuous runs reuse the saved forest's prior
        prior = float((y64 * wt).sum() / max(wt.sum(), 1e-9))
        if settings.loss == "log":
            prior = np.clip(prior, 1e-6, 1 - 1e-6)
            init_score = float(np.log(prior / (1 - prior)))
        else:
            init_score = prior

    with phase("train/upload"):
        bins_d = put_bins(bins[r0:r1] if sharded else bins, n_bins, dev)
        y_d, tw_d, vw_d = (torch.from_numpy(a[r0:r1].astype(np.float32))
                           .to(dev) for a in (y64, wt, wv))
        cat_np = np.zeros(c, bool) if cat_mask is None \
            else np.asarray(cat_mask, bool)
        cat = torch.from_numpy(cat_np).to(dev)
        has_cat = bool(cat_np.any())

    trees: List[TreeArrays] = list(init_trees or [])
    if trees and init_scores is not None and len(init_scores) == n:
        # checkpointed per-row scores restore f byte-exact
        f = torch.from_numpy(np.asarray(init_scores[r0:r1],
                                        np.float32)).to(dev)
    else:
        f = torch.full((r1 - r0,), init_score, dtype=torch.float32,
                       device=dev)
        if trees:
            with phase("train/replay"):
                f = _replay(trees, bins_d, f, settings.learning_rate)

    stopper = GBTEarlyStopDecider()
    history: List[Tuple[float, float]] = list(start_history or [])
    stopped = False
    for _, va_prev in history:
        # a restored forest that already hit its stop must not grow
        if stopper.add(va_prev) and settings.early_stop:
            stopped = True
    fi = np.zeros(c)
    total = n_tree_nodes(settings.depth)
    imp = "friedmanmse" if settings.impurity == "friedmanmse" \
        else "variance"
    ckpt = settings.checkpoint_every if (checkpoint_fn and
                                         settings.checkpoint_every) else 0

    ti = len(trees)
    while ti < settings.n_trees and not stopped:
        chunk = settings.n_trees - ti
        if ckpt:
            chunk = min(chunk, ((ti // ckpt) + 1) * ckpt - ti)
        if progress:
            chunk = min(chunk, 8)
        if settings.early_stop:
            chunk = min(chunk, settings.early_stop_check)
        with phase("train/grow"):
            fa_all = torch.from_numpy(np.stack(
                [_feat_subset(settings, c, t)
                 for t in range(ti, ti + chunk)])).to(dev)
            f, packed = gbt_forest_chunk(bins_d, y_d, tw_d, vw_d, f, fa_all,
                                         cat, settings, n_bins, imp, has_cat,
                                         mesh)
            packed = _fetch(packed)                      # the chunk's copy
        for j, row in enumerate(packed):
            tree, gfi, tr_err, va_err = _unpack_tree(
                row, total, n_bins, c, settings.depth)
            trees.append(tree)
            fi += gfi
            history.append((tr_err, va_err))
            if progress:
                progress(ti + j, tr_err, va_err)
            if settings.early_stop and stopper.add(va_err):
                # drop the chunk tail past the trigger: exactly the forest
                # a per-tree decision loop would have kept
                log.info("GBT early stop after %d trees", ti + j + 1)
                stopped = True
                break
        ti += chunk
        if ckpt:
            # every chunk is a commit point; the scores ride along unless
            # the stop dropped trees whose updates f already holds
            with phase("train/checkpoint"):
                checkpoint_fn(trees, history, init_score,
                              None if stopped else
                              meshlib.gather_rows(mesh, f, n).cpu().numpy())
    return ForestResult(
        trees=trees,
        spec_kwargs={"algorithm": "GBT", "loss": settings.loss,
                     "learning_rate": settings.learning_rate,
                     "init_score": init_score},
        train_error=history[-1][0] if history else float("nan"),
        valid_error=history[-1][1] if history else float("nan"),
        feature_importance=fi, trees_built=len(trees), history=history)


# ------------------------------------------------- bagged / grid members
def _check_member_structure(settings_list: List[DTSettings]) -> DTSettings:
    s0 = settings_list[0]
    for s in settings_list[1:]:
        same = (s.n_trees == s0.n_trees and s.depth == s0.depth
                and s.impurity == s0.impurity and s.loss == s0.loss
                and s.feature_subset == s0.feature_subset
                and s.max_leaves == s0.max_leaves
                and s.n_classes == s0.n_classes
                and s.poisson_bagging == s0.poisson_bagging)
        if not same:
            raise ValueError("bagged tree members must share structural "
                             "params (TreeNum/MaxDepth/Impurity/Loss/...)")
    return s0


def train_gbt_bagged(bins, y, tw_m, vw_m, n_bins: int, cat_mask,
                     settings_list: List[DTSettings],
                     device: Optional[torch.device] = None,
                     phase: Optional[Callable[[str], ContextManager]] = None,
                     ) -> List[ForestResult]:
    """B independent GBT forests boosted side by side (the reference's
    ``train_gbt_bagged``, one vmapped executable; its reference
    ``TrainModelProcessor.java:768-945`` runs one Guagua job per member).
    Members share structure (TreeNum/MaxDepth/...) and vary in row
    weights ``tw_m``/``vw_m`` [B, N], seeds (feature subsets) and the
    scalars LearningRate / MinInstancesPerNode / MinInfoGain.

    One score row per member stays on the device; each round grows the B
    members' trees through ONE ``grow_forest`` call (one B2 launch a level
    with TB = B), and every member runs :func:`train_gbt`'s per-tree ops
    in its order, so member b equals a ``train_gbt`` run on its weights
    bit for bit.  The forests cross to the host in one copy at the end;
    early stop and checkpoints are per-run features of :func:`train_gbt`
    (callers run such members one by one)."""
    s0 = _check_member_structure(settings_list)
    dev = torch.device(device if device is not None else "cuda")
    phase = phase or (lambda name: contextlib.nullcontext())
    n, c = bins.shape
    tw_m = np.asarray(tw_m, np.float32)
    vw_m = np.asarray(vw_m, np.float32)
    y64 = np.asarray(y, np.float64)

    init_scores = []            # on the host in f64, as the reference's
    for b, s in enumerate(settings_list):
        prior = float((y64 * tw_m[b]).sum() / max(tw_m[b].sum(), 1e-9))
        if s.loss == "log":
            prior = float(np.clip(prior, 1e-6, 1 - 1e-6))
            init_scores.append(float(np.log(prior / (1 - prior))))
        else:
            init_scores.append(prior)

    with phase("train/upload"):
        bins_d = put_bins(bins, n_bins, dev)
        y_d = torch.from_numpy(y64.astype(np.float32)).to(dev)
        tw_d = torch.from_numpy(tw_m).to(dev)
        vw_d = torch.from_numpy(vw_m).to(dev)
        cat_np = np.zeros(c, bool) if cat_mask is None \
            else np.asarray(cat_mask, bool)
        cat = torch.from_numpy(cat_np).to(dev)
        has_cat = bool(cat_np.any())
        # [T, B, C]: every round's subsets cross before growth starts
        fa_all = torch.from_numpy(np.stack(
            [np.stack([_feat_subset(s, c, t) for s in settings_list])
             for t in range(s0.n_trees)])).to(dev)
    f = [torch.full((n,), v, dtype=torch.float32, device=dev)
         for v in init_scores]
    imp = "friedmanmse" if s0.impurity == "friedmanmse" else "variance"
    rows: List[List[torch.Tensor]] = [[] for _ in settings_list]
    with phase("train/grow"):
        for t in range(s0.n_trees):
            stats_b = torch.stack([_gbt_stats(y_d, tw_d[b], f[b], s0.loss)
                                   for b in range(len(settings_list))])
            grown = grow_forest(
                bins_d, stats_b, cat, fa_all[t], n_bins, s0.depth, imp,
                [s.min_instances for s in settings_list],
                [s.min_gain for s in settings_list], s0.max_leaves, has_cat)
            for b, (sf, lm, lv, gfi, leaf_glob) in enumerate(grown):
                f[b], tr, va = _gbt_update(y_d, tw_d[b], vw_d[b], f[b], lv,
                                           leaf_glob, settings_list[b])
                rows[b].append(_pack_tree(sf, lm, lv, gfi, tr, va))
        packed = _fetch(torch.stack([torch.stack(r) for r in rows]))
    results = []
    for s, init_score, member in zip(settings_list, init_scores, packed):
        trees, fi, history = [], np.zeros(c), []
        for row in member:
            tree, gfi, tr_err, va_err = _unpack_tree(
                row, n_tree_nodes(s.depth), n_bins, c, s.depth)
            trees.append(tree)
            fi += gfi
            history.append((tr_err, va_err))
        results.append(ForestResult(
            trees=trees,
            spec_kwargs={"algorithm": "GBT", "loss": s.loss,
                         "learning_rate": s.learning_rate,
                         "init_score": init_score},
            train_error=history[-1][0], valid_error=history[-1][1],
            feature_importance=fi, trees_built=len(trees),
            history=history))
    return results


# ------------------------------------------------------------ Random Forest
#: RF trees grown together by one batched grow (``grow_forest``): each
#: level's histograms for the whole batch in one B2 launch.  8 is the
#: reference's default and its progress burst.
RF_TREE_BATCH = 8


def _effective_tree_batch(settings: DTSettings) -> int:
    """The RF tree-batch width: the ``SHIFU_TREE_BATCH`` environment
    variable, else the ``TreeBatch`` train param, else
    :data:`RF_TREE_BATCH`."""
    env = os.environ.get("SHIFU_TREE_BATCH")
    if env:
        return max(1, int(env))
    return settings.tree_batch if settings.tree_batch > 0 \
        else RF_TREE_BATCH


def draw_bags(settings: DTSettings, tree_ids, n: int,
              device, rows=None) -> torch.Tensor:
    """[T, n] f32 row weights of the RF trees ``tree_ids``: the Poisson
    draw of ``fold_in(PRNGKey(seed), tree)`` at ``baggingSampleRate``
    (reference ``jax.random.poisson``), or ones for a DT.  The only host
    syncs of a chunk happen here, before its growth.  ``rows`` = (r0, r1)
    gives a mesh rank's block [r0, r1) of the draw over all ``n`` rows,
    the same bits (``prng.poisson``'s counters)."""
    r0, r1 = (0, n) if rows is None else rows
    if not settings.poisson_bagging:
        return torch.ones((len(tree_ids), r1 - r0), dtype=torch.float32,
                          device=device)
    base = prng.prng_key(settings.seed)
    return prng.poisson([prng.fold_in(base, t) for t in tree_ids],
                        settings.bagging_rate, n, device, rows)


def _rf_stats_from_bag(y, w, bag, n_classes: int = 0):
    """Per-row stat channels of one bag [N] or a batch of bags [TB, N] —
    the one place the layout lives: [..., N, 2] ``[w * bag, w * bag *
    y]``, or [..., N, K] per-class weights ``w * bag * onehot(y)`` when
    ``n_classes > 2``."""
    bw = w * bag
    if n_classes > 2:
        return bw[..., None] * torch.nn.functional.one_hot(
            y.long(), n_classes).float()
    return torch.stack([bw, bw * y], dim=-1).float()


def _rf_oob_update(pred, y, w, bag, oob_sum, oob_cnt, loss: str,
                   n_classes: int = 0, sums: bool = False):
    """Out-of-bag vote accumulation and loss-consistent errors for ONE
    grown tree (reference ``_rf_oob_update``): the tree's rows outside its
    bag vote; validation scores every row with a vote on the mean of its
    votes, training scores the tree on every row — misclassification
    rates (first-maximum argmax) for ``n_classes > 2``.  Returns
    (oob_sum, oob_cnt, train_err, valid_err); with ``sums`` (binary, a
    mesh rank's rows) the errors' float64 [loss, weight, loss, weight]
    sums in :func:`_error_sums`' order in place of the two errors."""
    oob = (bag == 0) & (w > 0)
    if n_classes > 2:
        yi = y.long()
        oob_sum = oob_sum + torch.where(oob[:, None], pred, 0.0)
        oob_cnt = oob_cnt + oob.to(oob_cnt.dtype)
        seen = oob_cnt > 0
        per_v = (oob_sum.argmax(dim=-1) != yi).float()
        per_t = (pred.argmax(dim=-1) != yi).float()
        wv = w * seen
        va = (per_v * wv).sum() / wv.sum().clamp_min(1e-9)
        tr = (per_t * w).sum() / w.sum().clamp_min(1e-9)
        return oob_sum, oob_cnt, tr, va
    oob_sum = oob_sum + torch.where(oob, pred, 0.0)
    oob_cnt = oob_cnt + oob.to(oob_cnt.dtype)
    seen = oob_cnt > 0
    oob_pred = oob_sum / oob_cnt.clamp_min(1.0)
    # RF votes average probabilities; log loss needs them clipped, not logit
    if loss == "log":
        p = oob_pred.clamp(1e-9, 1 - 1e-9)
        per_v = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    else:
        per_v = _per_row_loss(y, oob_pred, loss)
    wv = w * seen
    va = (per_v * wv).sum() / wv.sum().clamp_min(1e-9)
    if loss == "log":
        per_t = -(y * torch.log(pred.clamp(1e-9, 1 - 1e-9))
                  + (1 - y) * torch.log((1 - pred).clamp(1e-9, 1 - 1e-9)))
    else:
        per_t = _per_row_loss(y, pred, loss)
    if sums:
        w64, wv64 = w.double(), wv.double()
        return oob_sum, oob_cnt, torch.stack([
            (per_t.double() * w64).sum(), w64.sum(),
            (per_v.double() * wv64).sum(), wv64.sum()]), None
    tr = (per_t * w).sum() / w.sum().clamp_min(1e-9)
    return oob_sum, oob_cnt, tr, va


def rf_forest_chunk(bins, y, w, bags, oob_sum, oob_cnt, fa_all, cat,
                    settings: DTSettings, n_bins: int, has_cat: bool,
                    tree_batch: int, mesh=None):
    """A chunk of RF trees on the device with no host sync: ``bags`` [T,
    N] and ``fa_all`` [T, C] per tree.  Whole batches of ``tree_batch``
    trees grow through :func:`grow_forest` (one B2 launch a level), the
    remainder one by one through :func:`grow_tree` (B1); out-of-bag votes
    chain through every tree in tree order, so the result is the same
    bits whatever the batch.  Returns (oob_sum, oob_cnt, packed [T, L]
    uint8).  On a ``mesh`` whose data axis splits the rows, as
    :func:`gbt_forest_chunk`: the tensors and the votes are the rank's
    rows, the trees and errors every rank's."""
    t_total = fa_all.shape[0]
    tb = max(1, tree_batch)
    main = (t_total // tb) * tb if tb > 1 else 0
    k = settings.n_classes
    kw = dict(n_bins=n_bins, depth=settings.depth,
              impurity=settings.impurity,
              min_instances=settings.min_instances,
              min_gain=settings.min_gain, max_leaves=settings.max_leaves,
              has_cat=has_cat, n_classes=k, mesh=mesh)

    def grown():
        for g0 in range(0, main, tb):
            yield from grow_forest(
                bins, _rf_stats_from_bag(y, w, bags[g0:g0 + tb], k), cat,
                fa_all[g0:g0 + tb], **kw)
        for j in range(main, t_total):
            yield grow_tree(bins, _rf_stats_from_bag(y, w, bags[j], k), cat,
                            fa_all[j], **kw)

    rows, sums = [], []
    sharded = meshlib.data_sharded(mesh)
    for j, (sf, lm, lv, gfi, leaf_glob) in enumerate(grown()):
        oob_sum, oob_cnt, tr, va = _rf_oob_update(
            lv[leaf_glob.long()], y, w, bags[j], oob_sum, oob_cnt,
            settings.loss, k, sums=sharded)
        if sharded:
            sums.append(tr)
            tr = va = torch.zeros((), device=w.device)
        rows.append(_pack_tree(sf, lm, lv, gfi, tr, va))
    packed = torch.stack(rows)
    return oob_sum, oob_cnt, _with_mesh_errors(
        packed, torch.stack(sums), mesh) if sums else packed


def _rf_replay(trees: List[TreeArrays], bins_d, w_d, settings: DTSettings,
               oob_sum, oob_cnt, n: Optional[int] = None, rows=None):
    """Resume: rebuild the out-of-bag state by walking the restored trees
    through B4 with their re-drawn bags, RF_TREE_BATCH trees at a time, in
    tree order (the reference walks them with ``predict_tree``; routing
    is integer and the leaf one select — or one gather of a class
    distribution — so the votes are the same bits).  ``n`` and ``rows``:
    a mesh rank's block of the global rows, as :func:`draw_bags` takes."""
    for g0 in range(0, len(trees), RF_TREE_BATCH):
        group = trees[g0:g0 + RF_TREE_BATCH]
        bags = draw_bags(settings, range(g0, g0 + len(group)),
                         bins_d.shape[0] if n is None else n, bins_d.device,
                         rows)
        for j, pred in enumerate(forest_predictions(group, bins_d)):
            oob = (bags[j] == 0) & (w_d > 0)
            oob_sum = oob_sum + torch.where(
                oob[:, None] if pred.dim() == 2 else oob, pred, 0.0)
            oob_cnt = oob_cnt + oob.to(oob_cnt.dtype)
    return oob_sum, oob_cnt


def train_rf(bins, y, w, n_bins: int, cat_mask, settings: DTSettings,
             progress=None, checkpoint_fn: Optional[Callable] = None,
             init_trees: Optional[List[TreeArrays]] = None,
             start_history: Optional[List] = None,
             device: Optional[torch.device] = None,
             phase: Optional[Callable[[str], ContextManager]] = None,
             mesh=None) -> ForestResult:
    """Independent Poisson-bagged trees (``poisson_bagging`` off: one
    plain DT) over the resident plane ``bins`` [N, C] (or a plane already
    on the device, :func:`put_bins`) on ``device``; out-of-bag rows score
    validation with the configured loss (misclassification for a native
    multi-class forest, ``settings.n_classes > 2``, whose ``y`` holds
    class ids).  The chunk rules and ``phase`` parts are
    :func:`train_gbt`'s; ``train/replay`` rebuilds a resumed forest's
    out-of-bag votes.  A ``mesh`` as in :func:`train_gbt`: each rank keeps
    its block of the rows and takes its block of every tree's bag from the
    draw over all the rows (:func:`draw_bags`), so the forest is the
    one-rank forest, bit for bit."""
    dev = torch.device(device if device is not None else "cuda")
    phase = phase or (lambda name: contextlib.nullcontext())
    n, c = bins.shape
    sharded = meshlib.data_sharded(mesh)
    if sharded and settings.n_classes > 2:
        raise _not_ported("native multi-class RF on a mesh",
                          _MESH_TREES_ITEM)
    rows = mesh.row_block(n) if sharded else None
    r0, r1 = rows or (0, n)
    with phase("train/upload"):
        bins_d = put_bins(bins[r0:r1] if sharded else bins, n_bins, dev)
        y_d, w_d = (torch.from_numpy(np.asarray(a, np.float32)[r0:r1])
                    .to(dev) for a in (y, w))
        cat_np = np.zeros(c, bool) if cat_mask is None \
            else np.asarray(cat_mask, bool)
        cat = torch.from_numpy(cat_np).to(dev)
        has_cat = bool(cat_np.any())
    mc = settings.n_classes > 2
    oob_sum = torch.zeros((r1 - r0, settings.n_classes) if mc
                          else (r1 - r0,), dtype=torch.float32, device=dev)
    oob_cnt = torch.zeros(r1 - r0, dtype=torch.float32, device=dev)
    trees: List[TreeArrays] = list(init_trees or [])
    history: List[Tuple[float, float]] = list(start_history or [])
    if trees:
        with phase("train/replay"):
            oob_sum, oob_cnt = _rf_replay(trees, bins_d, w_d, settings,
                                          oob_sum, oob_cnt, n, rows)
    fi = np.zeros(c)
    total = n_tree_nodes(settings.depth)
    tree_batch = _effective_tree_batch(settings)
    ckpt = settings.checkpoint_every if (checkpoint_fn and
                                         settings.checkpoint_every) else 0

    ti = len(trees)
    while ti < settings.n_trees:
        chunk = settings.n_trees - ti
        if ckpt:
            chunk = min(chunk, ((ti // ckpt) + 1) * ckpt - ti)
        if progress:
            chunk = min(chunk, 8)
        with phase("train/grow"):
            ids = range(ti, ti + chunk)
            fa_all = torch.from_numpy(np.stack(
                [_feat_subset(settings, c, t) for t in ids])).to(dev)
            bags = draw_bags(settings, ids, n, dev, rows)
            oob_sum, oob_cnt, packed = rf_forest_chunk(
                bins_d, y_d, w_d, bags, oob_sum, oob_cnt, fa_all, cat,
                settings, n_bins, has_cat, tree_batch, mesh)
            packed = _fetch(packed)                      # the chunk's copy
        for j, row in enumerate(packed):
            tree, gfi, tr_err, va_err = _unpack_tree(
                row, total, n_bins, c, settings.depth, settings.n_classes)
            trees.append(tree)
            fi += gfi
            history.append((tr_err, va_err))
            if progress:
                progress(ti + j, tr_err, va_err)
        ti += chunk
        if ckpt:
            with phase("train/checkpoint"):
                checkpoint_fn(trees, history, None)
    spec_kwargs: Dict[str, Any] = {"algorithm": "RF"}
    if mc:
        spec_kwargs["extra"] = {"n_classes": settings.n_classes}
    return ForestResult(
        trees=trees, spec_kwargs=spec_kwargs,
        train_error=history[-1][0] if history else float("nan"),
        valid_error=history[-1][1] if history else float("nan"),
        feature_importance=fi, trees_built=len(trees), history=history)


def train_rf_bagged(bins, y, w_m, n_bins: int, cat_mask,
                    settings_list: List[DTSettings],
                    device: Optional[torch.device] = None,
                    phase: Optional[Callable[[str], ContextManager]] = None,
                    ) -> List[ForestResult]:
    """B independent RF/DT forests (the reference's ``train_rf_bagged``):
    ``w_m`` [B, N] per-member row weights (the bagging sample), validation
    per member out of bag.  The plane goes to the device once; the
    members then train one after the other through :func:`train_rf`, each
    in its own ``TreeBatch`` batches, so a level's histograms hold what a
    single forest's hold (not B times that) and member b equals a
    ``train_rf`` run on ``w_m[b]`` bit for bit."""
    _check_member_structure(settings_list)
    dev = torch.device(device if device is not None else "cuda")
    phase = phase or (lambda name: contextlib.nullcontext())
    with phase("train/upload"):
        bins_d = put_bins(bins, n_bins, dev)
    return [train_rf(bins_d, y, np.asarray(w_m[b], np.float32), n_bins,
                     cat_mask, s, device=dev, phase=phase)
            for b, s in enumerate(settings_list)]


# ------------------------------------------------------------- streaming
# The out-of-core trainers (reference ``train_gbt_streamed`` /
# ``train_rf_streamed``): the plane streams in windows through a
# ``data.streaming.ResidentCache``; windows under the device budget stay
# on the card, the tail past it re-streams from the mmap'd plane.  The
# reference's jitted window steps are eager functions here, on the device
# of their tensors, chained through their accumulator inputs in window
# order.
def _stream_sync(ev, tensors) -> Callable[[], None]:
    """The consumer half of a window's copy: its stream waits for the
    copy stream's event ``ev``, and every tensor the copy made is marked
    used on the consumer's stream, so the caching allocator cannot hand a
    tail window's memory to the next copy while a kernel still reads
    it."""
    def sync() -> None:
        cur = torch.cuda.current_stream()
        cur.wait_event(ev)
        for t in tensors:
            t.record_stream(cur)
    return sync


class _WindowCopier:
    """Host arrays of a prepared window to the device.  On the card the
    copies run on a copy stream of their own (the prep thread's), and the
    window carries the sync its consumer runs when it takes the window
    (``PreparedWindow.on_consume``)."""

    def __init__(self, device: torch.device):
        self.dev = device
        self._stream = None

    def __call__(self, rows: Dict[str, np.ndarray], bins=None,
                 n_bins: int = 0,
                 extra: Optional[Dict[str, np.ndarray]] = None):
        """(device arrays, on_consume): ``rows`` (same-length f32 rows)
        cross in ONE copy and come back as views; ``bins`` as
        :func:`put_bins` puts it; ``extra`` arrays one copy each."""
        cuda = self.dev.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.dev)
        ctx = torch.cuda.stream(self._stream) if cuda \
            else contextlib.nullcontext()
        keys = list(rows)
        with ctx:
            stacked = torch.from_numpy(np.stack(
                [np.asarray(rows[k], np.float32) for k in keys])).to(self.dev)
            out = dict(zip(keys, stacked.unbind(0)))
            made = [stacked]
            if bins is not None:
                out["bins"] = put_bins(bins, n_bins, self.dev)
                made.append(out["bins"])
            for k, a in (extra or {}).items():
                out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                made.append(out[k])
            if not cuda:
                return out, None
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, _stream_sync(ev, made)


def _gbt_window_hist(hist, bins_w, y_w, tw_w, f_w, sf, lm, n_nodes: int,
                     n_bins: int, level: int, loss: str, left: bool = False,
                     mesh=None):
    """Streamed level step: the window's rows find their level-local node
    by walking the partial tree, then add their gradient stats to the
    running ``hist`` (B1 on the card; on a ``mesh`` the sharded B1 over
    every rank's block of the window).  ``left`` accumulates the LEFT
    children only (parent-slot indexed; :func:`_derive_level` derives the
    right ones once the level's windows are summed)."""
    node_idx = node_index_at_level(sf, lm, bins_w, level)
    if left:
        node_idx = _left_child_index(node_idx)
    return hist + build_histograms(bins_w, node_idx,
                                   _gbt_stats(y_w, tw_w, f_w, loss),
                                   n_nodes, n_bins, mesh)


def _derive_level(full_prev, hl, feat_prev):
    """A level's full histogram from its parent level and the accumulated
    left children: ``ops.tree._subtract`` across windows."""
    return _subtract([hl], [full_prev], [feat_prev])[0]


def _gbt_window_leaf_raw(acc, bins_w, y_w, tw_w, f_w, sf, lm, depth: int,
                         loss: str, mesh=None):
    """The bottom level's raw leaf sums for one window (B1 on the card,
    sharded on a ``mesh``)."""
    node_idx = node_index_at_level(sf, lm, bins_w, depth)
    return acc + tree_ops._level_leaf_raw(
        _gbt_stats(y_w, tw_w, f_w, loss), node_idx, 1 << depth, mesh)


def _set_bottom_leaves(lv, raw, depth: int, n_classes: int = 0):
    lv = lv.clone()
    lv[(1 << depth) - 1:] = leaf_values_from_raw(raw, n_classes)
    return lv


def _blank_tree(total: int, n_bins: int, dev, n_classes: int = 0):
    """(split_feat -1, left_mask False, leaf_value 0) of an ungrown
    tree."""
    return (torch.full((total,), -1, dtype=torch.int32, device=dev),
            torch.zeros((total, n_bins), dtype=torch.bool, device=dev),
            torch.zeros((total, n_classes) if n_classes > 2 else total,
                        dtype=torch.float32, device=dev))


def _error_sums(per, tw, vw, dtype=None):
    """[loss, weight, loss, weight] sums of the train and valid weights;
    ``dtype`` float64 for a mesh rank's rows (summed over the data group
    later)."""
    if dtype is not None:
        per, tw, vw = per.to(dtype), tw.to(dtype), vw.to(dtype)
    return torch.stack([(per * tw).sum(), tw.sum(), (per * vw).sum(),
                        vw.sum()])


# ------------------------------------------- coarse-to-fine disk tail
def _gbt_tail_head(bins, y, tw, vw, f, sf_p, lm_p, lv_p, fa, cat, lr, mi,
                   mg, tail_extra, valid_upto: int, n_bins: int, depth: int,
                   impurity: str, loss: str, max_leaves: int = 0,
                   has_cat: bool = True, has_prev: bool = True,
                   cand_k: int = 0, mesh=None):
    """The coarse-to-fine tree's RESIDENT head: the previous tree's score
    update on the coalesced resident block (and its error sums), then the
    COARSE tree grown on the resident rows alone, recording its per-level
    left histograms and bottom leaf sums — the resident part of the exact
    totals along the speculated structure.  ``cand_k > 0`` also picks the
    top-K candidate columns (coarse gains, coarse split columns forced in,
    sorted) and narrows the recorded histograms to them.  ``tail_extra``
    is the previous pass's exact tail evidence (:func:`_tail_extras`),
    valid through level ``valid_upto``.  On a ``mesh`` the block is this
    rank's part of every rank's resident rows and the error sums are
    float64."""
    dt = torch.float64 if meshlib.data_sharded(mesh) else None
    if has_prev:
        f = f + lr * predict_tree(sf_p, lm_p, lv_p, bins, depth)
        sums = _error_sums(_per_row_loss(y, f, loss), tw, vw, dt)
    else:
        sums = torch.zeros(4, dtype=dt or torch.float32, device=bins.device)
    sf_c, lm_c, _, gfi_c, _, hist_left, leaf_raw = grow_tree(
        bins, _gbt_stats(y, tw, f, loss), cat, fa, n_bins, depth, impurity,
        mi, mg, max_leaves, has_cat, record_hists=True,
        tail_extra=tail_extra, prev_sf=sf_p, prev_lm=lm_p,
        valid_upto=valid_upto, mesh=mesh)
    if cand_k > 0:
        forced = torch.zeros_like(gfi_c).index_add_(
            0, sf_c.clamp_min(0).long(),
            torch.where(sf_c >= 0, 1e30, 0.0).float())
        # top-K, ties to the lower column (jax.lax.top_k's order)
        cand_idx = torch.argsort(-(gfi_c + forced), stable=True)[:cand_k]
        cand_idx = torch.sort(cand_idx).values
        hist_left = hist_left.index_select(2, cand_idx)
    else:
        cand_idx = torch.zeros(0, dtype=torch.int64, device=bins.device)
    return sf_c, lm_c, hist_left, leaf_raw, f, sums, cand_idx


def _tail_extras(hl_acc, hl_res, cand_idx, c: int, cand: bool = False):
    """The pass's exact TAIL-only evidence ([depth, half, C, B, S], full
    width): the accumulated totals minus the resident head's part,
    scattered back from the candidate set when the scan was bounded."""
    tail = hl_acc - hl_res
    if cand:
        full = tail.new_zeros(hl_acc.shape[:2] + (c,) + hl_acc.shape[3:])
        full[:, :, cand_idx] = tail
        return full
    return tail


def _gbt_tail_window_pass(hist_left, leaf_raw, sums, bins_w, y_w, tw_w,
                          vw_w, f_w, sf_p, lm_p, lv_p, sf_c, lm_c,
                          cand_idx, lr, n_bins: int, depth: int, loss: str,
                          has_prev: bool = True, cand: bool = False,
                          mesh=None):
    """ONE disk pass feeds everything, a tail window at a time: the
    previous tree's score update and error sums, then every level's
    histograms of the current tree along the speculated structure and the
    bottom leaf sums (:func:`build_path_histograms`, one B2 launch at TB
    = depth; sharded over every rank's block of the window on a
    ``mesh``)."""
    if has_prev:
        f_w = f_w + lr * predict_tree(sf_p, lm_p, lv_p, bins_w, depth)
        sums = sums + _error_sums(_per_row_loss(y_w, f_w, loss), tw_w, vw_w,
                                  sums.dtype)
    hist_bins = bins_w.index_select(1, cand_idx) if cand else None
    hl, lraw = build_path_histograms(bins_w, _gbt_stats(y_w, tw_w, f_w, loss),
                                     sf_c, lm_c, depth, n_bins,
                                     hist_bins=hist_bins, mesh=mesh)
    return hist_left + hl, leaf_raw + lraw, sums, f_w


def _tree_level_step(hist, cat, fa, impurity: str, min_instances,
                     min_gain, has_cat: bool, level: int, depth: int,
                     max_leaves: int, sf, lm, lv, nodes_cnt, fi_add,
                     n_classes: int = 0):
    """One level of streamed growth from a summed level histogram, written
    into the tree arrays in place — the one implementation behind the
    exact schedule, the repair and the RF super-batch."""
    n_nodes = 1 << level
    gain, feat, lmask, leaf, _ = best_splits(
        hist, cat, fa, impurity, min_instances, min_gain, has_cat, n_classes)
    if level == depth:
        feat = torch.full_like(feat, -1)
        lmask = torch.zeros_like(lmask)
    elif max_leaves > 0:
        feat, lmask, nodes_cnt = cap_splits_by_leaves(
            gain, feat, lmask, nodes_cnt, max_leaves)
    base = n_nodes - 1
    sf[base:base + n_nodes] = feat
    lm[base:base + n_nodes] = lmask
    lv[base:base + n_nodes] = leaf
    return sf, lm, lv, nodes_cnt, fi_add + level_gain_fi(gain, feat,
                                                     hist.shape[1])


def _gbt_tail_select(hist_left, leaf_raw, sf_c, lm_c, cand_idx, cat, fa,
                     mi, mg, n_bins: int, depth: int, impurity: str,
                     max_leaves: int = 0, has_cat: bool = True,
                     cand: bool = False):
    """Exact split selection from the summed (resident + tail) per-level
    histograms, verifying the speculation: the level steps top-down with
    right children by subtraction, each level's choice compared with the
    coarse structure, and the FIRST level where they differ reported
    (``depth`` = all confirmed; deeper histograms are mis-routed past it
    and the caller repairs those levels with exact sweeps).

    Returns (sf, lm, lv, fi_levels [depth] list of [C], cnt_levels [depth]
    list, mismatch (device int32), full_levels [depth] list of each
    level's exact full histogram: the repair's subtraction parent)."""
    c_full = fa.shape[0]
    cat_h = cat.index_select(0, cand_idx) if cand else cat
    fa_h = fa.index_select(0, cand_idx) if cand else fa
    dev = hist_left.device
    total = n_tree_nodes(depth)
    sf = torch.full((total,), -1, dtype=torch.int32, device=dev)
    lm = torch.zeros((total, n_bins), dtype=torch.bool, device=dev)
    lv = torch.zeros(total, dtype=torch.float32, device=dev)
    nodes_cnt = torch.ones((), dtype=torch.int32, device=dev)
    fi_levels, cnt_levels, full_hists = [], [], []
    mismatch = torch.full((), depth, dtype=torch.int32, device=dev)
    full_prev = feat_prev = None
    for level in range(depth):
        n_nodes = 1 << level
        if level == 0:
            hist = hist_left[0, :1]
        else:
            hist = _derive_level(full_prev, hist_left[level, :n_nodes // 2],
                                 feat_prev)
        full_hists.append(hist)
        gain, feat_l, lmask, leaf, _ = best_splits(
            hist, cat_h, fa_h, impurity, mi, mg, has_cat)
        feat = torch.where(feat_l >= 0,
                           cand_idx[feat_l.clamp_min(0).long()].int()
                           if cand else feat_l, -1).to(torch.int32)
        if max_leaves > 0:
            feat, lmask, nodes_cnt = cap_splits_by_leaves(
                gain, feat, lmask, nodes_cnt, max_leaves)
        base = n_nodes - 1
        sf[base:base + n_nodes] = feat
        lm[base:base + n_nodes] = lmask
        lv[base:base + n_nodes] = leaf
        fi_levels.append(level_gain_fi(gain, feat, c_full))
        cnt_levels.append(nodes_cnt)
        diff = (feat != sf_c[base:base + n_nodes]).any() | \
            (lmask != lm_c[base:base + n_nodes]).any()
        mismatch = torch.where((mismatch == depth) & diff,
                               torch.full_like(mismatch, level), mismatch)
        full_prev, feat_prev = hist, feat
    lv = _set_bottom_leaves(lv, leaf_raw, depth)
    return sf, lm, lv, fi_levels, cnt_levels, mismatch, full_hists


def _raw_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack_streamed(sf, lm, lv, fi, sums=None) -> torch.Tensor:
    """A streamed tree as one device byte row: split_feat int32, left mask
    a byte per bin, leaf values and gains f32, then the f32 ``sums`` (the
    error sums, or none)."""
    parts = [_raw_bytes(sf.to(torch.int32)), lm.reshape(-1).to(torch.uint8),
             _raw_bytes(lv.float()), _raw_bytes(fi.float())]
    if sums is not None:
        parts.append(_raw_bytes(sums.float()))
    return torch.cat(parts)


def _unpack_streamed(row: np.ndarray, total: int, n_bins: int, c: int,
                     depth: int, n_classes: int = 0):
    """Host-side inverse of :func:`_pack_streamed`: (tree, gains f32 [C],
    sums f32)."""
    k = n_classes if n_classes > 2 else 1
    sizes = [4 * total, total * n_bins, 4 * total * k, 4 * c]
    sf, lm, lv, fi, sums = np.split(row, np.cumsum(sizes))
    lv = lv.view(np.float32).copy()
    tree = TreeArrays(split_feat=sf.view(np.int32).copy(),
                      left_mask=lm.reshape(total, n_bins) > 0,
                      leaf_value=lv.reshape(total, k) if k > 1 else lv,
                      depth=depth)
    return tree, fi.view(np.float32).copy(), sums.view(np.float32).copy()


def _errors_of(sums) -> Tuple[float, float]:
    """(first, second) error from host f32 sums [loss, weight, loss,
    weight], each divided in float64."""
    return (float(sums[0]) / max(float(sums[1]), 1e-9),
            float(sums[2]) / max(float(sums[3]), 1e-9))


def _pack_small(sums, mismatch) -> torch.Tensor:
    """The coarse-to-fine tree's one small fetch: [tr_sum, tw, va_sum, vw,
    mismatch] f32."""
    return torch.cat([sums.float(), mismatch.float()[None]])


def _rf_tail_bags(idx, keys, th, n: int, poisson: bool):
    """[TB, n] Poisson bags of a tree batch hashed on the device from the
    window's global row indices (bit-identical to the host stream), so a
    window carries one [n] index row instead of a [TB, n] bag plane.  Rows
    past ``n_valid`` need no masking: the RF prep zeroes their ``w``."""
    if not poisson:
        return torch.ones((len(keys), n), dtype=torch.float32,
                          device=idx.device)
    return torch.stack([hash_poisson_traced(idx, k, th) for k in keys])


def _rf_window_hist_batch(hist_b, bins_w, y_w, w_w, idx, keys, th, sf_b,
                          lm_b, n_nodes: int, n_bins: int, level: int,
                          n_classes: int = 0, left: bool = False,
                          poisson: bool = True, mesh=None):
    """A tree batch's level histograms over ONE window in ONE kernel B2
    launch (the bins shared by the batch; sharded over every rank's block
    of the window on a ``mesh``), added in place into ``hist_b`` (the
    window order fixes the f32 sums).  Bags hash on the device; ``left``
    accumulates left children only."""
    bags_b = _rf_tail_bags(idx, keys, th, w_w.shape[0], poisson)
    node_b = [node_index_at_level(sf_b[t], lm_b[t], bins_w, level)
              for t in range(sf_b.shape[0])]
    if left:
        node_b = [_left_child_index(ni) for ni in node_b]
    return hist_b.add_(build_histograms_batch(
        bins_w, torch.stack(node_b),
        _rf_stats_from_bag(y_w, w_w, bags_b, n_classes).contiguous(),
        n_nodes, n_bins, mesh))


def _rf_window_leaf_batch(raw_b, bins_w, y_w, w_w, idx, keys, th, sf_b,
                          lm_b, depth: int, n_classes: int = 0,
                          poisson: bool = True, mesh=None):
    """A tree batch's bottom-level raw leaf sums over one window (a
    sharded B1 a tree on a ``mesh``)."""
    stats_b = _rf_stats_from_bag(
        y_w, w_w, _rf_tail_bags(idx, keys, th, w_w.shape[0], poisson),
        n_classes)
    return raw_b + torch.stack([
        tree_ops._level_leaf_raw(stats_b[t], node_index_at_level(
            sf_b[t], lm_b[t], bins_w, depth), 1 << depth, mesh)
        for t in range(sf_b.shape[0])])


def _gbt_window_update(sums_in, bins_w, y_w, tw_w, vw_w, f_w, sf, lm, lv,
                       lr, depth: int, loss: str):
    """A window's score update by one tree, and its error sums (in the
    dtype of ``sums_in``)."""
    f2 = f_w + lr * predict_tree(sf, lm, lv, bins_w, depth)
    return f2, sums_in + _error_sums(_per_row_loss(y_w, f2, loss), tw_w,
                                     vw_w, sums_in.dtype)


def _rf_window_update(sums_in, y_w, w_w, bag_w, oob_sum_w, oob_cnt_w, pred,
                      loss: str, n_classes: int = 0):
    """A window's out-of-bag votes from one tree's ``pred`` and its error
    sums [valid loss, valid weight, train loss, train weight]."""
    oob_sum2, oob_cnt2, tr, va = _rf_oob_update(
        pred, y_w, w_w, bag_w, oob_sum_w, oob_cnt_w, loss, n_classes)
    del tr, va
    seen = oob_cnt2 > 0
    if n_classes > 2:
        yi = y_w.long()
        per_v = (oob_sum2.argmax(dim=-1) != yi).float()
        per_t = (pred.argmax(dim=-1) != yi).float()
    else:
        oob_pred = oob_sum2 / oob_cnt2.clamp_min(1.0)
        if loss == "log":
            p = oob_pred.clamp(1e-9, 1 - 1e-9)
            per_v = -(y_w * torch.log(p) + (1 - y_w) * torch.log(1 - p))
            pt = pred.clamp(1e-9, 1 - 1e-9)
            per_t = -(y_w * torch.log(pt) + (1 - y_w) * torch.log(1 - pt))
        else:
            per_v = _per_row_loss(y_w, oob_pred, loss)
            per_t = _per_row_loss(y_w, pred, loss)
    wv, w_s = w_w * seen, w_w
    if sums_in.dtype != per_v.dtype:        # a mesh rank's float64 sums
        per_v, per_t, wv, w_s = (t.to(sums_in.dtype)
                                 for t in (per_v, per_t, wv, w_w))
    return oob_sum2, oob_cnt2, sums_in + torch.stack(
        [(per_v * wv).sum(), wv.sum(), (per_t * w_s).sum(), w_s.sum()])


def _rf_window_update_batch(sums_b, bins_w, y_w, w_w, idx, keys, th,
                            oob_sum_w, oob_cnt_w, sf_b, lm_b, lv_b,
                            depth: int, loss: str, n_classes: int = 0,
                            poisson: bool = True):
    """A tree batch's out-of-bag votes and error sums over one window, the
    votes chained through the batch in tree order (as per-tree sweeps
    would chain them)."""
    bags_b = _rf_tail_bags(idx, keys, th, w_w.shape[0], poisson)
    rows = []
    for t in range(sf_b.shape[0]):
        oob_sum_w, oob_cnt_w, s = _rf_window_update(
            sums_b[t], y_w, w_w, bags_b[t], oob_sum_w, oob_cnt_w,
            predict_tree(sf_b[t], lm_b[t], lv_b[t], bins_w, depth), loss,
            n_classes)
        rows.append(s)
    return oob_sum_w, oob_cnt_w, torch.stack(rows)


def _default_cache_budget() -> int:
    from ..config import environment
    return environment.get_int("shifu.train.deviceCacheBytes", 1 << 30)


# floor on trees grown a disk-tail sweep in streamed RF; the super-batch
# itself is budget-derived (:func:`_tail_super_batch`)
RF_TAIL_TREE_BATCH = 8

# cap on the tail super-batch: past ~128 trees the [SB, K, C, B, S] state
# stops paying for the disk passes it saves
RF_TAIL_SUPER_BATCH_MAX = 128


def _tail_super_batch(settings: DTSettings, c: int, n_bins: int,
                      n_stats: int) -> int:
    """Trees fed by ONE disk pass over the tail in streamed RF (SB): the
    ``TailTreeBatch`` param or ``SHIFU_TAIL_TREE_BATCH`` env, else as many
    trees as ``shifu.tree.tailSuperBatchBytes`` (256 MiB) affords against
    the deepest level's state (~2 x [SB, 2^(depth-1), C, B, S] f32), at
    least :data:`RF_TAIL_TREE_BATCH`."""
    env = os.environ.get("SHIFU_TAIL_TREE_BATCH")
    if env:
        return max(1, int(env))
    if settings.tail_tree_batch > 0:
        return settings.tail_tree_batch
    from ..config import environment
    budget = environment.get_int("shifu.tree.tailSuperBatchBytes", 1 << 28)
    width = 1 << max(settings.depth - 1, 0)
    per_tree = 2 * width * c * n_bins * n_stats * 4
    return int(min(RF_TAIL_SUPER_BATCH_MAX,
                   max(RF_TAIL_TREE_BATCH, budget // max(per_tree, 1))))


def _tail_coarse_to_fine(device: torch.device) -> bool:
    """The disk-tail coarse-to-fine schedule: ``SHIFU_TREE_TAIL_C2F`` env,
    else ``-Dshifu.tree.tailCoarseToFine``; by default on for a ``cuda``
    device and off for ``cpu`` (the reference decides by backend: a pass
    over the mmap'd plane is nearly free on a CPU while the repairs are
    not).  Both schedules give bit-identical forests."""
    env = os.environ.get("SHIFU_TREE_TAIL_C2F")
    if env is not None:
        return env.lower() not in ("0", "off", "false")
    from ..config import environment
    return environment.get_bool("shifu.tree.tailCoarseToFine",
                                device.type == "cuda")


def _tail_candidate_k(c: int) -> int:
    """``-Dshifu.tree.tailCandidateK``: the coarse-to-fine tail scans only
    the top-K columns of the coarse tree (its split columns always in);
    0 (default) or K >= C = every column, the exact contract."""
    from ..config import environment
    k = environment.get_int("shifu.tree.tailCandidateK", 0)
    return 0 if k <= 0 or k >= c else k


def _c2f_feasible(settings: DTSettings, c: int, n_bins: int) -> bool:
    """Coarse-to-fine holds every level's left histograms three times
    (the head's record, the running sums, the stale evidence): within
    ``shifu.tree.tailHistBudgetBytes`` (256 MiB), else the exact
    schedule."""
    if settings.depth < 1 or settings.n_classes > 2:
        return False
    from ..config import environment
    budget = environment.get_int("shifu.tree.tailHistBudgetBytes", 1 << 28)
    k = _tail_candidate_k(c) or c
    width = 1 << max(settings.depth - 1, 0)
    return 3 * settings.depth * width * k * n_bins * 2 * 4 <= budget


def _stream_masks(idx: np.ndarray, n_valid: int, w_w: np.ndarray,
                  valid_rate: float, seed: int):
    """Hash train/valid weights of a window (a stateless row split)."""
    from ..data.streaming import row_uniform
    vmask = row_uniform(seed, 11, idx) < valid_rate
    live = np.zeros(len(idx), np.float32)
    live[:n_valid] = 1.0
    w = np.asarray(w_w, np.float32) * live
    return (w * ~vmask).astype(np.float32), (w * vmask).astype(np.float32)


def _window_f(f: np.ndarray, win, mesh=None) -> np.ndarray:
    """A window's slice of a per-row host cache (scores, or per-class
    votes), zero past the plane's end; on a ``mesh`` this rank's block of
    it."""
    b0, b1 = _block(mesh, win.rows)
    s = win.start + b0
    e = min(win.start + b1, len(f))
    out = np.zeros((b1 - b0,) + f.shape[1:], np.float32)
    out[:max(0, e - s)] = f[s:e]
    return out


def _block(mesh, rows: int) -> Tuple[int, int]:
    """This rank's rows [b0, b1) of a window of ``rows`` rows: all of them
    outside a mesh (the one place that splits a window)."""
    return mesh.row_block(rows) if meshlib.data_sharded(mesh) \
        else (0, rows)


def _own_rows(win, mesh) -> Tuple[int, int]:
    """(global first row, count) of this rank's REAL rows of a window."""
    b0, b1 = _block(mesh, win.rows)
    return win.start + b0, max(0, min(b1, win.n_valid) - b0)


def _prepared_block(win, arrays: Dict[str, np.ndarray], bins, copier,
                    n_bins: int, mesh, extra=None, sums=None):
    """A window's host rows cut to this rank's block and copied to the
    device as one :class:`PreparedWindow`; on a mesh its ``cache_bytes``
    is the whole window's (the one-rank residency budget)."""
    from ..data.streaming import PreparedWindow
    b0, b1 = _block(mesh, win.rows)
    sharded = meshlib.data_sharded(mesh)
    if sharded:
        arrays = {k: a[b0:b1] for k, a in arrays.items()}
        bins = bins[b0:b1]
    dev, sync = copier(arrays, bins, n_bins, extra)
    item = PreparedWindow(win.start, win.n_valid, win.rows,
                          win.index[b0:b1] if sharded else win.index, dev,
                          on_consume=sync, sums=sums)
    if sharded:
        per_row = sum(a.nbytes for k, a in dev.items() if k != "f_prep") \
            / max(b1 - b0, 1)
        item.cache_bytes = int(round(per_row * win.rows))
    return item


def _gbt_prepare(copier: _WindowCopier, valid_rate: float, seed: int,
                 n_bins: int, y_transform=None, mask_fn=None, f_ref=None,
                 mesh=None):
    """The streamed GBT's window hook (prep thread): hash train/valid
    masks, copy y/tw/vw in one copy and the bins in the wire dtype.
    ``y_transform`` maps the raw targets (one-vs-all); ``mask_fn(index,
    targets) -> (train_w, valid_w)`` replaces the plain split (members).
    ``f_ref`` points at the host score cache: once set, a window's score
    slice ships as ``f_prep`` from the prep thread, off the consumer's
    path (a slice is written only after its window was consumed).  The
    window's [sum(tw * y), sum(tw)] ride along in float64 (the prior's
    sums: the same on every rank of a mesh, which copies its block
    only)."""

    def prep(win):
        y_raw = np.asarray(win.arrays["y"], np.float32)
        if mask_fn is None:
            tw, vw = _stream_masks(win.index, win.n_valid, win.arrays["w"],
                                   valid_rate, seed)
        else:
            live = np.zeros(win.rows, np.float32)
            live[:win.n_valid] = 1.0
            w = np.asarray(win.arrays["w"], np.float32) * live
            t, v = mask_fn(win.index, y_raw)
            tw, vw = (w * t).astype(np.float32), (w * v).astype(np.float32)
        y = y_raw if y_transform is None \
            else np.asarray(y_transform(y_raw), np.float32)
        fh = f_ref.get("f") if f_ref is not None else None
        sums = np.array([np.sum(tw * y, dtype=np.float64),
                         np.sum(tw, dtype=np.float64)])
        return _prepared_block(win, {"y": y, "tw": tw, "vw": vw},
                               win.arrays["bins"], copier, n_bins, mesh,
                               None if fh is None
                               else {"f_prep": _window_f(fh, win, mesh)},
                               sums)
    return prep


def _rf_prepare(copier: _WindowCopier, n_bins: int, y_transform=None,
                mask_fn=None, mesh=None):
    """The streamed RF's window hook: zero weights past ``n_valid``, a
    member's stateless row sample multiplied in (``mask_fn``), y and w in
    one copy, the bins in the wire dtype (this rank's block on a
    ``mesh``)."""

    def prep(win):
        w = np.asarray(win.arrays["w"], np.float32).copy()
        w[win.n_valid:] = 0.0
        y = np.asarray(win.arrays["y"], np.float32)
        if mask_fn is not None:
            w *= mask_fn(win.index, y)[0].astype(np.float32)
        if y_transform is not None:
            y = np.asarray(y_transform(y), np.float32)
        return _prepared_block(win, {"y": y, "w": w}, win.arrays["bins"],
                               copier, n_bins, mesh)
    return prep


def _own_rows_of_plane(n_rows: int, window_rows: int, mesh):
    """[(global first row, count)] of this rank's real rows of every
    window of a plane cut into full windows of ``window_rows``."""
    out = []
    for start in range(0, n_rows, window_rows):
        b0, b1 = _block(mesh, window_rows)
        nv = min(window_rows, n_rows - start)
        out.append((start + b0, max(0, min(b1, nv) - b0)))
    return out


def _gather_scores(mesh, f: np.ndarray, own, resident,
                   device) -> np.ndarray:
    """Every row's score for a checkpoint: this rank's rows of the host
    cache ``f`` (``own`` [(first, count)] of them), overwritten by the
    device blocks of ``resident`` [(first, count, tensor)], and on a mesh
    the other ranks' rows through one all_reduce of the bits on
    ``device`` (each row is one rank's; the others add zero words)."""
    sharded = meshlib.data_sharded(mesh)
    out = np.zeros(len(f), np.float32) if sharded else f.copy()
    for g0, cnt in own if sharded else ():
        out[g0:g0 + cnt] = f[g0:g0 + cnt]
    for g0, cnt, t in resident:
        out[g0:g0 + cnt] = t[:cnt].cpu().numpy()
    if sharded:
        bits = torch.from_numpy(out.view(np.int32)).to(device)
        out = meshlib.all_reduce(mesh, bits).cpu().numpy().view(np.float32)
    return out


def _init_score_from_sums(sums, loss: str) -> float:
    """The GBT prior from host float64 [sum(w*y), sum(w)] sums, by the
    resident :func:`train_gbt`'s formula."""
    prior = float(sums[0] / max(sums[1], 1e-9))
    if loss == "log":
        prior = float(np.clip(prior, 1e-6, 1 - 1e-6))
        return float(np.log(prior / (1 - prior)))
    return prior


def _progress_flusher(drain, history, progress, idx_off: int):
    """(flush, mark) for batched streamed progress: lines go out in bursts
    after a drain; ``idx_off`` maps history positions to tree indices;
    ``mark`` advances the cursor past lines a caller wrote itself."""
    state = {"emitted": len(history)}

    def flush() -> None:
        drain()
        if progress:
            for j in range(state["emitted"], len(history)):
                progress(j + idx_off, history[j][0], history[j][1])
        state["emitted"] = len(history)

    def mark() -> None:
        state["emitted"] = len(history)
    return flush, mark


def _concat_rows(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def train_gbt_streamed(stream, n_bins: int, cat_mask, settings: DTSettings,
                       progress=None,
                       init_trees: Optional[List[TreeArrays]] = None,
                       init_score: Optional[float] = None,
                       checkpoint_fn: Optional[Callable] = None,
                       start_history: Optional[List] = None,
                       cache_budget: Optional[int] = None,
                       y_transform=None, mask_fn=None,
                       init_scores: Optional[np.ndarray] = None,
                       device: Optional[torch.device] = None,
                       mesh=None) -> ForestResult:
    """Out-of-core GBT over a ``ResidentCache`` (reference
    ``train_gbt_streamed``; ``MemoryDiskFloatMLDataSet.java:54-99``): the
    windows that fit ``cache_budget`` (``deviceCacheBytes``, 1 GiB) stay on
    ``device``, the tail past it re-streams from the mmap'd plane.  The
    per-row score cache ``f`` lives on the device for resident rows and on
    the host for the tail.  Three regimes:

    - fully resident: the windows coalesce into one device block and every
      tree runs the resident :func:`gbt_round`, one disk pass in all;
    - a disk tail with coarse-to-fine (``_tail_coarse_to_fine``): each
      tree speculates its structure on the resident block (stale tail
      evidence steering the split choice), verifies every level in ONE
      tail pass that also carries the previous tree's score update, and
      repairs the levels below a divergence with exact sweeps; six trees
      in a row repaired near the root surrender to the exact schedule;
    - the exact schedule: a tail sweep a level (left children, right ones
      by subtraction), one for the leaf sums and one for the update.

    Coarse-to-fine and exact give bit-identical forests on one window
    partition; a tail run matches the fully-resident one in structure,
    its leaves f32-equivalent (the histograms sum in other groups).

    On a ``mesh`` whose data axis splits the rows (every rank streams the
    same windows, ``window_rows`` a multiple of the data axis), each rank
    keeps its block of every window's rows: B1 and B2 run in their
    sharded forms (the kernel's raw mode, one exact all_reduce, the
    flush), so every histogram and leaf sum is one rank's bit for bit; the
    scores are the rank's rows, the error sums every rank's in float64;
    the residency budget counts whole windows.  The forest, ``disk_passes``,
    ``tail_sweeps`` and ``bytes_read`` are one rank's."""
    from ..data.streaming import PreparedWindow, ResidentCache
    dev = torch.device(device if device is not None else "cuda")
    sharded = meshlib.data_sharded(mesh)
    sum_dt = torch.float64 if sharded else torch.float32
    n_rows = stream.num_rows
    total = n_tree_nodes(settings.depth)
    trees: List[TreeArrays] = list(init_trees or [])
    history: List[Tuple[float, float]] = list(start_history or [])
    stopper = GBTEarlyStopDecider()
    replay_stopped = False
    for _, va_prev in history:
        # a restored forest that already stopped must not grow
        if stopper.add(va_prev) and settings.early_stop:
            replay_stopped = True

    f_ref: Dict[str, Any] = {"f": None}   # prep-thread view of host scores
    bytes0 = stream.bytes_read
    cache = ResidentCache(
        stream, _default_cache_budget() if cache_budget is None
        else cache_budget,
        _gbt_prepare(_WindowCopier(dev), settings.valid_rate, settings.seed,
                     n_bins, y_transform, mask_fn, f_ref, mesh))

    # warm pass: the width, and the prior from every window's float64
    # host sums (the same on every rank)
    c = None
    prior = np.zeros(2)
    for it in cache.items():
        if c is None:
            c = int(it.arrays["bins"].shape[1])
        prior += it.sums
    if c is None:
        raise RuntimeError("streamed GBT: empty shard stream")
    init_d = None
    if init_score is None:
        init_score = _init_score_from_sums(prior, settings.loss)
        if cache.tail is None and not trees:
            init_d = torch.tensor(init_score, dtype=torch.float32,
                                  device=dev)

    def init_host() -> float:
        return init_score

    cat_np = np.zeros(c, bool) if cat_mask is None \
        else np.asarray(cat_mask, bool)
    cat = torch.from_numpy(cat_np).to(dev)
    hc = bool(cat_np.any())
    fi_parts: List[np.ndarray] = []       # per-tree split gains [C]

    f = None if init_d is not None else np.full(n_rows, init_score,
                                                np.float32)
    f_ref["f"] = f
    if trees and init_scores is not None and len(init_scores) == n_rows:
        # checkpointed scores restore f byte-exact
        f = np.asarray(init_scores, np.float32).copy()
        f_ref["f"] = f
    elif trees:
        # continuous / resume without scores: the restored forest walks
        # every window (this rank's block) through B4 (one launch per
        # window), then the adds in tree order, as the resident replay
        for it in cache.items():
            preds = forest_predictions(trees, it.arrays["bins"]).cpu() \
                .numpy()
            g0, cnt = _own_rows(it, mesh)
            for p in preds:
                f[g0:g0 + cnt] += settings.learning_rate * p[:cnt]

    def window_f(it):
        """Resident windows keep their score slice on the device across
        trees; tail windows take the slice the prep thread shipped."""
        if it.resident:
            it.arrays.pop("f_prep", None)
            fw = it.arrays.get("f")
            if fw is None:
                fw = (torch.from_numpy(_window_f(f, it, mesh)).to(dev)
                      if f is not None
                      else init_d.expand(it.arrays["y"].shape[0]).clone())
                it.arrays["f"] = fw
            return fw
        fp = it.arrays.pop("f_prep", None)
        return fp if fp is not None else \
            torch.from_numpy(_window_f(f, it, mesh)).to(dev)

    def write_back(wb) -> None:
        """Tail windows' updated score blocks into the host cache."""
        for it, f2 in wb:
            g0, cnt = _own_rows(it, mesh)
            f[g0:g0 + cnt] = f2[:cnt].cpu().numpy()

    def all_sums(sums):
        """Error sums of every rank's rows (float64 on a mesh)."""
        return meshlib.all_reduce(mesh, sums) if sharded else sums

    imp = "friedmanmse" if settings.impurity == "friedmanmse" else "variance"
    pending_fused: List[torch.Tensor] = []

    def absorb_fused(rows_h) -> None:
        for row in rows_h:
            tree, fi_h, sums = _unpack_streamed(row, total, n_bins, c,
                                                settings.depth)
            fi_parts.append(fi_h.astype(np.float64))
            trees.append(tree)
            history.append(_errors_of(sums))

    def drain_fused() -> None:
        if pending_fused:
            absorb_fused(torch.stack(pending_fused).cpu().numpy())
            pending_fused.clear()

    flush_progress, mark_progress = _progress_flusher(
        drain_fused, history, progress, len(trees) - len(history))
    es_checked = len(history)       # the stopper has seen these
    h0 = len(history)               # fi_parts align with history[h0:]

    repairs, surrender = 0, -1     # the disk tail's coarse-to-fine record

    def result() -> ForestResult:
        return _streamed_result(ForestResult(
            trees=trees,
            spec_kwargs={"algorithm": "GBT", "loss": settings.loss,
                         "learning_rate": settings.learning_rate,
                         "init_score": init_host()},
            train_error=history[-1][0] if history else float("nan"),
            valid_error=history[-1][1] if history else float("nan"),
            feature_importance=(np.sum(fi_parts, axis=0) if fi_parts
                                else np.zeros(c)),
            trees_built=len(trees), history=history,
            disk_passes=cache.disk_passes, tail_sweeps=cache.tail_sweeps,
            bytes_read=stream.bytes_read - bytes0,
            tail_repairs=repairs, tail_surrender=surrender), cache, stream)

    # fully resident: coalesce the windows into ONE device block and run
    # the resident round a tree (the window buffers go with the block)
    mega = None
    mega_parts = []                 # (first row, count, offset in mega)
    if cache.tail is None:
        items = list(cache.items())
        mega = {k: _concat_rows([it.arrays[k] for it in items])
                for k in ("bins", "y", "tw", "vw")}
        mega["f"] = _concat_rows([window_f(it) for it in items])
        off = 0
        for it in items:
            mega_parts.append(_own_rows(it, mesh) + (off,))
            off += len(it.index)
            it.arrays.clear()

    if mega is None and not replay_stopped and len(trees) < settings.n_trees:
        depth = settings.depth
        lr = settings.learning_rate

        res_rows = cache.resident_rows
        rmega = None
        mega_it = None
        res_parts = []              # (first row, count, offset in rmega)
        if cache.cached:
            items_r = list(cache.cached)
            rmega = {k: _concat_rows([it.arrays[k] for it in items_r])
                     for k in ("bins", "y", "tw", "vw")}
            rmega["f"] = _concat_rows([window_f(it) for it in items_r])
            off = 0
            for it in items_r:      # the window buffers live on in the block
                res_parts.append(_own_rows(it, mesh) + (off,))
                off += len(it.index)
                it.arrays.clear()
            mega_it = PreparedWindow(0, res_rows, res_rows,
                                     np.arange(res_rows), rmega,
                                     resident=True)

        def sweep_items():
            if mega_it is not None:
                yield mega_it
            yield from cache.tail_items()

        def exact_levels(fa, sf, lm, lv, nodes_cnt, fi_add, start_level: int,
                         full_prev, capture=None):
            """Exact per-level sweeps of levels [start_level, depth) and the
            leaf-sum bottom: the exact schedule AND the coarse-to-fine repair
            (one implementation).  ``capture`` receives each left-built
            level's tail-only left histogram (the total minus the resident
            block's part), routed along the FINAL structure: the repair
            refreshes the next tree's stale evidence with them."""
            for level in range(start_level, depth):
                n_nodes = 1 << level
                left = level > 0 and full_prev is not None
                width = n_nodes // 2 if left else n_nodes
                hist = torch.zeros((width, c, n_bins, 2), dtype=torch.float32,
                                   device=dev)
                hist_res = None
                for it in sweep_items():
                    hist = _gbt_window_hist(
                        hist, it.arrays["bins"], it.arrays["y"],
                        it.arrays["tw"], window_f(it), sf, lm, width,
                        n_bins, level, settings.loss, left, mesh)
                    if it.resident:
                        hist_res = hist
                if left:
                    if capture is not None:
                        capture[level] = hist - hist_res \
                            if hist_res is not None else hist
                    hist = _derive_level(full_prev, hist,
                                         sf[width - 1:2 * width - 1])
                sf, lm, lv, nodes_cnt, fi_add = _tree_level_step(
                    hist, cat, fa, imp, settings.min_instances,
                    settings.min_gain, hc, level, depth, settings.max_leaves,
                    sf, lm, lv, nodes_cnt, fi_add)
                full_prev = hist
            raw = torch.zeros((2, 1 << depth), dtype=torch.float32, device=dev)
            for it in sweep_items():
                raw = _gbt_window_leaf_raw(
                    raw, it.arrays["bins"], it.arrays["y"], it.arrays["tw"],
                    window_f(it), sf, lm, depth, settings.loss, mesh)
            return sf, lm, _set_bottom_leaves(lv, raw, depth), fi_add

        def update_sweep(sf, lm, lv, want_scores: bool):
            """The previous tree's score update and error sums over every
            window; tail slices write back after the sweep."""
            sums_dev = torch.zeros(4, dtype=sum_dt, device=dev)
            wb = []
            for it in sweep_items():
                f2, sums_dev = _gbt_window_update(
                    sums_dev, it.arrays["bins"], it.arrays["y"],
                    it.arrays["tw"], it.arrays["vw"], window_f(it), sf, lm,
                    lv, lr, depth, settings.loss)
                if it.resident:
                    it.arrays["f"] = f2
                else:
                    wb.append((it, f2))
            write_back(wb)
            return all_sums(sums_dev), (tail_scores() if want_scores
                                        else None)

        def tail_scores() -> np.ndarray:
            """Every row's score for a checkpoint: the resident block's from
            the device, the tail's from the host cache (every rank's rows,
            on a mesh)."""
            return _gather_scores(
                mesh, f, _own_rows_of_plane(n_rows, stream.window_rows,
                                            mesh),
                [(g0, cnt, rmega["f"][o:]) for g0, cnt, o in res_parts],
                dev)

        use_c2f = (rmega is not None and _tail_coarse_to_fine(dev)
                   and _c2f_feasible(settings, c, n_bins))
        cand_k = _tail_candidate_k(c) if use_c2f else 0
        prev = None                  # the last built tree, on the device
        pend: List[torch.Tensor] = []
        drains = 0                   # super-batch drains (the fault site's)

        def drain_pend() -> None:
            nonlocal drains
            if not pend:
                return
            for row in torch.stack(pend).cpu().numpy():
                tree, fi_h, _ = _unpack_streamed(row, total, n_bins, c, depth)
                trees.append(tree)
                fi_parts.append(fi_h.astype(np.float64))
            pend.clear()
            drains += 1
            faults.fire("train", "superbatch", drains)

        built = len(trees)
        stopped = False
        f_behind = False             # the last built tree's update pending?
        fell_back = False            # speculation gave up: exact schedule
        if use_c2f:
            tail_extra = None        # the previous pass's exact tail evidence
            valid_upto = 0
            lowmis_run = 0           # consecutive near-root repairs
            while built < settings.n_trees:
                ti = built
                fa = torch.from_numpy(_feat_subset(settings, c, ti)).to(dev)
                has_prev = prev is not None
                p_sf, p_lm, p_lv = prev if has_prev else \
                    _blank_tree(total, n_bins, dev)
                (sf_c, lm_c, hl_res, raw_acc, rmega["f"], sums_d,
                 cand_idx) = _gbt_tail_head(
                    rmega["bins"], rmega["y"], rmega["tw"], rmega["vw"],
                    rmega["f"], p_sf, p_lm, p_lv, fa, cat, lr,
                    settings.min_instances, settings.min_gain,
                    tail_extra if has_prev else None, valid_upto, n_bins,
                    depth, imp, settings.loss, settings.max_leaves, hc,
                    has_prev, cand_k, mesh)
                hl_acc = hl_res
                wb = []
                for it in cache.tail_items():
                    hl_acc, raw_acc, sums_d, f2 = _gbt_tail_window_pass(
                        hl_acc, raw_acc, sums_d, it.arrays["bins"],
                        it.arrays["y"], it.arrays["tw"], it.arrays["vw"],
                        window_f(it), p_sf, p_lm, p_lv, sf_c, lm_c, cand_idx,
                        lr, n_bins, depth, settings.loss, has_prev, cand_k > 0,
                        mesh)
                    wb.append((it, f2))
                sf_t, lm_t, lv_t, fi_lv, cnt_lv, mism_d, full_lv = \
                    _gbt_tail_select(hl_acc, raw_acc, sf_c, lm_c, cand_idx,
                                     cat, fa, settings.min_instances,
                                     settings.min_gain, n_bins, depth, imp,
                                     settings.max_leaves, hc, cand_k > 0)
                tail_extra = _tail_extras(hl_acc, hl_res, cand_idx, c,
                                          cand_k > 0)
                write_back(wb)
                small = _pack_small(all_sums(sums_d), mism_d).cpu().numpy()
                if has_prev:
                    tr_e, va_e = _errors_of(small)
                    history.append((tr_e, va_e))
                    f_behind = False
                    if progress:
                        progress(ti - 1, tr_e, va_e)
                    if settings.early_stop and stopper.add(va_e):
                        # the decision lands one pass late: the in-flight tree
                        # ti is the tree a per-tree loop never grows
                        log.info("GBT early stop after %d trees (streamed "
                                 "tail)", ti)
                        drain_pend()
                        if checkpoint_fn and settings.checkpoint_every:
                            checkpoint_fn(trees, history, init_host())
                        stopped = True
                        break
                mis = int(small[4])
                valid_upto = depth
                fi_tree = torch.zeros(c, dtype=torch.float32, device=dev)
                if mis < depth:
                    repairs += 1
                    obs.counter("train.tail_repairs").inc()
                    obs.counter("train.tail_repair_levels").inc(depth - mis)
                    # diverged at `mis`: its own choice is exact (routed by
                    # confirmed levels), the deeper histograms are not.  The
                    # repair's subtraction chain starts from the select's
                    # exact level-`mis` histogram, which keeps it bit-equal
                    # to the exact schedule; its tail-only left sums refresh
                    # the evidence below the divergence
                    for lv_fi in fi_lv[:mis + 1]:
                        fi_tree = fi_tree + lv_fi
                    cap: Optional[Dict[int, torch.Tensor]] = \
                        {} if cand_k == 0 else None
                    sf_t, lm_t, lv_t, fi_tree = exact_levels(
                        fa, sf_t, lm_t, lv_t, cnt_lv[mis], fi_tree, mis + 1,
                        full_lv[mis] if cand_k == 0 else None, capture=cap)
                    if cap:
                        for lvl, h in cap.items():
                            tail_extra[lvl, :h.shape[0]] = h
                    elif cand_k > 0:
                        valid_upto = mis  # deeper evidence routed by a miss
                else:
                    for lv_fi in fi_lv:
                        fi_tree = fi_tree + lv_fi
                # adaptive surrender: a run of near-root repairs means this
                # plane is speculation-hostile; the exact schedule finishes
                # the forest (same bits, fewer wasted passes)
                lowmis_run = lowmis_run + 1 if (has_prev and mis <= 1) else 0
                prev = (sf_t, lm_t, lv_t)
                pend.append(_pack_streamed(sf_t, lm_t, lv_t, fi_tree))
                built += 1
                f_behind = True
                if len(pend) >= 8:
                    drain_pend()
                if checkpoint_fn and settings.checkpoint_every and built > 1 \
                        and (built - 1) % settings.checkpoint_every == 0:
                    # commit the prefix whose scores are final (the fresh
                    # tree's update rides the NEXT tree's tail pass)
                    drain_pend()
                    checkpoint_fn(trees[:built - 1], history[:built - 1],
                                  init_host(), tail_scores())
                if lowmis_run >= 6 and built < settings.n_trees:
                    log.info("GBT tail: speculation repaired near the root %d "
                             "trees running — falling back to the exact "
                             "per-level schedule at tree %d", lowmis_run,
                             built)
                    fell_back = True
                    surrender = built
                    break
            if not stopped and f_behind and prev is not None:
                # trailing pass: the last tree's update and error sums
                tr_e, va_e = _errors_of(update_sweep(
                    *prev, want_scores=False)[0].cpu().numpy())
                history.append((tr_e, va_e))
                if progress:
                    progress(built - 1, tr_e, va_e)
            drain_pend()
        if not use_c2f or fell_back:
            while built < settings.n_trees and not stopped:
                ti = built
                fa = torch.from_numpy(_feat_subset(settings, c, ti)).to(dev)
                sf, lm, lv, fi_add = exact_levels(
                    fa, *_blank_tree(total, n_bins, dev),
                    torch.ones((), dtype=torch.int32, device=dev),
                    torch.zeros(c, dtype=torch.float32, device=dev), 0, None)
                ckpt_due = bool(checkpoint_fn and settings.checkpoint_every and
                                (ti + 1) % settings.checkpoint_every == 0)
                sums_dev, scores = update_sweep(sf, lm, lv, ckpt_due)
                absorb_fused([_pack_streamed(sf, lm, lv, fi_add, sums_dev)
                              .cpu().numpy()])
                tr_err, va_err = history[-1]
                built += 1
                if progress:
                    progress(ti, tr_err, va_err)
                mark_progress()
                if ckpt_due:
                    checkpoint_fn(trees, history, init_host(), scores)
                if settings.early_stop and stopper.add(va_err):
                    log.info("GBT early stop after %d trees (streamed)",
                             ti + 1)
                    if checkpoint_fn and settings.checkpoint_every:
                        checkpoint_fn(trees, history, init_host())
                    stopped = True
        return result()

    start_ti = settings.n_trees if replay_stopped \
        else len(trees) + len(pending_fused)
    for ti in range(start_ti, settings.n_trees):
        fa = torch.from_numpy(_feat_subset(settings, c, ti)).to(dev)
        sf, lm, lv, gfi, mega["f"], tr, va = gbt_round(
            mega["bins"], mega["y"], mega["tw"], mega["vw"], mega["f"], fa,
            cat, settings, n_bins, imp, hc, mesh)
        one = torch.ones_like(tr)
        pending_fused.append(_pack_streamed(sf, lm, lv, gfi,
                                            torch.stack([tr, one, va, one])))
        # early stop reads the fetched errors every early_stop_check
        # trees; a trigger inside truncates to the exact tree a per-tree
        # decision would have kept
        if settings.early_stop and \
                (len(pending_fused) >= settings.early_stop_check
                 or ti + 1 == settings.n_trees):
            drain_fused()
            triggered = None
            for j, (_, va_err) in enumerate(history[es_checked:]):
                if stopper.add(va_err):
                    triggered = es_checked + j
                    break
            if triggered is not None:
                kept = triggered + 1
                del trees[kept + len(trees) - len(history):]
                del fi_parts[kept - h0:]
                del history[kept:]
                log.info("GBT early stop after %d trees (streamed)",
                         len(trees))
                if checkpoint_fn and settings.checkpoint_every:
                    checkpoint_fn(trees, history, init_host())
                break
            es_checked = len(history)
            flush_progress()
        elif progress and len(pending_fused) >= 8:
            flush_progress()
        if checkpoint_fn and settings.checkpoint_every and \
                (ti + 1) % min(settings.checkpoint_every, 8) == 0:
            flush_progress()
            checkpoint_fn(trees, history, init_host(), _gather_scores(
                mesh, np.zeros(n_rows, np.float32), [],
                [(g0, cnt, mega["f"][o:]) for g0, cnt, o in mega_parts],
                dev))
    flush_progress()
    return result()




def _rf_round_streamed(bins, y, w, idx, key, th, oob_sum, oob_cnt, fa, cat,
                       settings: DTSettings, n_bins: int, has_cat: bool,
                       mesh=None):
    """The streamed RF's resident round: the tree's hash bag replayed on
    the device (``ops.hashing``, bit-identical to the host stream), then
    the resident RF round; returns (packed row, oob_sum, oob_cnt).  On a
    ``mesh`` the rows are this rank's and the errors every rank's."""
    bag = hash_poisson_traced(idx, key, th) if settings.poisson_bagging \
        else torch.ones_like(w)
    k = settings.n_classes
    sharded = meshlib.data_sharded(mesh)
    sf, lm, lv, gfi, leaf_glob = grow_tree(
        bins, _rf_stats_from_bag(y, w, bag, k), cat, fa, n_bins,
        settings.depth, settings.impurity, settings.min_instances,
        settings.min_gain, settings.max_leaves, has_cat, k, mesh=mesh)
    oob_sum, oob_cnt, tr, va = _rf_oob_update(
        lv[leaf_glob.long()], y, w, bag, oob_sum, oob_cnt, settings.loss, k,
        sums=sharded)
    if sharded:
        e = meshlib.all_reduce(mesh, tr)
        tr = (e[0] / e[1].clamp_min(1e-9)).float()
        va = (e[2] / e[3].clamp_min(1e-9)).float()
    one = torch.ones_like(tr)
    return _pack_streamed(sf, lm, lv, gfi, torch.stack([va, one, tr, one])), \
        oob_sum, oob_cnt


def train_rf_streamed(stream, n_bins: int, cat_mask, settings: DTSettings,
                      progress=None,
                      checkpoint_fn: Optional[Callable] = None,
                      init_trees: Optional[List[TreeArrays]] = None,
                      start_history: Optional[List] = None,
                      cache_budget: Optional[int] = None,
                      y_transform=None, mask_fn=None,
                      device: Optional[torch.device] = None,
                      mesh=None) -> ForestResult:
    """Out-of-core RF over a ``ResidentCache`` (reference
    ``train_rf_streamed``): hash Poisson bags per (tree, row) keep bagging
    stateless across sweeps, out-of-bag vote caches (on the device for
    resident rows, on the host for the tail) carry validation across
    trees.  Until the cache has classified its windows, and whenever a
    tail exists, trees grow in SUPER-BATCHES of SB
    (:func:`_tail_super_batch`): a sweep a level feeds every tree of the
    batch through one B2 launch a window (left children past the root,
    right ones by subtraction), one sweep sums the bottom leaves and one
    more adds the out-of-bag votes, the trees chained in order.  A plane
    that fits the budget coalesces after its first batch and grows the
    rest a tree at a time (the resident round, bags hashed on the
    device).  Every order gives the same forest bits.

    On a ``mesh`` as in :func:`train_gbt_streamed`: each rank keeps its
    block of every window (bags hashed from its rows' global indices, the
    super-batch's B2 and the leaf sums sharded, the out-of-bag votes its
    rows', their error sums every rank's); binary forests only."""
    from ..data.streaming import ResidentCache
    dev = torch.device(device if device is not None else "cuda")
    sharded = meshlib.data_sharded(mesh)
    if sharded and settings.n_classes > 2:
        raise _not_ported("native multi-class RF on a mesh",
                          _MESH_TREES_ITEM)
    sum_dt = torch.float64 if sharded else torch.float32
    n_rows = stream.num_rows
    total = n_tree_nodes(settings.depth)
    trees: List[TreeArrays] = list(init_trees or [])
    history: List[Tuple[float, float]] = list(start_history or [])

    bytes0 = stream.bytes_read
    cache = ResidentCache(
        stream, _default_cache_budget() if cache_budget is None
        else cache_budget,
        _rf_prepare(_WindowCopier(dev), n_bins, y_transform, mask_fn, mesh))
    c = None
    for win in stream.windows():      # peek the first window for the width
        c = int(win.arrays["bins"].shape[1])
        break
    if c is None:
        raise RuntimeError("streamed RF: empty shard stream")
    cat_np = np.zeros(c, bool) if cat_mask is None \
        else np.asarray(cat_mask, bool)
    cat = torch.from_numpy(cat_np).to(dev)
    hc = bool(cat_np.any())
    K = settings.n_classes
    mc = K > 2          # native multi-class: per-class vote caches
    oob_sum = np.zeros((n_rows, K) if mc else n_rows, np.float32)
    oob_cnt = np.zeros(n_rows, np.float32)
    fi_acc = np.zeros(c, np.float32)      # split gains, summed in f32
    th = torch.from_numpy(thresholds_i64(settings.bagging_rate)).to(dev)

    def tree_key(ti: int) -> torch.Tensor:
        return torch.tensor(row_key_i64(settings.seed, 5000 + ti),
                            device=dev)

    def window_idx(it) -> torch.Tensor:
        """The window's global row indices on the device, kept for
        resident windows."""
        idx = it.arrays.get("idx") if it.resident else None
        if idx is None:
            idx = torch.from_numpy(np.asarray(it.index, np.int64)).to(dev)
            if it.resident:
                it.arrays["idx"] = idx
        return idx

    def window_oob(it):
        """Resident windows keep their vote state on the device across
        trees; tail windows round-trip the host arrays."""
        if it.resident:
            pair = it.arrays.get("oob")
            if pair is None:
                pair = (torch.from_numpy(_window_f(oob_sum, it, mesh))
                        .to(dev),
                        torch.from_numpy(_window_f(oob_cnt, it, mesh))
                        .to(dev))
                it.arrays["oob"] = pair
            return pair
        return (torch.from_numpy(_window_f(oob_sum, it, mesh)).to(dev),
                torch.from_numpy(_window_f(oob_cnt, it, mesh)).to(dev))

    def store_oob(it, osw, ocw) -> None:
        if it.resident:
            it.arrays["oob"] = (osw, ocw)
        else:
            g0, cnt = _own_rows(it, mesh)
            oob_sum[g0:g0 + cnt] = osw[:cnt].cpu().numpy()
            oob_cnt[g0:g0 + cnt] = ocw[:cnt].cpu().numpy()

    if trees:
        # resume / continuous: the restored forest walks every window
        # through B4 (one launch a window), its votes added in tree order
        for it in cache.items():
            osw, ocw = window_oob(it)
            preds = forest_predictions(trees, it.arrays["bins"])
            idx = window_idx(it)
            w_w = it.arrays["w"]
            for ti, pred in enumerate(preds):
                bag = _rf_tail_bags(idx, [tree_key(ti)], th, len(idx),
                                    settings.poisson_bagging)[0]
                oob = (bag == 0) & (w_w > 0)
                osw = osw + torch.where(oob[:, None] if mc else oob, pred,
                                        0.0)
                ocw = ocw + oob.to(ocw.dtype)
            store_oob(it, osw, ocw)

    def absorb_rf(rows_h) -> None:
        """Trees from packed rows, their sums [valid loss, valid weight,
        train loss, train weight] (the resident round's errors over unit
        weights)."""
        nonlocal fi_acc
        for row in rows_h:
            tree, fi_h, sums = _unpack_streamed(row, total, n_bins, c,
                                                settings.depth, K)
            va_err, tr_err = _errors_of(sums)
            if not sums[1] > 0:
                va_err = float("nan")           # no out-of-bag row yet
            fi_acc = fi_acc + fi_h
            trees.append(tree)
            history.append((tr_err, va_err))

    pending_rf: List[torch.Tensor] = []

    def drain_rf() -> None:
        if pending_rf:
            absorb_rf(torch.stack(pending_rf).cpu().numpy())
            pending_rf.clear()

    flush_progress_rf, mark_progress_rf = _progress_flusher(
        drain_rf, history, progress, len(trees) - len(history))

    ti = len(trees)
    sb_drains = 0               # super-batch drains (the fault site's)
    mega = None                 # fully resident: ONE coalesced row block
    n_stats = K if mc else 2
    while ti < settings.n_trees:
        if mega is None and cache.warmed and cache.tail is None:
            items = list(cache.items())
            mega = {k: _concat_rows([it.arrays[k] for it in items])
                    for k in ("bins", "y", "w")}
            oobs = [window_oob(it) for it in items]
            mega["oob_sum"] = _concat_rows([o[0] for o in oobs])
            mega["oob_cnt"] = _concat_rows([o[1] for o in oobs])
            mega["idx"] = _concat_rows([window_idx(it) for it in items])
            for it in items:
                it.arrays.clear()
        if mega is not None:
            packed, mega["oob_sum"], mega["oob_cnt"] = _rf_round_streamed(
                mega["bins"], mega["y"], mega["w"], mega["idx"],
                tree_key(ti), th, mega["oob_sum"], mega["oob_cnt"],
                torch.from_numpy(_feat_subset(settings, c, ti)).to(dev),
                cat, settings, n_bins, hc, mesh)
            pending_rf.append(packed)
            if progress and len(pending_rf) >= 8:
                flush_progress_rf()
            if checkpoint_fn and settings.checkpoint_every and \
                    (ti + 1) % min(settings.checkpoint_every, 8) == 0:
                flush_progress_rf()
                checkpoint_fn(trees, history, None)
            ti += 1
            continue
        # disk-tail regime (and the first batch of any plane): a
        # SUPER-BATCH of trees a sweep, as the reference's DTMaster grows
        # every RF tree with one stats pass a level (``DTMaster.java:91``)
        SB = _tail_super_batch(settings, c, n_bins, n_stats)
        TB = min(settings.n_trees - ti, SB)
        if checkpoint_fn and settings.checkpoint_every:
            nxt = ((ti // settings.checkpoint_every) + 1) * \
                settings.checkpoint_every
            TB = max(1, min(TB, nxt - ti))
        tis = list(range(ti, ti + TB))
        keys = [tree_key(t) for t in tis]
        fa_b = torch.from_numpy(np.stack(
            [_feat_subset(settings, c, t) for t in tis])).to(dev)
        sf_b = torch.full((TB, total), -1, dtype=torch.int32, device=dev)
        lm_b = torch.zeros((TB, total, n_bins), dtype=torch.bool,
                           device=dev)
        lv_b = torch.zeros((TB, total, K) if mc else (TB, total),
                           dtype=torch.float32, device=dev)
        cnt_b = [torch.ones((), dtype=torch.int32, device=dev)
                 for _ in tis]
        fi_b = [torch.zeros(c, dtype=torch.float32, device=dev)
                for _ in tis]
        hist_prev = None
        for level in range(settings.depth):
            n_nodes = 1 << level
            left = level > 0
            width = n_nodes // 2 if left else n_nodes
            hist_b = torch.zeros((TB, width, c, n_bins, n_stats),
                                 dtype=torch.float32, device=dev)
            for it in cache.items():
                hist_b = _rf_window_hist_batch(
                    hist_b, it.arrays["bins"], it.arrays["y"],
                    it.arrays["w"], window_idx(it), keys, th, sf_b, lm_b,
                    width, n_bins, level, K, left, settings.poisson_bagging,
                    mesh)
            hists = list(hist_b.unbind(0))
            if left:
                hists = _subtract(hists, hist_prev,
                                  [sf_b[t, width - 1:2 * width - 1]
                                   for t in range(TB)])
            del hist_b
            for t in range(TB):
                _, _, _, cnt_b[t], fi_b[t] = _tree_level_step(
                    hists[t], cat, fa_b[t], settings.impurity,
                    settings.min_instances, settings.min_gain, hc, level,
                    settings.depth, settings.max_leaves, sf_b[t], lm_b[t],
                    lv_b[t], cnt_b[t], fi_b[t], K)
            hist_prev = hists
        hist_prev = None
        # bottom level: leaf sums, one sweep
        raw_b = torch.zeros((TB, n_stats, 1 << settings.depth),
                            dtype=torch.float32, device=dev)
        for it in cache.items():
            raw_b = _rf_window_leaf_batch(
                raw_b, it.arrays["bins"], it.arrays["y"], it.arrays["w"],
                window_idx(it), keys, th, sf_b, lm_b, settings.depth, K,
                settings.poisson_bagging, mesh)
        base = (1 << settings.depth) - 1
        for t in range(TB):
            lv_b[t, base:] = leaf_values_from_raw(raw_b[t], K)
        # one more sweep: the batch's votes and error sums, in tree order
        sums_b = torch.zeros((TB, 4), dtype=sum_dt, device=dev)
        for it in cache.items():
            osw, ocw = window_oob(it)
            osw, ocw, sums_b = _rf_window_update_batch(
                sums_b, it.arrays["bins"], it.arrays["y"], it.arrays["w"],
                window_idx(it), keys, th, osw, ocw, sf_b, lm_b, lv_b,
                settings.depth, settings.loss, K, settings.poisson_bagging)
            store_oob(it, osw, ocw)
        if sharded:
            meshlib.all_reduce(mesh, sums_b)
        absorb_rf(torch.stack([
            _pack_streamed(sf_b[t], lm_b[t], lv_b[t], fi_b[t], sums_b[t])
            for t in range(TB)]).cpu().numpy())
        if progress:
            for j, t in enumerate(tis):
                tr_err, va_err = history[len(history) - TB + j]
                progress(t, tr_err, va_err)
        mark_progress_rf()
        ti += TB
        sb_drains += 1
        faults.fire("train", "superbatch", sb_drains)
        if checkpoint_fn and settings.checkpoint_every:
            checkpoint_fn(trees, history, None)   # a commit boundary
    flush_progress_rf()
    spec_kwargs: Dict[str, Any] = {"algorithm": "RF"}
    if mc:
        spec_kwargs["extra"] = {"n_classes": K}
    return _streamed_result(ForestResult(
        trees=trees, spec_kwargs=spec_kwargs,
        train_error=history[-1][0] if history else float("nan"),
        valid_error=history[-1][1] if history else float("nan"),
        feature_importance=fi_acc.astype(np.float64),
        trees_built=len(trees), history=history,
        disk_passes=cache.disk_passes, tail_sweeps=cache.tail_sweeps,
        bytes_read=stream.bytes_read - bytes0), cache, stream)


def _streamed_result(res: ForestResult, cache, stream) -> ForestResult:
    """Log a streamed run's pass counts (the line ``chip_smoke.py``
    reads) and return its result."""
    log.info("streamed %s: %d trees; %d windows of %d rows, %d resident "
             "(%d rows); %d disk passes, %d tail sweeps, %d repairs, "
             "surrender at tree %d; %d bytes read",
             res.spec_kwargs["algorithm"], len(res.trees),
             len(cache.cached) + (0 if cache.tail is None else
                                  -(-(stream.num_rows - cache.tail[2])
                                    // stream.window_rows)),
             stream.window_rows, len(cache.cached), cache.resident_rows,
             res.disk_passes, res.tail_sweeps, res.tail_repairs,
             res.tail_surrender, res.bytes_read)
    return res


# ------------------------------------------------- streamed pipeline glue
def _tree_stream(shards, params=None, mesh=None):
    """A ShardStream with the tree trainers' window geometry (one place:
    the main streamed path, members and one-vs-all classes agree), the
    window rounded up to the ``mesh``'s data axis.  ``params`` may carry
    ``StreamPrefetch``, the prefetch depth."""
    from ..data.streaming import ShardStream, stream_window_rows
    ncols = len(shards.schema.get("columnNums", [])) or 1
    window_rows = stream_window_rows(
        2 * ncols + 8, mesh.n_data if meshlib.data_sharded(mesh) else 1,
        shards)
    return ShardStream(shards, ("bins", "y", "w"), window_rows,
                       prefetch=(params or {}).get("StreamPrefetch"))


def _streamed_bag_mask_fn(mc, rf_like: bool, bags: int, seed: int,
                          member: int):
    """Streamed bagged member ``member``'s (train_w, valid_w) mask function
    — THE seed/row policy of out-of-core bags (single-class bagging and
    OVA x bagging alike): GBT bags draw their own validation split from
    their own seed (the in-RAM ``distinct=True``); RF bags share masks and
    differ by the per-tree bag seed.  Stratified validation degrades to
    Bernoulli (callers warn once)."""
    from ..data.streaming import mask_fn_from_settings
    if rf_like:
        mm = mask_fn_from_settings(
            bags, valid_rate=0.0, sample_rate=mc.train.baggingSampleRate,
            replacement=mc.train.baggingWithReplacement, seed=seed)
        row = member
    else:
        mm = mask_fn_from_settings(
            1, valid_rate=mc.train.validSetRate,
            sample_rate=mc.train.baggingSampleRate,
            replacement=mc.train.baggingWithReplacement, seed=seed + member)
        row = 0

    def mf(idx, tgt):
        t, v = mm(idx, tgt)
        return t[row], v[row]
    return mf


def _warn_streamed_stratified(mc) -> None:
    if mc.train.stratifiedSample:
        log.warning("streaming: stratified validation degrades to "
                    "Bernoulli split (needs a global pass)")


def _train_streamed_member(alg, shards, n_bins: int, cat_mask,
                           settings: DTSettings, mask_fn, y_transform=None,
                           device=None) -> ForestResult:
    """One sequential out-of-core member (the reference's one job a bag
    or a trial)."""
    stream = _tree_stream(shards)
    if alg == Algorithm.GBT:
        return train_gbt_streamed(stream, n_bins, cat_mask, settings,
                                  y_transform=y_transform, mask_fn=mask_fn,
                                  device=device)
    return train_rf_streamed(stream, n_bins, cat_mask, settings,
                             y_transform=y_transform, mask_fn=mask_fn,
                             device=device)


# ----------------------------------------------------------------- entry
def _fetch(x: torch.Tensor) -> np.ndarray:
    """Device-to-host copy of a chunk's packed trees — the counted host
    sync of the resident growers (``train.host_syncs``)."""
    obs.counter("train.host_syncs").inc()
    return x.cpu().numpy()


#: what a mesh leaves out of the tree trainers (ROADMAP Queue 1)
_MESH_TREES_ITEM = ("item 12 (multi-device: the bagged, k-fold, grid, "
                    "one-vs-all and multi-class tree trainers)")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to shifu_tpu_torch (ROADMAP Queue 1 "
        f"{item}) — train it with shifu_tpu")


def _clear_models(proc) -> None:
    os.makedirs(proc.paths.models_dir, exist_ok=True)
    for f in os.listdir(proc.paths.models_dir):
        if f.startswith("model"):
            os.remove(os.path.join(proc.paths.models_dir, f))


def _save_forest(proc, path: str, res: ForestResult, alg, depth: int,
                 n_bins: int, col_nums, feature_names) -> None:
    """A forest's model file, its spec from the result's kwargs."""
    kw = dict(res.spec_kwargs)
    if alg != Algorithm.GBT:
        kw["algorithm"] = alg.name
    tree_model.save_model(path, tree_model.TreeModelSpec(
        n_trees=len(res.trees), depth=depth, n_bins=n_bins,
        column_nums=list(col_nums), feature_names=feature_names, **kw),
        res.trees)


def _write_feature_importance(proc, col_nums, feature_names,
                              fi_total) -> List[str]:
    """``tmp/feature_importance.json``, gains summed per column, highest
    first; returns the column names in that order."""
    names = feature_names or [str(cn) for cn in col_nums]
    fi_named = sorted(((names[j], float(v)) for j, v in enumerate(fi_total)),
                      key=lambda kv: -kv[1])
    ioutil.atomic_write_json(
        os.path.join(proc.paths.tmp_dir, "feature_importance.json"),
        dict(fi_named))
    return [k for k, _ in fi_named]


def _load_plane(proc, shards, n_bins: int):
    """The clean plane's (bins on the step's device, y, w) for the member
    and class paths, which share one upload."""
    with proc.phase("load_data"):
        data = shards.load_all()
    with proc.phase("train/upload"):
        bins_d = put_bins(data["bins"], n_bins, proc.device)
    return bins_d, data["y"], data["w"]


def _tree_member_masks(mc, n: int, bags: int, kfold: int, rf_like: bool,
                       targets, seed: int, distinct: bool = False):
    """(tw_m, vw_m) member weight matrices for bagged/fold tree members
    (reference ``_tree_member_masks``) — RF-family members take the full
    bag as train weight (out-of-bag validates), GBT members keep the
    held-out split.

    ``distinct``: each bagging member draws its OWN validation split from
    its own seed (the reference's per-Guagua-job randomness) — without it,
    default-config GBT bags (sampleRate 1, no replacement, subset ALL)
    would be byte-identical forests.  Grid trials must NOT use it: trials
    share one split so the comparison isolates the hypers."""
    def one(nb: int, sd: int):
        return member_masks(
            n, nb, valid_rate=0.0 if rf_like else mc.train.validSetRate,
            kfold=kfold, sample_rate=mc.train.baggingSampleRate,
            replacement=mc.train.baggingWithReplacement,
            stratified=mc.train.stratifiedSample, targets=targets, seed=sd)

    if distinct and bags > 1 and not rf_like and not kfold > 1:
        pairs = [one(1, seed + b) for b in range(bags)]
        tw_m = np.concatenate([p[0] for p in pairs])
        vw_m = np.concatenate([p[1] for p in pairs])
    else:
        tw_m, vw_m = one(bags, seed)
    if rf_like and not kfold > 1:
        tw_m = tw_m + vw_m
    return tw_m, vw_m


def _run_members(bins_d, y, w, tw_m, vw_m, idxs, settings_list, alg,
                 n_bins: int, cat_mask, proc) -> List[ForestResult]:
    """Members ``idxs`` of one structure: GBT boosted side by side
    (:func:`train_gbt_bagged`) or one by one when early stop is on (a
    per-run decision loop, as in the reference), RF/DT one by one on the
    shared plane (:func:`train_rf_bagged`)."""
    sl = [settings_list[i] for i in idxs]
    kw = dict(device=proc.device, phase=proc.phase)
    if alg == Algorithm.GBT and sl[0].early_stop:
        return [train_gbt(bins_d, y, w * (tw_m[i] + vw_m[i] > 0), n_bins,
                          cat_mask, s, **kw) for i, s in zip(idxs, sl)]
    if alg == Algorithm.GBT:
        return train_gbt_bagged(bins_d, y, tw_m[idxs] * w[None, :],
                                vw_m[idxs] * w[None, :], n_bins, cat_mask,
                                sl, **kw)
    return train_rf_bagged(bins_d, y, tw_m[idxs] * w[None, :], n_bins,
                           cat_mask, sl, **kw)


def _run_tree_multi(proc, shards, col_nums, cat_mask, n_bins: int, alg,
                    trials, is_gs: bool, kfold: int, bags: int,
                    base: DTSettings) -> int:
    """Tree grid search / bagging / k-fold (reference ``_run_tree_multi``;
    ``TrainModelProcessor.java:768-945`` runs one Guagua job per
    bag/combo/fold).  Same-structure members train together
    (:func:`_run_members`); structurally different grid trials run group
    by group.  RF k-fold scores each fold's forest on its held-out rows
    (the mean vote, walked by B4 on the card).  A streamed plane trains
    its members one after the other, each a full out-of-core run whose
    bag or split is a stateless hash of the global row index (the
    reference's one job a bag or trial); k-fold stays in RAM."""
    from .grid_search import rank_and_report, tree_stackable_groups
    mc = proc.model_config
    streaming = proc._use_streaming(shards, shards.schema)
    if streaming and kfold > 1:
        log.warning("k-fold CV ignores streaming mode (the held-out fold "
                    "vote needs full-data passes); folds train in-RAM")
        streaming = False
    if is_gs:
        settings_list = [replace(settings_from_params(t, mc.train, alg),
                                 stats_exact=base.stats_exact)
                         for t in trials]
    else:
        settings_list = [replace(base, seed=base.seed + b)
                         for b in range(kfold if kfold > 1 else bags)]
    _clear_models(proc)
    rf_like = alg != Algorithm.GBT
    if streaming:
        from ..data.streaming import mask_fn_from_settings
        _warn_streamed_stratified(mc)

        def member_mask(i: int):
            """Member i's window mask: grid trials share ONE split,
            bagging members follow :func:`_streamed_bag_mask_fn`."""
            if not is_gs:
                return _streamed_bag_mask_fn(mc, rf_like,
                                             len(settings_list), base.seed,
                                             i)
            mm = mask_fn_from_settings(
                1, valid_rate=0.0 if rf_like else mc.train.validSetRate,
                sample_rate=mc.train.baggingSampleRate,
                replacement=mc.train.baggingWithReplacement, seed=base.seed)

            def mf(idx, tgt):
                t, v = mm(idx, tgt)
                return t[0], v[0]
            return mf

        def run_group(group: List[int]) -> List[ForestResult]:
            return [_train_streamed_member(alg, shards, n_bins, cat_mask,
                                           settings_list[i], member_mask(i),
                                           device=proc.device)
                    for i in group]
        log.info("train %s STREAMED on %s: %d %s of %d rows, %d trees "
                 "depth %d", alg.name, proc.device, len(settings_list),
                 "trials" if is_gs else "members", shards.num_rows,
                 base.n_trees, base.depth)
    else:
        bins_d, y, w = _load_plane(proc, shards, n_bins)
        n = len(y)
        # sampling masks: grid trials share ONE split (isolate the
        # hypers); bagging/k-fold members each get their bag/fold
        if is_gs:
            tw1, vw1 = _tree_member_masks(mc, n, 1, -1, rf_like, y,
                                          base.seed)
            tw_m = np.repeat(tw1, len(trials), axis=0)
            vw_m = np.repeat(vw1, len(trials), axis=0)
        else:
            tw_m, vw_m = _tree_member_masks(mc, n, bags, kfold, rf_like, y,
                                            base.seed, distinct=True)
        log.info("train %s on %s: %d %s of %d rows x %d features, %d trees "
                 "depth %d", alg.name, proc.device,
                 len(settings_list), "trials" if is_gs else "members",
                 *bins_d.shape, base.n_trees, base.depth)

        def run_group(group: List[int]) -> List[ForestResult]:
            return _run_members(bins_d, y, w, tw_m, vw_m, group,
                                settings_list, alg, n_bins, cat_mask, proc)

    results: List[Optional[ForestResult]] = [None] * len(settings_list)
    groups = tree_stackable_groups(trials) if is_gs \
        else [list(range(len(settings_list)))]
    with proc.phase("train"), open(proc.paths.progress_path, "w") as pf:
        for group in groups:
            for j, res in zip(group, run_group(group)):
                results[j] = res
                label = f"Trial [{j}]" if is_gs else f"Bag [{j}]"
                for ti, (tr, va) in enumerate(res.history):
                    pf.write(f"{label} Tree #{ti + 1} Train Error: "
                             f"{tr:.6f} Validation Error: {va:.6f}\n")
                pf.flush()
                obs.counter("train.trees").inc(res.trees_built)
                obs.event("forest_member", trainer=alg.name.lower(),
                          member=j, trees=res.trees_built,
                          valid_err=round(res.valid_error, 6))
        if rf_like and kfold > 1 and not is_gs:
            # RF k-fold: oob error is in-fold; the CV figure of merit is
            # the mean-vote error on the HELD-OUT fold (reference CV)
            for i, res in enumerate(results):
                fold = vw_m[i] > 0
                rows = torch.from_numpy(np.flatnonzero(fold)).to(
                    bins_d.device)
                vote = predict_forest(res.trees, bins_d.index_select(
                    0, rows)).cpu().numpy()
                yf, wf = y[fold], (w * vw_m[i])[fold]
                if base.loss == "log":
                    pr = np.clip(vote, 1e-9, 1 - 1e-9)
                    per = -(yf * np.log(pr) + (1 - yf) * np.log(1 - pr))
                else:
                    per = (yf - vote) ** 2
                res.valid_error = float((per * wf).sum()
                                        / max(wf.sum(), 1e-9))

    feature_names = shards.schema.get("columnNames")
    with proc.phase("save_model"):
        if is_gs:
            order = rank_and_report(proc.paths.tmp_dir,
                                    [r.valid_error for r in results], trials)
            best = order[0]
            log.info("grid search: best trial #%d valid error %.6f params "
                     "%s", best, results[best].valid_error, trials[best])
            _save_forest(proc, proc.paths.model_path(0, alg.name.lower()),
                         results[best], alg, settings_list[best].depth,
                         n_bins, col_nums, feature_names)
        else:
            for i, res in enumerate(results):
                _save_forest(proc, proc.paths.model_path(i, alg.name.lower()),
                             res, alg, settings_list[i].depth, n_bins,
                             col_nums, feature_names)
            log.info("saved %d bagged %s model(s); valid errors %s",
                     len(results), alg.name,
                     [round(r.valid_error, 6) for r in results])
        _write_feature_importance(
            proc, col_nums, feature_names,
            np.sum([r.feature_importance for r in results], axis=0))
    return 0


def _fi_class_path(proc, k: int) -> str:
    """Per-class importance sidecar: a resumed one-vs-all run skips
    finished classes but still reports every class's gains."""
    return os.path.join(proc.paths.tmp_dir, f"fi_class{k}.npy")


def _write_class_importance(proc, col_nums, feature_names, K: int) -> None:
    fi_total = np.zeros(len(col_nums))
    for k in range(K):
        if os.path.isfile(_fi_class_path(proc, k)):
            fi_total += np.load(_fi_class_path(proc, k))
        else:
            log.warning("one-vs-all class %d has no stored feature "
                        "importance; the totals omit it", k)
    _write_feature_importance(proc, col_nums, feature_names, fi_total)


def _run_tree_ova(proc, shards, col_nums, cat_mask, n_bins: int,
                  settings: DTSettings, alg, K: int) -> int:
    """One-vs-all tree multiclass (reference ``_run_tree_ova``): K binary
    forests, ``model{k}`` scores class k (spec extra ``class_index``).
    ``train -resume`` restarts at the first unfinished class, restoring
    the interrupted class's mid-forest checkpoint (``forest_ckpt_c{k}``).
    A streamed plane trains each class out of core, the class binarised
    in the window hook."""
    ext = alg.name.lower()
    if not settings.resume:
        _clear_models(proc)
    streaming = proc._use_streaming(shards, shards.schema)
    bins_d = y = w = None
    if not streaming:
        bins_d, y, w = _load_plane(proc, shards, n_bins)
    feature_names = shards.schema.get("columnNames")
    with proc.phase("train"), \
            open(proc.paths.progress_path,
                 "a" if settings.resume else "w") as pf:
        for k in range(K):
            model_path = proc.paths.model_path(k, ext)
            if settings.resume and os.path.isfile(model_path):
                spec_k, _ = tree_model.load_model(model_path)
                if spec_k.n_trees >= settings.n_trees:
                    log.info("train %s OVA class %d/%d: already complete "
                             "(%d trees), skipping", alg.name, k + 1, K,
                             spec_k.n_trees)
                    continue
            init_trees = init_score = start_history = init_scores = None
            ck = _forest_checkpoint_path(proc, f"_c{k}")
            if settings.resume and os.path.isfile(ck):
                init_trees, init_score, start_history, init_scores = \
                    _restore_checkpoint(ck)
                log.info("OVA resume: class %d restarts from %d "
                         "checkpointed trees", k, len(init_trees))
            ckpt_fn = _forest_checkpoint_fn(proc, settings, alg, n_bins,
                                            col_nums, shards,
                                            suffix=f"_c{k}")

            def progress(ti, tr, va, k=k):
                pf.write(f"Class {k} Tree #{ti + 1} Train Error: {tr:.6f} "
                         f"Validation Error: {va:.6f}\n")
                pf.flush()

            kw = dict(checkpoint_fn=ckpt_fn, init_trees=init_trees,
                      start_history=start_history, device=proc.device)

            def yk_of(yv, k=k):
                return (np.asarray(yv) == k).astype(np.float32)
            if streaming and alg == Algorithm.GBT:
                res = train_gbt_streamed(
                    _tree_stream(shards), n_bins, cat_mask, settings,
                    progress, init_score=init_score,
                    init_scores=init_scores, y_transform=yk_of, **kw)
            elif streaming:
                res = train_rf_streamed(_tree_stream(shards), n_bins,
                                        cat_mask, settings, progress,
                                        y_transform=yk_of, **kw)
            elif alg == Algorithm.GBT:
                res = train_gbt(bins_d, yk_of(y), w, n_bins, cat_mask,
                                settings, progress, init_score=init_score,
                                init_scores=init_scores, phase=proc.phase,
                                **kw)
            else:
                res = train_rf(bins_d, yk_of(y), w, n_bins, cat_mask,
                               settings, progress, phase=proc.phase, **kw)
            res.spec_kwargs.setdefault("extra", {}).update(
                {"class_index": k, "n_classes": K})
            with proc.phase("save_model"):
                _save_forest(proc, model_path, res, alg, settings.depth,
                             n_bins, col_nums, feature_names)
                ioutil.atomic_save_npy(_fi_class_path(proc, k),
                                       np.asarray(res.feature_importance))
            log.info("train %s OVA class %d/%d: %d trees, valid err %.6f",
                     alg.name, k + 1, K, res.trees_built, res.valid_error)
    _write_class_importance(proc, col_nums, feature_names, K)
    return 0


def _run_tree_ova_bagged(proc, shards, col_nums, cat_mask, n_bins: int,
                         settings: DTSettings, alg, K: int,
                         bags: int) -> int:
    """OVA x bagging: B independent forests per class (reference
    ``_run_tree_ova_bagged``; ``TrainModelProcessor.java:684-714`` runs
    one FULL bagging job per class).  Member ``b*K + k`` scores class k
    (its ``class_index`` extra; the scorer averages contributors per
    class).  ``train -resume`` skips classes whose B models are all
    complete.  A streamed plane runs K x B sequential out-of-core jobs,
    each bag a stateless hash of the global row index."""
    mc = proc.model_config
    ext = alg.name.lower()
    if not settings.resume:
        _clear_models(proc)
    streaming = proc._use_streaming(shards, shards.schema)
    if streaming:
        _warn_streamed_stratified(mc)
    else:
        bins_d, y, w = _load_plane(proc, shards, n_bins)
        n = len(y)
    rf_like = alg != Algorithm.GBT
    settings_list = [replace(settings, seed=settings.seed + b)
                     for b in range(bags)]
    feature_names = shards.schema.get("columnNames")

    def class_complete(k: int) -> bool:
        for b in range(bags):
            path = proc.paths.model_path(b * K + k, ext)
            if not os.path.isfile(path) or \
                    tree_model.load_model(path)[0].n_trees < settings.n_trees:
                return False
        return True

    with proc.phase("train"), \
            open(proc.paths.progress_path,
                 "a" if settings.resume else "w") as pf:
        for k in range(K):
            if settings.resume and class_complete(k):
                log.info("train %s OVA class %d/%d: all %d bags complete, "
                         "skipping", alg.name, k + 1, K, bags)
                continue
            if streaming:
                def yt(yv, k=k):
                    return (np.asarray(yv) == k).astype(np.float32)
                results = [_train_streamed_member(
                    alg, shards, n_bins, cat_mask, settings_list[b],
                    _streamed_bag_mask_fn(mc, rf_like, bags, settings.seed,
                                          b),
                    y_transform=yt, device=proc.device)
                    for b in range(bags)]
            else:
                yk = (np.asarray(y) == k).astype(np.float32)
                tw_m, vw_m = _tree_member_masks(mc, n, bags, -1, rf_like,
                                                yk, settings.seed,
                                                distinct=True)
                results = _run_members(bins_d, yk, w, tw_m, vw_m,
                                       list(range(bags)), settings_list, alg,
                                       n_bins, cat_mask, proc)
            with proc.phase("save_model"):
                ioutil.atomic_save_npy(
                    _fi_class_path(proc, k),
                    np.sum([r.feature_importance for r in results], axis=0))
                for b, res in enumerate(results):
                    res.spec_kwargs.setdefault("extra", {}).update(
                        {"class_index": k, "n_classes": K})
                    _save_forest(proc, proc.paths.model_path(b * K + k, ext),
                                 res, alg, settings.depth, n_bins, col_nums,
                                 feature_names)
                    for ti, (tr, va) in enumerate(res.history):
                        pf.write(f"Class {k} Bag {b} Tree #{ti + 1} Train "
                                 f"Error: {tr:.6f} Validation Error: "
                                 f"{va:.6f}\n")
                pf.flush()
            log.info("train %s OVA class %d/%d: %d bagged forests, valid "
                     "errs %s", alg.name, k + 1, K, len(results),
                     [round(r.valid_error, 6) for r in results])
    _write_class_importance(proc, col_nums, feature_names, K)
    return 0


def run_tree_training(proc) -> int:
    """Entry called by TrainProcessor for tree algorithms (reference
    ``run_tree_training``): grid search, bagging and k-fold members,
    one-vs-all and native multi-class, or the single resident GBT, RF or
    DT."""
    from ..config.model_config import MultipleClassification
    from ..config.validator import ValidationError
    mc = proc.model_config
    alg = mc.train.algorithm
    shards = proc._open_shards(proc.paths.clean_dir)
    col_nums = shards.schema.get("columnNums", [])
    by_num = {c.columnNum: c for c in proc.column_configs}
    cat_mask = np.array([by_num[cn].is_categorical() if cn in by_num
                         else False for cn in col_nums])
    # bin-space width from ColumnConfig (value bins + the missing bin),
    # not from the data, which may lack rare bins
    n_bins = max((by_num[cn].num_bins() + 1 for cn in col_nums
                  if cn in by_num), default=2)
    trials = proc._trials(dict(mc.train.params or {}))
    is_gs = len(trials) > 1
    kfold = mc.train.numKFold if mc.train.isCrossValidation else -1
    bags = 1 if is_gs else max(1, mc.train.baggingNum)
    multi = is_gs or bags > 1 or kfold > 1
    # trials[0] == params when no grid axes; raw params may hold lists
    settings = settings_from_params(trials[0], mc.train, alg)
    settings.resume = bool(proc.params.get("resume"))
    settings.stats_exact = not mc.dataSet.weightColumnName

    K = len(mc.dataSet.posTags) if mc.is_multi_class() else 0
    # GBT has no native multi-class mode (reference restricts NATIVE to
    # NN/RF, ``TrainModelProcessor.java:347-349``)
    ova = K > 2 and (mc.train.multiClassifyMethod
                     == MultipleClassification.ONEVSALL
                     or alg == Algorithm.GBT)
    # trees are sequential: every rank on the data axis (reference
    # ``device_mesh(n_ensemble=1)``)
    mesh = meshlib.device_mesh(n_ensemble=1)
    if meshlib.data_sharded(mesh) and (multi or K > 2):
        raise _not_ported("bagged, k-fold, grid-search, one-vs-all and "
                          "multi-class tree training on a mesh",
                          _MESH_TREES_ITEM)
    if K > 2 and multi:
        if ova and bags > 1 and not is_gs and not kfold > 1:
            return _run_tree_ova_bagged(proc, shards, col_nums, cat_mask,
                                        n_bins, settings, alg, K, bags)
        what = "grid search / k-fold" if (is_gs or kfold > 1) \
            else "bagging with NATIVE multi-class"
        raise ValidationError(
            [f"{what} is not supported with multi-class tree training — "
             "train trials/folds individually, or use ONEVSALL (OVA "
             "bagging is supported)"])
    if multi:
        return _run_tree_multi(proc, shards, col_nums, cat_mask, n_bins,
                               alg, trials, is_gs, kfold, bags, settings)
    if ova:
        return _run_tree_ova(proc, shards, col_nums, cat_mask, n_bins,
                             settings, alg, K)
    if K > 2:
        settings.n_classes = K
        settings.loss = "squared"          # errors are misclassification
        if settings.impurity not in ("entropy", "gini"):
            settings.impurity = "entropy"
    ckpt_fn = _forest_checkpoint_fn(proc, settings, alg, n_bins, col_nums,
                                    shards)

    with open(proc.paths.progress_path, "w") as pf:
        def progress(ti, tr, va):
            line = (f"Tree #{ti + 1} Train Error: {tr:.6f} "
                    f"Validation Error: {va:.6f}")
            pf.write(line + "\n")
            pf.flush()
            obs.counter("train.trees").inc()
            obs.event("tree", trainer=alg.name.lower(), tree=ti + 1,
                      train_err=round(tr, 6), valid_err=round(va, 6))
            faults.fire("train", "tree", ti + 1)
            if (ti + 1) % 5 == 0 or ti == 0:
                log.info(line)

        init_trees, init_score, start_history, init_scores = \
            _restore_or_continuous(proc, alg, settings)
        refresh_extra = int(proc.params.get("refresh_extra") or 0)
        if refresh_extra and init_trees:
            # refresh warm start: the budget is N more trees appended past
            # the restored forest (a plain resume keeps TreeNum); on the
            # new data window the restored trees replay through B4 unless
            # the score sidecar covers exactly these rows
            settings.n_trees = len(init_trees) + refresh_extra
            # an early stop that tripped on the old stream must not veto
            # appending trees for the new window: do not replay it
            start_history = None
            log.info("refresh warm-start: %d restored trees + %d new "
                     "(target %d)", len(init_trees), refresh_extra,
                     settings.n_trees)
        if init_scores is not None and len(init_scores) != shards.num_rows:
            log.info("checkpoint scores cover %d rows, plane has %d — "
                     "replaying restored trees instead",
                     len(init_scores), shards.num_rows)
            init_scores = None
        streaming = proc._use_streaming(shards, shards.schema)
        if streaming:
            stream = _tree_stream(shards, dict(mc.train.params or {}), mesh)
            log.info("train %s STREAMED on %s: %d rows, window %d rows, "
                     "mesh %s", alg.name, proc.device, stream.num_rows,
                     stream.window_rows, mesh.shape)
        else:
            with proc.phase("load_data"):
                data = shards.load_all()
            bins, y, w = data["bins"], data["y"], data["w"]
            log.info("train %s on %s: %d rows x %d features, %d bins, %d "
                     "trees depth %d, mesh %s", alg.name, proc.device,
                     *bins.shape, n_bins, settings.n_trees, settings.depth,
                     mesh.shape)
        with proc.phase("train"):
            if streaming and alg == Algorithm.GBT:
                res = train_gbt_streamed(
                    stream, n_bins, cat_mask, settings, progress,
                    init_trees=init_trees, init_score=init_score,
                    checkpoint_fn=ckpt_fn, start_history=start_history,
                    init_scores=init_scores, device=proc.device, mesh=mesh)
            elif streaming:
                res = train_rf_streamed(
                    stream, n_bins, cat_mask, settings, progress,
                    checkpoint_fn=ckpt_fn, init_trees=init_trees,
                    start_history=start_history, device=proc.device,
                    mesh=mesh)
            elif alg == Algorithm.GBT:
                res = train_gbt(bins, y, w, n_bins, cat_mask, settings,
                                progress, init_trees=init_trees,
                                init_score=init_score, checkpoint_fn=ckpt_fn,
                                start_history=start_history,
                                init_scores=init_scores, device=proc.device,
                                phase=proc.phase, mesh=mesh)
            else:
                res = train_rf(bins, y, w, n_bins, cat_mask, settings,
                               progress, checkpoint_fn=ckpt_fn,
                               init_trees=init_trees,
                               start_history=start_history,
                               device=proc.device, phase=proc.phase,
                               mesh=mesh)

    obs.gauge("train.valid_err").set(res.valid_error)
    obs.gauge("train.trees_built").set(res.trees_built)
    feature_names = shards.schema.get("columnNames")
    with proc.phase("save_model"):
        _clear_models(proc)
        _save_forest(proc, proc.paths.model_path(0, alg.name.lower()), res,
                     alg, settings.depth, n_bins, col_nums, feature_names)
        top = _write_feature_importance(proc, col_nums, feature_names,
                                        res.feature_importance)
    log.info("train %s done: %d trees, train err %.6f valid err %.6f; "
             "top features %s", alg.name, res.trees_built, res.train_error,
             res.valid_error, top[:5])
    return 0


def _forest_checkpoint_path(proc, suffix: str = "") -> str:
    return os.path.join(proc.paths.checkpoint_dir,
                        f"forest_ckpt{suffix}.npz")


def _forest_checkpoint_fn(proc, settings: DTSettings, alg, n_bins, col_nums,
                          shards, suffix: str = ""):
    """Mid-forest checkpoint (reference ``DTMaster.doCheckPoint``): the
    partial forest, its error history, and the per-row scores f in a
    sidecar so a resume restores f byte-exact."""
    def save(trees, history, init_score, scores=None):
        os.makedirs(proc.paths.checkpoint_dir, exist_ok=True)
        spec = tree_model.TreeModelSpec(
            n_trees=len(trees), depth=settings.depth, n_bins=n_bins,
            column_nums=list(col_nums),
            feature_names=shards.schema.get("columnNames"),
            algorithm=alg.name, loss=settings.loss,
            learning_rate=settings.learning_rate,
            init_score=init_score if init_score is not None else 0.0)
        path = _forest_checkpoint_path(proc, suffix)
        tree_model.save_model(path, spec, trees)
        spath = path + ".scores.npz"
        if scores is not None:
            ioutil.atomic_savez(spath, f=np.asarray(scores, np.float32),
                                trees_done=np.asarray(len(trees), np.int64))
        else:
            try:           # never pair stale scores with a newer forest
                os.remove(spath)
            except OSError:
                pass
        ioutil.atomic_write_json(path + ".meta.json",
                                 {"trees_done": len(trees),
                                  "history": history,
                                  "seed": settings.seed}, indent=0)
        log.info("forest checkpoint: %d trees", len(trees))
    return save


def _restore_checkpoint(path: str):
    """A mid-forest checkpoint's (trees, init_score, history, scores): the
    per-row scores only when the sidecar covers exactly these trees."""
    spec, trees = tree_model.load_model(path)
    meta = {}
    if os.path.isfile(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    history = [tuple(h) for h in meta.get("history", [])]
    scores = None
    try:
        d = np.load(path + ".scores.npz")
        if int(d["trees_done"]) == len(trees):
            scores = np.asarray(d["f"], np.float32)
    except (OSError, ValueError, KeyError):
        pass
    return trees, spec.init_score, history, scores


def _restore_or_continuous(proc, alg, settings: DTSettings):
    """Resume order: ``train -resume`` from the mid-forest checkpoint,
    else continuous training from the final saved model.  Returns (trees,
    init_score, history, scores)."""
    if settings.resume:
        path = _forest_checkpoint_path(proc)
        if os.path.isfile(path):
            trees, init_score, history, scores = _restore_checkpoint(path)
            log.info("resume: restored %d trees from forest checkpoint%s",
                     len(trees),
                     " (+ per-row scores)" if scores is not None else "")
            return trees, init_score, history, scores
    init_trees, init_score = _continuous_trees(proc, alg, settings)
    return init_trees, init_score, None, None


def _continuous_trees(proc, alg, settings: DTSettings
                      ) -> Tuple[Optional[List[TreeArrays]], Optional[float]]:
    """GBT continuous training appends trees to the saved forest, when its
    shrinkage and loss match (reference ``checkContinuousTraining``)."""
    if not proc.model_config.train.isContinuous or alg != Algorithm.GBT:
        return None, None
    path = proc.paths.model_path(0, alg.name.lower())
    if not os.path.isfile(path):
        return None, None
    spec, trees = tree_model.load_model(path)
    if spec.loss != settings.loss or \
            abs(spec.learning_rate - settings.learning_rate) > 1e-12:
        log.warning("continuous GBT: saved forest used loss=%s lr=%s but "
                    "params now say loss=%s lr=%s — training fresh",
                    spec.loss, spec.learning_rate, settings.loss,
                    settings.learning_rate)
        return None, None
    log.info("continuous GBT: resuming from %d existing trees", len(trees))
    return trees, spec.init_score
