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

Not ported yet: bagging, grid search, k-fold, one-vs-all and native
multi-class (ROADMAP Queue 1 item 6), the streamed trainers (item 8).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import warnings
from dataclasses import dataclass, field
from typing import (Any, Callable, ContextManager, Dict, List, Optional,
                    Tuple)

import numpy as np
import torch

from .. import ioutil
from ..config.model_config import Algorithm
from ..data.shards import bins_wire_dtype
from ..models import tree as tree_model
from ..ops import prng
from ..ops import tree_quant as tq
from ..ops.hist import widen_bins
from ..ops.tree import TreeArrays, grow_forest, grow_tree, n_tree_nodes
from .early_stop import GBTEarlyStopDecider
from .sampling import validation_split

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
    max_leaves: int = 0                  # >0: leaf-wise node budget
    # weights promised small-integer (no weight column): the reference's
    # Pallas kernels then skip their f32-recovery dots.  Accepted for
    # parity and ignored: B1/B2 find their integer channels on the device
    # (ops/hist.py::channel_meta) and sum those in 32 bits on their own
    stats_exact: bool = False
    tree_batch: int = 0                  # RF trees a batched grow; 0 =
                                         # auto (RF_TREE_BATCH)
    early_stop_check: int = 8            # trees between early-stop checks


def settings_from_params(params: Dict[str, Any], train_conf,
                         alg: Algorithm) -> DTSettings:
    """Reference train#params tree keys: TreeNum / MaxDepth / Impurity /
    Loss / LearningRate / FeatureSubsetStrategy / MinInstancesPerNode /
    MinInfoGain / MaxLeaves / Seed / CheckpointInterval / TreeBatch /
    EarlyStopCheckInterval, and the train section's validSetRate,
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
        early_stop_check=max(1, int(p.get("EarlyStopCheckInterval", 8))))


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


def gbt_round(bins, y, tw, vw, f, fa, cat, settings: DTSettings,
              n_bins: int, impurity: str, has_cat: bool):
    """One GBT tree end to end on the device: residual grad -> grow ->
    score update -> train/valid error.  Returns (split_feat, left_mask,
    leaf_value, gain_fi, f2, train_err, valid_err), all device tensors."""
    grad = _loss_grad(y, f, settings.loss)
    stats = torch.stack([tw, tw * grad], dim=1).float()
    sf, lm, lv, gfi, leaf_glob = grow_tree(
        bins, stats, cat, fa, n_bins, settings.depth, impurity,
        settings.min_instances, settings.min_gain, settings.max_leaves,
        has_cat)
    f2 = f + settings.learning_rate * lv[leaf_glob.long()]
    per = _per_row_loss(y, f2, settings.loss)
    tr = (per * tw).sum() / tw.sum().clamp_min(1e-9)
    va = (per * vw).sum() / vw.sum().clamp_min(1e-9)
    return sf, lm, lv, gfi, f2, tr, va


def _pack_tree(sf, lm, lv, gfi, tr, va) -> torch.Tensor:
    """One tree's arrays as one device byte row: split_feat int32, left
    mask one byte per bin, leaf values and gains f32, [train, valid] f32."""
    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([raw(sf.to(torch.int32)), lm.reshape(-1).to(torch.uint8),
                      raw(lv.float()), raw(gfi.float()),
                      raw(torch.stack([tr, va]).float())])


def _unpack_tree(row: np.ndarray, total: int, n_bins: int, c: int,
                 depth: int):
    """Host-side inverse of :func:`_pack_tree`: (tree, gain_fi f64,
    train_err, valid_err)."""
    sizes = [4 * total, total * n_bins, 4 * total, 4 * c, 8]
    sf, lm, lv, gfi, err = np.split(row, np.cumsum(sizes)[:-1])
    tree = TreeArrays(split_feat=sf.view(np.int32).copy(),
                      left_mask=lm.reshape(total, n_bins) > 0,
                      leaf_value=lv.view(np.float32).copy(), depth=depth)
    err = err.view(np.float32)
    return tree, gfi.view(np.float32).astype(np.float64), float(err[0]), \
        float(err[1])


def gbt_forest_chunk(bins, y, tw, vw, f, fa_all, cat, settings: DTSettings,
                     n_bins: int, impurity: str, has_cat: bool):
    """A chunk of the forest: one :func:`gbt_round` per row of ``fa_all``
    ([T, C] bool, on the device), with no host sync.  Returns (f after the
    chunk, packed [T, L] uint8 device tensor)."""
    rows = []
    for j in range(fa_all.shape[0]):
        sf, lm, lv, gfi, f, tr, va = gbt_round(
            bins, y, tw, vw, f, fa_all[j], cat, settings, n_bins, impurity,
            has_cat)
        rows.append(_pack_tree(sf, lm, lv, gfi, tr, va))
    return f, torch.stack(rows)


def put_bins(bins: np.ndarray, n_bins: int,
             device: torch.device) -> torch.Tensor:
    """The bin plane on ``device`` in the compact wire dtype — uint8 up to
    256 bins, int32 beyond (a uint16 plane widens on the device).  A plane
    in another dtype than the wire's is range-checked first: a stale clean
    dir must fail loudly, not wrap ids through the narrowing cast."""
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


def _walk(trees: List[TreeArrays], bins_d) -> List[torch.Tensor]:
    """Each restored tree's [N] prediction through kernel B4
    (``predict_forest_quant``), one batched walk per depth group."""
    preds: List[Optional[torch.Tensor]] = [None] * len(trees)
    by_depth: Dict[int, List[int]] = {}
    for i, t in enumerate(trees):
        by_depth.setdefault(t.depth, []).append(i)
    for depth, idxs in by_depth.items():
        arrays = tq.stack_forest_quant([trees[i] for i in idxs],
                                       bins_d.device)
        out = tq.predict_forest_quant(*arrays, bins_d, depth)
        for j, i in enumerate(idxs):
            preds[i] = out[j]
    return preds


def _replay(trees: List[TreeArrays], bins_d, f, lr: float):
    """Continuous/resume replay of restored GBT trees: the walks, then the
    per-tree adds in forest order, as the reference's eager loop does."""
    for p in _walk(trees, bins_d):
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
              ) -> ForestResult:
    """Boost ``settings.n_trees`` trees (minus restored ones) over the
    resident plane ``bins`` [N, C] (wire dtype; a memmap is fine) on
    ``device``.  ``phase(name)`` (the step's profile timer) times the
    parts: ``train/upload`` (plane and labels to the device),
    ``train/replay`` (launching restored trees through B4; the device
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

    if init_score is None:  # continuous runs reuse the saved forest's prior
        prior = float((y64 * wt).sum() / max(wt.sum(), 1e-9))
        if settings.loss == "log":
            prior = np.clip(prior, 1e-6, 1 - 1e-6)
            init_score = float(np.log(prior / (1 - prior)))
        else:
            init_score = prior

    with phase("train/upload"):
        bins_d = put_bins(bins, n_bins, dev)
        y_d, tw_d, vw_d = (torch.from_numpy(a.astype(np.float32)).to(dev)
                           for a in (y64, wt, wv))
        cat_np = np.zeros(c, bool) if cat_mask is None \
            else np.asarray(cat_mask, bool)
        cat = torch.from_numpy(cat_np).to(dev)
        has_cat = bool(cat_np.any())

    trees: List[TreeArrays] = list(init_trees or [])
    if trees and init_scores is not None and len(init_scores) == n:
        # checkpointed per-row scores restore f byte-exact
        f = torch.from_numpy(np.asarray(init_scores, np.float32)).to(dev)
    else:
        f = torch.full((n,), init_score, dtype=torch.float32, device=dev)
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
                                         cat, settings, n_bins, imp, has_cat)
            packed = packed.cpu().numpy()                # the chunk's copy
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
                              None if stopped else f.cpu().numpy())
    return ForestResult(
        trees=trees,
        spec_kwargs={"algorithm": "GBT", "loss": settings.loss,
                     "learning_rate": settings.learning_rate,
                     "init_score": init_score},
        train_error=history[-1][0] if history else float("nan"),
        valid_error=history[-1][1] if history else float("nan"),
        feature_importance=fi, trees_built=len(trees), history=history)


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
              device) -> torch.Tensor:
    """[T, n] f32 row weights of the RF trees ``tree_ids``: the Poisson
    draw of ``fold_in(PRNGKey(seed), tree)`` at ``baggingSampleRate``
    (reference ``jax.random.poisson``), or ones for a DT.  The only host
    syncs of a chunk happen here, before its growth."""
    if not settings.poisson_bagging:
        return torch.ones((len(tree_ids), n), dtype=torch.float32,
                          device=device)
    base = prng.prng_key(settings.seed)
    return prng.poisson([prng.fold_in(base, t) for t in tree_ids],
                        settings.bagging_rate, n, device)


def _rf_stats_from_bag(y, w, bag):
    """Per-row stat channels [..., N, 2] ``[w * bag, w * bag * y]`` of one
    bag [N] or a batch of bags [TB, N] — the one place the layout lives."""
    bw = w * bag
    return torch.stack([bw, bw * y], dim=-1).float()


def _rf_oob_update(pred, y, w, bag, oob_sum, oob_cnt, loss: str):
    """Out-of-bag vote accumulation and loss-consistent errors for ONE
    grown tree (reference ``_rf_oob_update``, binary path): the tree's
    rows outside its bag vote; validation scores every row with a vote on
    the mean of its votes, training scores the tree on every row.
    Returns (oob_sum, oob_cnt, train_err, valid_err)."""
    oob = (bag == 0) & (w > 0)
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
    tr = (per_t * w).sum() / w.sum().clamp_min(1e-9)
    return oob_sum, oob_cnt, tr, va


def rf_forest_chunk(bins, y, w, bags, oob_sum, oob_cnt, fa_all, cat,
                    settings: DTSettings, n_bins: int, has_cat: bool,
                    tree_batch: int):
    """A chunk of RF trees on the device with no host sync: ``bags`` [T,
    N] and ``fa_all`` [T, C] per tree.  Whole batches of ``tree_batch``
    trees grow through :func:`grow_forest` (one B2 launch a level), the
    remainder one by one through :func:`grow_tree` (B1); out-of-bag votes
    chain through every tree in tree order, so the result is the same
    bits whatever the batch.  Returns (oob_sum, oob_cnt, packed [T, L]
    uint8)."""
    t_total = fa_all.shape[0]
    tb = max(1, tree_batch)
    main = (t_total // tb) * tb if tb > 1 else 0
    kw = dict(n_bins=n_bins, depth=settings.depth,
              impurity=settings.impurity,
              min_instances=settings.min_instances,
              min_gain=settings.min_gain, max_leaves=settings.max_leaves,
              has_cat=has_cat)

    def grown():
        for g0 in range(0, main, tb):
            yield from grow_forest(
                bins, _rf_stats_from_bag(y, w, bags[g0:g0 + tb]), cat,
                fa_all[g0:g0 + tb], **kw)
        for j in range(main, t_total):
            yield grow_tree(bins, _rf_stats_from_bag(y, w, bags[j]), cat,
                            fa_all[j], **kw)

    rows = []
    for j, (sf, lm, lv, gfi, leaf_glob) in enumerate(grown()):
        oob_sum, oob_cnt, tr, va = _rf_oob_update(
            lv[leaf_glob.long()], y, w, bags[j], oob_sum, oob_cnt,
            settings.loss)
        rows.append(_pack_tree(sf, lm, lv, gfi, tr, va))
    return oob_sum, oob_cnt, torch.stack(rows)


def _rf_replay(trees: List[TreeArrays], bins_d, w_d, settings: DTSettings,
               oob_sum, oob_cnt):
    """Resume: rebuild the out-of-bag state by walking the restored trees
    through B4 with their re-drawn bags, RF_TREE_BATCH trees at a time, in
    tree order (the reference walks them with ``predict_tree``; routing
    is integer and the leaf one select, so the votes are the same
    bits)."""
    for g0 in range(0, len(trees), RF_TREE_BATCH):
        group = trees[g0:g0 + RF_TREE_BATCH]
        bags = draw_bags(settings, range(g0, g0 + len(group)),
                         bins_d.shape[0], bins_d.device)
        for j, pred in enumerate(_walk(group, bins_d)):
            oob = (bags[j] == 0) & (w_d > 0)
            oob_sum = oob_sum + torch.where(oob, pred, 0.0)
            oob_cnt = oob_cnt + oob.to(oob_cnt.dtype)
    return oob_sum, oob_cnt


def train_rf(bins, y, w, n_bins: int, cat_mask, settings: DTSettings,
             progress=None, checkpoint_fn: Optional[Callable] = None,
             init_trees: Optional[List[TreeArrays]] = None,
             start_history: Optional[List] = None,
             device: Optional[torch.device] = None,
             phase: Optional[Callable[[str], ContextManager]] = None,
             ) -> ForestResult:
    """Independent Poisson-bagged trees (``poisson_bagging`` off: one
    plain DT) over the resident plane ``bins`` [N, C] on ``device``;
    out-of-bag rows score validation with the configured loss.  The chunk
    rules and ``phase`` parts are :func:`train_gbt`'s; ``train/replay``
    rebuilds a resumed forest's out-of-bag votes."""
    dev = torch.device(device if device is not None else "cuda")
    phase = phase or (lambda name: contextlib.nullcontext())
    n, c = bins.shape
    with phase("train/upload"):
        bins_d = put_bins(bins, n_bins, dev)
        y_d, w_d = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                    for a in (y, w))
        cat_np = np.zeros(c, bool) if cat_mask is None \
            else np.asarray(cat_mask, bool)
        cat = torch.from_numpy(cat_np).to(dev)
        has_cat = bool(cat_np.any())
    oob_sum = torch.zeros(n, dtype=torch.float32, device=dev)
    oob_cnt = torch.zeros(n, dtype=torch.float32, device=dev)
    trees: List[TreeArrays] = list(init_trees or [])
    history: List[Tuple[float, float]] = list(start_history or [])
    if trees:
        with phase("train/replay"):
            oob_sum, oob_cnt = _rf_replay(trees, bins_d, w_d, settings,
                                          oob_sum, oob_cnt)
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
            bags = draw_bags(settings, ids, n, dev)
            oob_sum, oob_cnt, packed = rf_forest_chunk(
                bins_d, y_d, w_d, bags, oob_sum, oob_cnt, fa_all, cat,
                settings, n_bins, has_cat, tree_batch)
            packed = packed.cpu().numpy()                # the chunk's copy
        for j, row in enumerate(packed):
            tree, gfi, tr_err, va_err = _unpack_tree(
                row, total, n_bins, c, settings.depth)
            trees.append(tree)
            fi += gfi
            history.append((tr_err, va_err))
            if progress:
                progress(ti + j, tr_err, va_err)
        ti += chunk
        if ckpt:
            with phase("train/checkpoint"):
                checkpoint_fn(trees, history, None)
    return ForestResult(
        trees=trees, spec_kwargs={"algorithm": "RF"},
        train_error=history[-1][0] if history else float("nan"),
        valid_error=history[-1][1] if history else float("nan"),
        feature_importance=fi, trees_built=len(trees), history=history)


# ----------------------------------------------------------------- entry
def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to shifu_tpu_torch (ROADMAP Queue 1 "
        f"{item}) — train it with shifu_tpu")


def run_tree_training(proc) -> int:
    """Entry called by TrainProcessor for tree algorithms: the resident,
    single-member GBT, RF or DT."""
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
    params = proc._trials(dict(mc.train.params or {}))[0]
    kind = "gbt" if alg == Algorithm.GBT else "rf"
    if mc.train.isCrossValidation and mc.train.numKFold > 1:
        raise _not_ported(f"{alg.name} k-fold training", "item 6")
    if max(1, mc.train.baggingNum) > 1:
        raise _not_ported(f"bagged {alg.name} (_{kind}_forest_multi)",
                          "item 6")
    from ..config.validator import is_multi_class
    if is_multi_class(mc) and len(mc.dataSet.posTags) > 2:
        raise _not_ported(f"one-vs-all or native multi-class {alg.name}",
                          "item 6")
    if proc._use_streaming(shards, shards.schema):
        raise _not_ported(f"streamed (out-of-core) {alg.name} training "
                          f"(train_{kind}_streamed); this plane is over "
                          "shifu.train.memoryBudgetBytes", "item 8")
    settings = settings_from_params(params, mc.train, alg)
    settings.resume = bool(proc.params.get("resume"))
    settings.stats_exact = not mc.dataSet.weightColumnName
    ckpt_fn = _forest_checkpoint_fn(proc, settings, alg, n_bins, col_nums,
                                    shards)

    with open(proc.paths.progress_path, "w") as pf:
        def progress(ti, tr, va):
            line = (f"Tree #{ti + 1} Train Error: {tr:.6f} "
                    f"Validation Error: {va:.6f}")
            pf.write(line + "\n")
            pf.flush()
            if (ti + 1) % 5 == 0 or ti == 0:
                log.info(line)

        init_trees, init_score, start_history, init_scores = \
            _restore_or_continuous(proc, alg, settings)
        if init_scores is not None and len(init_scores) != shards.num_rows:
            log.info("checkpoint scores cover %d rows, plane has %d — "
                     "replaying restored trees instead",
                     len(init_scores), shards.num_rows)
            init_scores = None
        with proc.phase("load_data"):
            data = shards.load_all()
        bins, y, w = data["bins"], data["y"], data["w"]
        log.info("train %s on %s: %d rows x %d features, %d bins, %d trees "
                 "depth %d", alg.name, proc.device, *bins.shape, n_bins,
                 settings.n_trees, settings.depth)
        with proc.phase("train"):
            if alg == Algorithm.GBT:
                res = train_gbt(bins, y, w, n_bins, cat_mask, settings,
                                progress, init_trees=init_trees,
                                init_score=init_score, checkpoint_fn=ckpt_fn,
                                start_history=start_history,
                                init_scores=init_scores, device=proc.device,
                                phase=proc.phase)
            else:
                res = train_rf(bins, y, w, n_bins, cat_mask, settings,
                               progress, checkpoint_fn=ckpt_fn,
                               init_trees=init_trees,
                               start_history=start_history,
                               device=proc.device, phase=proc.phase)
                res.spec_kwargs["algorithm"] = alg.name

    with proc.phase("save_model"):
        spec = tree_model.TreeModelSpec(
            n_trees=len(res.trees), depth=settings.depth, n_bins=n_bins,
            column_nums=list(col_nums),
            feature_names=shards.schema.get("columnNames"),
            **res.spec_kwargs)
        os.makedirs(proc.paths.models_dir, exist_ok=True)
        for f in os.listdir(proc.paths.models_dir):
            if f.startswith("model"):
                os.remove(os.path.join(proc.paths.models_dir, f))
        tree_model.save_model(proc.paths.model_path(0, alg.name.lower()),
                              spec, res.trees)
        names = shards.schema.get("columnNames",
                                  [str(cn) for cn in col_nums])
        fi_named = sorted(((names[j], float(v)) for j, v in
                           enumerate(res.feature_importance)),
                          key=lambda kv: -kv[1])
        ioutil.atomic_write_json(
            os.path.join(proc.paths.tmp_dir, "feature_importance.json"),
            dict(fi_named))
    log.info("train %s done: %d trees, train err %.6f valid err %.6f; "
             "top features %s", alg.name, res.trees_built, res.train_error,
             res.valid_error, [k for k, _ in fi_named[:5]])
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


def _restore_or_continuous(proc, alg, settings: DTSettings):
    """Resume order: ``train -resume`` from the mid-forest checkpoint,
    else continuous training from the final saved model.  Returns (trees,
    init_score, history, scores)."""
    if settings.resume:
        path = _forest_checkpoint_path(proc)
        if os.path.isfile(path):
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
            log.info("resume: restored %d trees from forest checkpoint%s",
                     len(trees),
                     " (+ per-row scores)" if scores is not None else "")
            return trees, spec.init_score, history, scores
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
