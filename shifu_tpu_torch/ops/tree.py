"""Decision-tree ops — the port of ``shifu_tpu.ops.tree``'s resident
growth path: the histogram build (kernel B1, :func:`build_histograms`) and
its tree-batched form (kernel B2, :func:`build_histograms_batch`), the
split-gain scan (:func:`best_splits`: variance, Friedman MSE, entropy,
gini, and multi-class entropy/gini over per-class channels), the leaf-wise
node budget, and whole-tree level-wise growth with histogram subtraction,
one tree at a time (:func:`grow_tree`, GBT) or a batch of independent
trees one level at a time (:func:`grow_forest`: the Random Forest's tree
batch, the members of a bagged or grid-searched GBT).  Forests are walked
by ``ops.tree_quant`` (kernel B4; :func:`predict_forest` groups a forest
by depth for it).

The out-of-core trainers add three pieces: :func:`build_path_histograms`
(every level's left-child histograms along a fixed structure in one B2
launch over one window, TB = depth trees sharing one stats plane),
:func:`node_index_at_level` and :func:`predict_tree` (a window's rows
routed through a partial or a finished tree by plain gathers), and
:func:`grow_tree`'s ``record_hists`` / ``tail_extra`` options (the
coarse-to-fine tail's resident head).

Trees are complete binary arrays (node i's children at 2i+1 / 2i+2):
``split_feat[node]`` (-1 = leaf), a per-bin ``left_mask`` (numeric and
categorical splits alike: "bin in the left set") and ``leaf_value`` ([nodes],
or [nodes, K] class distributions for a native multi-class forest).

Everything here is eager PyTorch on the device of its inputs, with no
host sync: a grown tree stays on the device until its caller copies it.
Where a reduction order would change from run to run on the card (float
atomics), the port sums deterministically instead: B1 and B2 in exact
integer sums (leaf sums too, through B1), feature-importance gains as a
plain reduction — so a resumed forest is bit-identical to an
uninterrupted one.
Ties break as in the reference: stable argsorts, first-maximum argmaxes.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from ..parallel.mesh import data_sharded

EPS = 1e-12


@dataclass
class TreeArrays:
    """Complete binary tree, node i's children at 2i+1 / 2i+2."""
    split_feat: np.ndarray   # [nodes] int32, -1 = leaf
    left_mask: np.ndarray    # [nodes, n_bins] bool: bin goes left
    leaf_value: np.ndarray   # [nodes] (or [nodes, K]) float32
    depth: int

    @property
    def n_nodes(self) -> int:
        return len(self.split_feat)


def n_tree_nodes(depth: int) -> int:
    return (1 << (depth + 1)) - 1


# ------------------------------------------------------------- histograms
def build_histograms(bins, node_idx, stats, n_nodes: int,
                     n_bins: int, mesh=None) -> torch.Tensor:
    """Per-row stats into (node, feature, bin) cells: [n_nodes, C, n_bins,
    S] f32.  bins [N, C] integer (uint8/int32 as they are, uint16 widened
    on its device), node_idx [N] int32 level-local (-1 = inactive), stats
    [N, S] f32.  CUDA tensors launch kernel B1 (``csrc/hist.cu``) or
    raise; CPU tensors take the plain version.  On a ``mesh`` whose data
    axis splits the rows, each rank passes its block and every rank gets
    the histogram of all the rows (``hist.build_histograms_sharded``: the
    kernel's raw mode, or the fixed-point plain version on the CPU, and
    one all_reduce).  ``launches`` counts kernel launches only."""
    from . import hist
    bins = hist.widen_bins(bins)
    if bins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"build_histograms: no kernel for device "
                         f"{bins.device}")
    if data_sharded(mesh):
        out = hist.build_histograms_sharded(bins, node_idx, stats, n_nodes,
                                            n_bins, mesh)
        if bins.is_cuda:
            build_histograms.launches += 1
    elif bins.device.type == "cpu":
        out = hist.build_histograms_ref(bins, node_idx, stats, n_nodes,
                                        n_bins)
    else:
        out = hist.build_histograms_cuda(bins, node_idx, stats, n_nodes,
                                         n_bins)
        build_histograms.launches += 1
    hist.record_hist_cost(bins, stats, n_nodes, n_bins)
    return out


build_histograms.launches = 0


def build_histograms_batch(bins, node_idx_b, stats_b, n_nodes: int,
                           n_bins: int, mesh=None) -> torch.Tensor:
    """Tree-batched :func:`build_histograms`: TB trees' level histograms
    over one shared bin plane, [TB, n_nodes, C, n_bins, S] f32.
    node_idx_b [TB, N] int32, stats_b [TB, N, S] f32; each tree's slice
    equals a :func:`build_histograms` call on that tree's inputs bit for
    bit.  CUDA tensors launch kernel B2 (``csrc/hist.cu`` for TB trees) or
    raise; CPU tensors take the plain version; a ``mesh`` as in
    :func:`build_histograms` (``hist.build_histograms_batch_sharded``).
    ``launches`` counts kernel launches only."""
    from . import hist
    bins = hist.widen_bins(bins)
    if bins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"build_histograms_batch: no kernel for device "
                         f"{bins.device}")
    if data_sharded(mesh):
        out = hist.build_histograms_batch_sharded(bins, node_idx_b, stats_b,
                                                  n_nodes, n_bins, mesh)
        if bins.is_cuda:
            build_histograms_batch.launches += 1
    elif bins.device.type == "cpu":
        out = hist.build_histograms_batch_ref(bins, node_idx_b, stats_b,
                                              n_nodes, n_bins)
    else:
        out = hist.build_histograms_batch_cuda(bins, node_idx_b, stats_b,
                                               n_nodes, n_bins)
        build_histograms_batch.launches += 1
    hist.record_hist_cost(bins, stats_b[0], n_nodes, n_bins,
                          n_trees=int(stats_b.shape[0]))
    return out


build_histograms_batch.launches = 0


# ------------------------------------------------------------- split scan
def _impurity_score(w, wy, kind: str):
    """Per-partition purity score; gain = score_L + score_R - score_P
    (reference ``_impurity_score``).  variance is sum^2 / weight; entropy
    and gini use the binary class weights pos = wy, neg = w - wy."""
    if kind == "variance":
        return wy * wy / w.clamp_min(EPS)
    pos = wy.clamp_min(0.0)
    neg = (w - wy).clamp_min(0.0)
    tot = (pos + neg).clamp_min(EPS)
    p = pos / tot
    if kind == "entropy":
        h = -(torch.where(p > 0, p * torch.log2(p.clamp_min(EPS)), 0.0)
              + torch.where(1 - p > 0,
                            (1 - p) * torch.log2((1 - p).clamp_min(EPS)),
                            0.0))
        return -tot * h
    if kind == "gini":
        return -tot * 2.0 * p * (1 - p)
    raise ValueError(f"unknown impurity {kind!r}")


def _class_score(cnt, kind: str):
    """Multi-class purity score from per-class weight counts ``cnt``
    [..., K]; gain = score_L + score_R - score_P (reference
    ``_class_score``, multiclass Entropy/Gini of ``dt/Impurity.java``)."""
    tot = cnt.sum(-1).clamp_min(EPS)
    p = cnt.clamp_min(0.0) / tot[..., None]
    if kind == "entropy":
        h = -torch.where(p > 0, p * torch.log2(p.clamp_min(EPS)),
                         0.0).sum(-1)
        return -tot * h
    if kind == "gini":
        return -tot * (1.0 - (p * p).sum(-1))
    raise ValueError(f"multi-class impurity must be entropy/gini, "
                     f"got {kind!r}")


def best_splits(hist, cat_mask, feat_active, impurity: str = "variance",
                min_instances: float = 1.0, min_gain: float = 0.0,
                has_cat: bool = True, n_classes: int = 0):
    """Best split per node from the level histogram hist [nodes, C, B, 2]
    (w, wy) — or, when ``n_classes > 2``, [nodes, C, B, K] per-class weight
    counts (native multi-class).  cat_mask [C] bool (categorical bins sort
    by response before the prefix scan: the positive rate, or the mean
    class index for K classes), feat_active [C] bool (feature subset).
    ``impurity`` is ``variance`` or ``friedmanmse`` (GBT) or ``entropy``
    or ``gini`` (RF/DT).

    Returns (gain [nodes], feat [nodes] int32, left_mask [nodes, B] bool,
    leaf_value [nodes] (or [nodes, K] class distributions), node_w
    [nodes]).  ``has_cat=False`` (the caller knows its mask has no
    categorical column) skips the sort."""
    multiclass = n_classes > 2
    if multiclass:
        cls = hist
        w = cls.sum(-1)
        # the categorical sort's response: the mean class index
        wy = (cls * torch.arange(n_classes, dtype=hist.dtype,
                                 device=hist.device)).sum(-1) \
            if has_cat else w
    else:
        w, wy = hist[..., 0], hist[..., 1]
    n_nodes, c, b = w.shape
    dev = hist.device
    if has_cat:
        nat = torch.arange(b, device=dev).expand(n_nodes, c, b)
        rate = wy / w.clamp_min(EPS)
        sort_key = torch.where(w > 0, -rate, float("inf"))
        cat_order = torch.argsort(sort_key, dim=-1, stable=True)
        order = torch.where(cat_mask[None, :, None], cat_order, nat)
        w_o = w.gather(-1, order)
        wy_o = wy.gather(-1, order)
    else:
        w_o, wy_o = w, wy

    cw = torch.cumsum(w_o, dim=-1)
    cwy = torch.cumsum(wy_o, dim=-1)
    tw, twy = cw[..., -1:], cwy[..., -1:]
    if multiclass:
        cls_o = cls.gather(2, order[..., None].expand(-1, -1, -1, n_classes)) \
            if has_cat else cls
        ccls = torch.cumsum(cls_o, dim=2)
        tcls = ccls[:, :, -1:, :]
        gain = (_class_score(ccls, impurity)
                + _class_score(tcls - ccls, impurity)
                - _class_score(tcls, impurity))
    elif impurity == "friedmanmse":
        # Friedman's improvement (reference dt/Impurity.java:313-315)
        wl, wr = cw, tw - cw
        diff = wr * cwy - wl * (twy - cwy)
        gain = diff * diff / (wl * wr * (wl + wr)).clamp_min(EPS)
    else:
        gain = (_impurity_score(cw, cwy, impurity)
                + _impurity_score(tw - cw, twy - cwy, impurity)
                - _impurity_score(tw, twy, impurity))

    valid = (cw >= min_instances) & (tw - cw >= min_instances)
    valid = valid & feat_active[None, :, None]
    valid[..., -1] = False                                 # no split
    gain = torch.where(valid, gain, float("-inf"))

    best_k = gain.argmax(dim=-1)                           # [nodes, C]
    best_gain_f = gain.gather(-1, best_k[..., None])[..., 0]
    best_feat = best_gain_f.argmax(dim=-1)                 # [nodes]
    node_gain = best_gain_f.gather(-1, best_feat[:, None])[:, 0]

    k_sel = best_k.gather(-1, best_feat[:, None])          # [nodes, 1]
    if has_cat:
        order_sel = order.gather(
            1, best_feat[:, None, None].expand(n_nodes, 1, b))[:, 0]
        ranks = torch.argsort(order_sel, dim=-1, stable=True)
        left_mask = ranks <= k_sel
    else:
        left_mask = torch.arange(b, device=dev)[None, :] <= k_sel

    node_w = tw[:, 0, 0]
    if multiclass:
        leaf_value = tcls[:, 0, 0, :] / node_w.clamp_min(EPS)[:, None]
    else:
        leaf_value = twy[:, 0, 0] / node_w.clamp_min(EPS)
    ok = torch.isfinite(node_gain) & (node_gain > min_gain)
    feat = torch.where(ok, best_feat, -1).to(torch.int32)
    return node_gain, feat, left_mask & ok[:, None], leaf_value, node_w


def cap_splits_by_leaves(gain, feat, lmask, nodes_cnt, max_leaves: int):
    """Leaf-wise node budget (reference ``DTMaster.java:543-560``):
    candidate splits rank by gain and take the remaining budget in that
    order, the rest freeze to leaves.  ``nodes_cnt`` is a device int32
    scalar starting at 1.  Returns (feat, lmask, new nodes_cnt)."""
    cand = feat >= 0
    key = torch.where(cand, -gain, float("inf"))
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    budget = ((max_leaves - nodes_cnt + 1) // 2).clamp_min(0)
    allow = cand & (rank < budget)
    return (torch.where(allow, feat, -1), lmask & allow[:, None],
            nodes_cnt + 2 * allow.sum().to(nodes_cnt.dtype))


# ------------------------------------------------------------------ grow
def _level_select(bins, node, feat, lmask):
    """One level's gathers for clamped node ids [N]: (node_feat [N],
    goes_left [N]) — the reference's gather form."""
    node = node.long()
    node_feat = feat[node]
    row_bin = bins.gather(1, node_feat.clamp_min(0).long()[:, None])[:, 0]
    return node_feat, lmask[node, row_bin.long()]


def _descend(bins, node_idx, feat, lmask):
    """Rows whose node split move to a child's level-local index; rows at
    leaves freeze at -1."""
    node_feat, goes_left = _level_select(bins, node_idx.clamp_min(0), feat,
                                         lmask)
    active = (node_idx >= 0) & (node_feat >= 0)
    return torch.where(active, 2 * node_idx + torch.where(goes_left, 0, 1),
                       -1).to(torch.int32)


def _left_child_index(node_idx):
    """Level-local LEFT-child selector for histogram subtraction: a row in
    left child 2p maps to parent slot p; right-child and frozen rows map to
    -1."""
    return torch.where((node_idx >= 0) & (node_idx % 2 == 0),
                       node_idx // 2, -1).to(torch.int32)


#: rows x nodes per one-hot block of the plain leaf-sum matmul
_LEAF_BLOCK = 1 << 24


def _level_leaf_raw(stats, node_idx, n_nodes: int, mesh=None):
    """Per-node raw stat sums [S, K] f32 (frozen rows contribute nothing).
    On the card: kernel B1 over one all-zero column of one bin, which
    sums each node's rows in O(N) into the f32 rounding of an exact
    (order-free) sum.  On the CPU, the plain version: a float64 one-hot
    matmul over row blocks, added in a fixed order.  Both are
    deterministic; they agree exactly for integer stats and within one
    f32 ulp otherwise.  On a ``mesh`` whose data axis splits the rows, the
    sums of every rank's rows through the sharded histogram on either
    device."""
    n, s = stats.shape
    dev = stats.device
    if dev.type == "cuda" or data_sharded(mesh):
        return _leaf_raw_hist(stats, node_idx, n_nodes, mesh)
    ids = torch.arange(n_nodes, device=dev, dtype=node_idx.dtype)
    out = torch.zeros((s, n_nodes), dtype=torch.float64, device=dev)
    step = max(1, _LEAF_BLOCK // max(n_nodes, 1))
    for r0 in range(0, n, step):
        oh = (node_idx[r0:r0 + step, None] == ids[None, :]).double()
        out = out + stats[r0:r0 + step].double().T @ oh
    return out.float()


def _leaf_raw_hist(stats, node_idx, n_nodes: int, mesh=None):
    """[S, K] leaf sums as the histogram of one all-zero column of one
    bin — :func:`_level_leaf_raw`'s card path (B1 on CUDA tensors) and
    its mesh path.  ``launches`` counts its B1 launches (also in
    ``build_histograms.launches``)."""
    zero = torch.zeros((stats.shape[0], 1), dtype=torch.uint8,
                       device=stats.device)
    out = build_histograms(zero, node_idx, stats, n_nodes, 1,
                           mesh)[:, 0, 0].T
    if stats.is_cuda:
        _leaf_raw_hist.launches += 1
    return out


_leaf_raw_hist.launches = 0


def leaf_values_from_raw(sums, n_classes: int = 0):
    """[S, K] raw stat sums -> leaf values: [K] ``wy / w``, or [K, S]
    class distributions when ``n_classes > 2`` (reference
    ``leaf_values_from_raw``)."""
    if n_classes > 2:
        return (sums / sums.sum(dim=0).clamp_min(EPS)[None, :]).T
    return sums[1] / sums[0].clamp_min(EPS)


def grow_tree(bins, stats, cat, fa, n_bins: int, depth: int,
              impurity: str, min_instances: float, min_gain: float,
              max_leaves: int = 0, has_cat: bool = True,
              n_classes: int = 0, record_hists: bool = False,
              tail_extra=None, prev_sf=None, prev_lm=None,
              valid_upto: int = 0, mesh=None):
    """Whole-tree level-wise growth (the resident path of the reference's
    ``grow_tree_jit``) on the device of ``bins``, with no host sync.

    bins [N, C] (uint8 or int32), stats [N, 2] f32 ``[w, w*grad]`` (or
    [N, K] per-class weights when ``n_classes > 2``), cat [C] bool, fa [C]
    bool.  Level l < depth builds only the LEFT-child
    histogram (K = 2^(l-1); the full root at level 0) and derives each
    right child as parent - left, zero under a frozen parent: a depth-d
    tree launches B1 d times.  The bottom level needs leaf sums only
    (:func:`_level_leaf_raw`: one more B1 launch on the card).

    Returns (split_feat [total] int32, left_mask [total, B] bool,
    leaf_value [total] (or [total, K]) f32, gain_fi [C] f32 realized split
    gains per feature, leaf_glob [N] int32 terminal node per row).

    ``record_hists`` also returns (hist_left [depth, 2^(depth-1), C, B,
    S], leaf_raw [S, 2^depth]): each level's LEFT-child histograms (level
    0 the full root), zero-padded to one slot width, and the bottom
    level's raw sums, in :func:`build_path_histograms`'s layout, so the
    coarse-to-fine tail adds resident and tail parts cell for cell.

    ``tail_extra`` ([depth, 2^(depth-1), C, B, S], with ``prev_sf`` /
    ``prev_lm``, the previous tree, and the host int ``valid_upto``) is
    stale tail evidence for the split DECISIONS only: the previous
    coarse-to-fine pass's tail-only left-child histograms.  Level l
    decides on resident + evidence when l <= ``valid_upto`` (the previous
    pass confirmed its routing that deep) and this tree's splits above l
    equal the previous tree's (a device flag, no host sync); the evidence
    never enters the recorded histograms or the subtraction chain.

    On a ``mesh`` whose data axis splits the rows, ``bins`` and ``stats``
    are this rank's block: every histogram and leaf sum covers all the
    ranks' rows (:func:`build_histograms`), so every rank grows the same
    tree, and ``leaf_glob`` is its own rows'."""
    def level_hists(node_idx, n_nodes):
        return [build_histograms(bins, node_idx[0], stats, n_nodes, n_bins,
                                 mesh)]
    out = _grow(bins, [stats], cat, [fa], n_bins, depth, impurity,
                [min_instances], [min_gain], max_leaves, has_cat,
                level_hists, n_classes, record_hists=record_hists,
                tail_extra=tail_extra, prev_sf=prev_sf, prev_lm=prev_lm,
                valid_upto=valid_upto, mesh=mesh)
    return out[0][0] + out[1] if record_hists else out[0]


def grow_forest(bins, stats_b, cat, fa_b, n_bins: int, depth: int,
                impurity: str, min_instances, min_gain,
                max_leaves: int = 0, has_cat: bool = True,
                n_classes: int = 0, mesh=None):
    """TB independent trees grown level-wise together — the port of the
    reference's ``grow_forest_jit`` (the Random Forest's tree batch) and
    of its vmapped member axis (the trees of one round of a bagged or
    grid-searched GBT).

    stats_b [TB, N, S] per-tree channels (each tree's bag or gradients),
    fa_b [TB, C] per-tree feature subsets; ``min_instances`` and
    ``min_gain`` are one value for every tree or a sequence of TB;
    ``bins`` and ``cat`` are shared.  Each
    level's TB histograms build in ONE launch of kernel B2
    (:func:`build_histograms_batch`), which reads the shared bins once
    for a tile of trees; histogram subtraction, the leaf-sum bottom level
    and ``max_leaves`` apply per tree exactly as in :func:`grow_tree`, so
    every tree's outputs are bit-identical to a :func:`grow_tree` call on
    its inputs; a ``mesh`` as in :func:`grow_tree`.  Returns a list of TB
    :func:`grow_tree` tuples."""
    def level_hists(node_idx, n_nodes):
        return list(build_histograms_batch(bins, torch.stack(node_idx),
                                           stats_b, n_nodes, n_bins,
                                           mesh).unbind(0))
    tb = stats_b.shape[0]

    def per_tree(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * tb
    return _grow(bins, list(stats_b.unbind(0)), cat, list(fa_b.unbind(0)),
                 n_bins, depth, impurity, per_tree(min_instances),
                 per_tree(min_gain), max_leaves, has_cat, level_hists,
                 n_classes, mesh=mesh)


def _subtract(hls, hist_prev, feat_prev):
    """Histogram subtraction: each tree's full level histogram [K, C, B, S]
    from its left children ``hls[t]`` [K/2, ...] and its previous level's
    full histogram, each right child being parent - left (zero under a
    frozen parent).  Drops each previous histogram as it goes, so a batch
    holds one level's histograms at a time."""
    hists = []
    for t, hl in enumerate(hls):
        hr = torch.where((feat_prev[t] >= 0)[:, None, None, None],
                         hist_prev[t] - hl, 0.0)
        hists.append(torch.stack([hl, hr], dim=1).reshape(
            2 * hl.shape[0], *hl.shape[1:]))
        hist_prev[t] = None
    return hists


def level_gain_fi(gain, feat, c: int):
    """A level's realized split gains per column [C] f32 (a plain
    reduction, deterministic on the card)."""
    realized = torch.where(feat >= 0, gain.clamp_min(0.0), 0.0).float()
    ids = torch.arange(c, device=feat.device)
    return torch.where(feat.long()[:, None] == ids[None, :],
                       realized[:, None], 0.0).sum(dim=0)


def _pad_nodes(hist, width: int):
    """Zero-pad a level histogram's node axis to ``width``, so every level
    shares one accumulator slot shape."""
    k = hist.shape[0]
    if k >= width:
        return hist
    return torch.cat([hist, hist.new_zeros((width - k,) + hist.shape[1:])])


def _grow(bins, stats, cat, fa, n_bins: int, depth: int, impurity: str,
          min_instances, min_gain, max_leaves: int, has_cat: bool,
          level_hists, n_classes: int = 0, record_hists: bool = False,
          tail_extra=None, prev_sf=None, prev_lm=None, valid_upto: int = 0,
          mesh=None):
    """The level loop of :func:`grow_tree` and :func:`grow_forest` for
    trees t with ``stats[t]``, ``fa[t]``, ``min_instances[t]`` and
    ``min_gain[t]``; ``level_hists(node_idx,
    K)`` builds every tree's [K, C, B, S] histogram of one level from the
    per-tree node ids.  Each tree runs the same per-tree ops in the same
    order whatever the batch, which is what makes a batched tree equal a
    sequential one bit for bit.  ``record_hists`` and ``tail_extra`` (one
    tree only) are :func:`grow_tree`'s; with ``record_hists`` the result
    is (the per-tree list, (hist_left, leaf_raw))."""
    n, c = bins.shape
    dev = bins.device
    tb = len(stats)
    stale = tail_extra is not None
    assert tb == 1 or not (record_hists or stale)
    half = max(1 << max(depth - 1, 0), 1)
    rec_left: list = []
    leaf_raw = None
    prefix_ok = torch.ones((), dtype=torch.bool, device=dev)
    tail_full = None
    feats = [[] for _ in range(tb)]
    lmasks = [[] for _ in range(tb)]
    leaves = [[] for _ in range(tb)]
    gain_fi = [torch.zeros(c, dtype=torch.float32, device=dev)
               for _ in range(tb)]
    node_idx = [torch.zeros(n, dtype=torch.int32, device=dev)
                for _ in range(tb)]
    leaf_glob = [torch.zeros(n, dtype=torch.int32, device=dev)
                 for _ in range(tb)]
    nodes_cnt = [torch.ones((), dtype=torch.int32, device=dev)
                 for _ in range(tb)]
    hist_prev = feat_prev = None
    for level in range(depth + 1):
        n_nodes = 1 << level
        if level == depth:
            for t in range(tb):
                leaf_raw = _level_leaf_raw(stats[t], node_idx[t], n_nodes,
                                           mesh)
                leaves[t].append(leaf_values_from_raw(leaf_raw, n_classes))
                feats[t].append(torch.full((n_nodes,), -1, dtype=torch.int32,
                                           device=dev))
                lmasks[t].append(torch.zeros((n_nodes, n_bins),
                                             dtype=torch.bool, device=dev))
            break
        if level == 0:
            hists = level_hists(node_idx, 1)
            if record_hists:
                rec_left.append(_pad_nodes(hists[0], half))
            decide = hists
            if stale:
                tail_full = tail_extra[0, :1]         # the tail root
                decide = [hists[0] + tail_full]
        else:
            hls = level_hists([_left_child_index(ni) for ni in node_idx],
                              n_nodes // 2)
            if record_hists:
                rec_left.append(_pad_nodes(hls[0], half))
            hists = decide = _subtract(hls, hist_prev, feat_prev)
            if stale:
                # the tail's full level, derived along the PREVIOUS tree
                tail_full = _subtract(
                    [tail_extra[level, :n_nodes // 2]], [tail_full],
                    [prev_sf[n_nodes // 2 - 1:n_nodes - 1]])[0]
                if level <= valid_upto:
                    decide = [torch.where(prefix_ok, hists[0] + tail_full,
                                          hists[0])]
        hist_prev, feat_prev = hists, [None] * tb
        for t in range(tb):
            gain, feat, lmask, leaf, _ = best_splits(
                decide[t], cat, fa[t], impurity, min_instances[t],
                min_gain[t], has_cat, n_classes)
            if max_leaves > 0:
                feat, lmask, nodes_cnt[t] = cap_splits_by_leaves(
                    gain, feat, lmask, nodes_cnt[t], max_leaves)
            if stale:
                lo, hi = n_nodes - 1, 2 * n_nodes - 1
                prefix_ok = prefix_ok & (feat == prev_sf[lo:hi]).all() & \
                    (lmask == prev_lm[lo:hi]).all()
            feats[t].append(feat)
            lmasks[t].append(lmask)
            leaves[t].append(leaf)
            gain_fi[t] = gain_fi[t] + level_gain_fi(gain, feat, c)
            feat_prev[t] = feat
            node_idx[t] = _descend(bins, node_idx[t], feat, lmask)
            # rows that descended rest at their child's GLOBAL id; frozen
            # rows keep the node they stopped at
            leaf_glob[t] = torch.where(node_idx[t] >= 0,
                                       ((1 << (level + 1)) - 1)
                                       + node_idx[t], leaf_glob[t])
    out = [(torch.cat(feats[t]), torch.cat(lmasks[t]), torch.cat(leaves[t]),
            gain_fi[t], leaf_glob[t]) for t in range(tb)]
    if record_hists:
        return out, (torch.stack(rec_left), leaf_raw)
    return out


def node_index_at_level(split_feat, left_mask, bins, level: int):
    """Level-local node index [N] int32 of every row in a partial tree
    (levels above ``level`` decided); -1 where an ancestor froze.  The
    streamed trainers re-derive a window's row positions from the tree
    instead of keeping a per-row index resident."""
    node_idx = torch.zeros(bins.shape[0], dtype=torch.int32,
                           device=bins.device)
    for lv in range(level):
        base = (1 << lv) - 1
        node_idx = _descend(bins, node_idx, split_feat[base:base + (1 << lv)],
                            left_mask[base:base + (1 << lv)])
    return node_idx


def traverse_nodes(split_feat, left_mask, bins, depth: int):
    """Terminal global node id [N] int64 of every row after ``depth``
    descents (frozen rows stop at their leaf) — plain gathers."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(depth):
        feat, goes_left = _level_select(bins, node, split_feat, left_mask)
        node = torch.where(feat >= 0,
                           torch.where(goes_left, 2 * node + 1, 2 * node + 2),
                           node)
    return node


def predict_tree(split_feat, left_mask, leaf_value, bins, depth: int):
    """One tree's leaf value ([N], or [N, K]) for every row of ``bins`` —
    the streamed trainers' per-window score and vote updates."""
    return leaf_value[traverse_nodes(split_feat, left_mask, bins, depth)]


def build_path_histograms(bins, stats, split_feat, left_mask, depth: int,
                          n_bins: int, hist_bins=None):
    """Every level's histograms along a FIXED tree structure in one pass
    over a window — the coarse-to-fine disk tail's core op (reference
    ``build_path_histograms``).  Given a speculated structure, each
    level's routing is known up front, so ONE kernel B2 launch at TB =
    ``depth`` builds them all: level l's left-child histograms (level 0
    the full root), the trees sharing ``bins`` and one stats plane
    (broadcast to [depth, N, S]), plus the bottom level's raw leaf sums
    (B1 on the card, :func:`_level_leaf_raw`).

    Returns (hist_left [depth, 2^(depth-1), C, B, S], level l in the first
    ``max(2^(l-1), 1)`` node slots and zero past them, and leaf_raw [S,
    2^depth]): :func:`grow_tree`'s ``record_hists`` layout.  ``hist_bins``
    ([N, K], optional) narrows the histogram build to a candidate column
    subset while routing walks the full ``bins``."""
    assert depth >= 1
    half = max(1 << (depth - 1), 1)
    node_idx = torch.zeros(bins.shape[0], dtype=torch.int32,
                           device=bins.device)
    idx_levels = [node_idx]                    # level 0: the full root
    for level in range(1, depth + 1):
        base = (1 << (level - 1)) - 1
        width = 1 << (level - 1)
        node_idx = _descend(bins, node_idx, split_feat[base:base + width],
                            left_mask[base:base + width])
        if level < depth:
            idx_levels.append(_left_child_index(node_idx))
    # the kernel takes contiguous planes: one [depth, N, S] copy of the
    # shared stats (a strided broadcast would need the kernel to know it)
    stats_b = stats[None].expand(depth, *stats.shape).contiguous()
    hist_left = build_histograms_batch(
        bins if hist_bins is None else hist_bins, torch.stack(idx_levels),
        stats_b, half, n_bins)
    leaf_raw = _level_leaf_raw(stats, node_idx, 1 << depth)
    return hist_left, leaf_raw


# ---------------------------------------------------------------- predict
def forest_predictions(trees, bins) -> torch.Tensor:
    """[T, N] (or [T, N, K] for class-distribution leaves) per-tree
    predictions of host ``trees`` over the bin plane ``bins`` (uint8 or
    int32, on the device that walks it), one ``ops.tree_quant`` walk per
    depth group (continuous runs may append trees of another depth):
    kernel B4 for CUDA tensors, its plain version on the CPU."""
    from . import tree_quant as tq
    by_depth: dict = {}
    for i, t in enumerate(trees):
        by_depth.setdefault(t.depth, []).append(i)
    out = None
    for depth, idxs in by_depth.items():
        preds = tq.predict_forest_quant(*tq.stack_forest_quant(
            [trees[i] for i in idxs], bins.device), bins, depth)
        if out is None:
            out = preds.new_empty((len(trees),) + tuple(preds.shape[1:]))
        out[idxs] = preds
    return out


def predict_forest(trees, bins, weights=None) -> torch.Tensor:
    """Weighted-average forest prediction over ``bins`` (the RF mean
    vote; [N], or [N, K] for a multi-class forest) — reference
    ``predict_forest``, walked by :func:`forest_predictions`."""
    preds = forest_predictions(trees, bins)
    if weights is None:
        return preds.mean(dim=0)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=preds.device)
    return (preds * w.reshape((-1,) + (1,) * (preds.dim() - 1))).sum(dim=0)
