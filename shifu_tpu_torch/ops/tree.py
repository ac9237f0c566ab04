"""Decision-tree ops — the port of ``shifu_tpu.ops.tree``'s resident
growth path: the histogram build (kernel B1, :func:`build_histograms`) and
its tree-batched form (kernel B2, :func:`build_histograms_batch`), the
split-gain scan (:func:`best_splits`: variance, Friedman MSE, entropy,
gini), the leaf-wise node budget, and whole-tree level-wise growth with
histogram subtraction, one tree at a time (:func:`grow_tree`, GBT) or a
batch of independent trees one level at a time (:func:`grow_forest`,
Random Forest).  Forests are walked by ``ops.tree_quant`` (kernel B4).

Trees are complete binary arrays (node i's children at 2i+1 / 2i+2):
``split_feat[node]`` (-1 = leaf), a per-bin ``left_mask`` (numeric and
categorical splits alike: "bin in the left set") and ``leaf_value``.

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

EPS = 1e-12


@dataclass
class TreeArrays:
    """Complete binary tree, node i's children at 2i+1 / 2i+2."""
    split_feat: np.ndarray   # [nodes] int32, -1 = leaf
    left_mask: np.ndarray    # [nodes, n_bins] bool: bin goes left
    leaf_value: np.ndarray   # [nodes] float32
    depth: int

    @property
    def n_nodes(self) -> int:
        return len(self.split_feat)


def n_tree_nodes(depth: int) -> int:
    return (1 << (depth + 1)) - 1


# ------------------------------------------------------------- histograms
def build_histograms(bins, node_idx, stats, n_nodes: int,
                     n_bins: int) -> torch.Tensor:
    """Per-row stats into (node, feature, bin) cells: [n_nodes, C, n_bins,
    S] f32.  bins [N, C] integer (uint8/int32 as they are, uint16 widened
    on its device), node_idx [N] int32 level-local (-1 = inactive), stats
    [N, S] f32.  CUDA tensors launch kernel B1 (``csrc/hist.cu``) or
    raise; CPU tensors take the plain version.  ``launches`` counts kernel
    launches only."""
    from . import hist
    bins = hist.widen_bins(bins)
    if bins.device.type == "cpu":
        return hist.build_histograms_ref(bins, node_idx, stats, n_nodes,
                                         n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"build_histograms: no kernel for device "
                         f"{bins.device}")
    out = hist.build_histograms_cuda(bins, node_idx, stats, n_nodes, n_bins)
    build_histograms.launches += 1
    return out


build_histograms.launches = 0


def build_histograms_batch(bins, node_idx_b, stats_b, n_nodes: int,
                           n_bins: int) -> torch.Tensor:
    """Tree-batched :func:`build_histograms`: TB trees' level histograms
    over one shared bin plane, [TB, n_nodes, C, n_bins, S] f32.
    node_idx_b [TB, N] int32, stats_b [TB, N, S] f32; each tree's slice
    equals a :func:`build_histograms` call on that tree's inputs bit for
    bit.  CUDA tensors launch kernel B2 (``csrc/hist.cu`` for TB trees) or
    raise; CPU tensors take the plain version.  ``launches`` counts kernel
    launches only."""
    from . import hist
    bins = hist.widen_bins(bins)
    if bins.device.type == "cpu":
        return hist.build_histograms_batch_ref(bins, node_idx_b, stats_b,
                                               n_nodes, n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"build_histograms_batch: no kernel for device "
                         f"{bins.device}")
    out = hist.build_histograms_batch_cuda(bins, node_idx_b, stats_b,
                                           n_nodes, n_bins)
    build_histograms_batch.launches += 1
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


def best_splits(hist, cat_mask, feat_active, impurity: str = "variance",
                min_instances: float = 1.0, min_gain: float = 0.0,
                has_cat: bool = True):
    """Best split per node from the level histogram hist [nodes, C, B, 2]
    (w, wy); cat_mask [C] bool (categorical bins sort by response before
    the prefix scan), feat_active [C] bool (feature subset).  ``impurity``
    is ``variance`` or ``friedmanmse`` (GBT) or ``entropy`` or ``gini``
    (RF/DT, binary targets; native multiclass histograms are not ported).

    Returns (gain [nodes], feat [nodes] int32, left_mask [nodes, B] bool,
    leaf_value [nodes], node_w [nodes]).  ``has_cat=False`` (the caller
    knows its mask has no categorical column) skips the sort."""
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
    if impurity == "friedmanmse":
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


def _level_leaf_raw(stats, node_idx, n_nodes: int):
    """Per-node raw stat sums [S, K] f32 (frozen rows contribute nothing).
    On the card: kernel B1 over one all-zero column of one bin, which
    sums each node's rows in O(N) into the f32 rounding of an exact
    (order-free) sum.  On the CPU, the plain version: a float64 one-hot
    matmul over row blocks, added in a fixed order.  Both are
    deterministic; they agree exactly for integer stats and within one
    f32 ulp otherwise."""
    n, s = stats.shape
    dev = stats.device
    if dev.type == "cuda":
        return _leaf_raw_hist(stats, node_idx, n_nodes)
    ids = torch.arange(n_nodes, device=dev, dtype=node_idx.dtype)
    out = torch.zeros((s, n_nodes), dtype=torch.float64, device=dev)
    step = max(1, _LEAF_BLOCK // max(n_nodes, 1))
    for r0 in range(0, n, step):
        oh = (node_idx[r0:r0 + step, None] == ids[None, :]).double()
        out = out + stats[r0:r0 + step].double().T @ oh
    return out.float()


def _leaf_raw_hist(stats, node_idx, n_nodes: int):
    """[S, K] leaf sums as the histogram of one all-zero column of one
    bin — :func:`_level_leaf_raw`'s card path (B1 on CUDA tensors).
    ``launches`` counts its B1 launches (also in
    ``build_histograms.launches``)."""
    zero = torch.zeros((stats.shape[0], 1), dtype=torch.uint8,
                       device=stats.device)
    out = build_histograms(zero, node_idx, stats, n_nodes, 1)[:, 0, 0].T
    if stats.is_cuda:
        _leaf_raw_hist.launches += 1
    return out


_leaf_raw_hist.launches = 0


def leaf_values_from_raw(sums):
    """[S, K] raw stat sums -> [K] leaf values ``wy / w``."""
    return sums[1] / sums[0].clamp_min(EPS)


def grow_tree(bins, stats, cat, fa, n_bins: int, depth: int,
              impurity: str, min_instances: float, min_gain: float,
              max_leaves: int = 0, has_cat: bool = True):
    """Whole-tree level-wise growth (the resident path of the reference's
    ``grow_tree_jit``) on the device of ``bins``, with no host sync.

    bins [N, C] (uint8 or int32), stats [N, 2] f32 ``[w, w*grad]``, cat
    [C] bool, fa [C] bool.  Level l < depth builds only the LEFT-child
    histogram (K = 2^(l-1); the full root at level 0) and derives each
    right child as parent - left, zero under a frozen parent: a depth-d
    tree launches B1 d times.  The bottom level needs leaf sums only
    (:func:`_level_leaf_raw`: one more B1 launch on the card).

    Returns (split_feat [total] int32, left_mask [total, B] bool,
    leaf_value [total] f32, gain_fi [C] f32 realized split gains per
    feature, leaf_glob [N] int32 terminal node per row)."""
    def level_hists(node_idx, n_nodes):
        return [build_histograms(bins, node_idx[0], stats, n_nodes, n_bins)]
    return _grow(bins, [stats], cat, [fa], n_bins, depth, impurity,
                 min_instances, min_gain, max_leaves, has_cat,
                 level_hists)[0]


def grow_forest(bins, stats_b, cat, fa_b, n_bins: int, depth: int,
                impurity: str, min_instances: float, min_gain: float,
                max_leaves: int = 0, has_cat: bool = True):
    """TB independent trees grown level-wise together — the port of the
    reference's ``grow_forest_jit`` (the Random Forest's tree batch).

    stats_b [TB, N, S] per-tree channels (each tree's bag), fa_b [TB, C]
    per-tree feature subsets; ``bins`` and ``cat`` are shared.  Each
    level's TB histograms build in ONE launch of kernel B2
    (:func:`build_histograms_batch`), which reads the shared bins once
    for a tile of trees; histogram subtraction, the leaf-sum bottom level
    and ``max_leaves`` apply per tree exactly as in :func:`grow_tree`, so
    every tree's outputs are bit-identical to a :func:`grow_tree` call on
    its inputs.  Returns a list of TB :func:`grow_tree` tuples."""
    def level_hists(node_idx, n_nodes):
        return list(build_histograms_batch(bins, torch.stack(node_idx),
                                           stats_b, n_nodes,
                                           n_bins).unbind(0))
    return _grow(bins, list(stats_b.unbind(0)), cat, list(fa_b.unbind(0)),
                 n_bins, depth, impurity, min_instances, min_gain,
                 max_leaves, has_cat, level_hists)


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


def _grow(bins, stats, cat, fa, n_bins: int, depth: int, impurity: str,
          min_instances: float, min_gain: float, max_leaves: int,
          has_cat: bool, level_hists):
    """The level loop of :func:`grow_tree` and :func:`grow_forest` for
    trees t with ``stats[t]`` and ``fa[t]``; ``level_hists(node_idx,
    K)`` builds every tree's [K, C, B, S] histogram of one level from the
    per-tree node ids.  Each tree runs the same per-tree ops in the same
    order whatever the batch, which is what makes a batched tree equal a
    sequential one bit for bit."""
    n, c = bins.shape
    dev = bins.device
    tb = len(stats)
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
    feat_ids = torch.arange(c, device=dev)
    hist_prev = feat_prev = None
    for level in range(depth + 1):
        n_nodes = 1 << level
        if level == depth:
            for t in range(tb):
                leaves[t].append(leaf_values_from_raw(
                    _level_leaf_raw(stats[t], node_idx[t], n_nodes)))
                feats[t].append(torch.full((n_nodes,), -1, dtype=torch.int32,
                                           device=dev))
                lmasks[t].append(torch.zeros((n_nodes, n_bins),
                                             dtype=torch.bool, device=dev))
            break
        if level == 0:
            hists = level_hists(node_idx, 1)
        else:
            hists = _subtract(level_hists(
                [_left_child_index(ni) for ni in node_idx], n_nodes // 2),
                hist_prev, feat_prev)
        hist_prev, feat_prev = hists, [None] * tb
        for t in range(tb):
            gain, feat, lmask, leaf, _ = best_splits(
                hists[t], cat, fa[t], impurity, min_instances, min_gain,
                has_cat)
            if max_leaves > 0:
                feat, lmask, nodes_cnt[t] = cap_splits_by_leaves(
                    gain, feat, lmask, nodes_cnt[t], max_leaves)
            feats[t].append(feat)
            lmasks[t].append(lmask)
            leaves[t].append(leaf)
            split = feat >= 0
            realized = torch.where(split, gain.clamp_min(0.0), 0.0).float()
            gain_fi[t] = gain_fi[t] + torch.where(
                feat.long()[:, None] == feat_ids[None, :], realized[:, None],
                0.0).sum(dim=0)
            feat_prev[t] = feat
            node_idx[t] = _descend(bins, node_idx[t], feat, lmask)
            # rows that descended rest at their child's GLOBAL id; frozen
            # rows keep the node they stopped at
            leaf_glob[t] = torch.where(node_idx[t] >= 0,
                                       ((1 << (level + 1)) - 1)
                                       + node_idx[t], leaf_glob[t])
    return [(torch.cat(feats[t]), torch.cat(lmasks[t]), torch.cat(leaves[t]),
             gain_fi[t], leaf_glob[t]) for t in range(tb)]
