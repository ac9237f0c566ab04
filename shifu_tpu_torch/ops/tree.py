"""Decision-tree ops — the port of ``shifu_tpu.ops.tree``'s resident
growth path: the histogram build (kernel B1, :func:`build_histograms`),
the split-gain scan (:func:`best_splits`), the leaf-wise node budget,
and whole-tree level-wise growth with histogram subtraction
(:func:`grow_tree`).  Forests are walked by ``ops.tree_quant`` (kernel
B4).

Trees are complete binary arrays (node i's children at 2i+1 / 2i+2):
``split_feat[node]`` (-1 = leaf), a per-bin ``left_mask`` (numeric and
categorical splits alike: "bin in the left set") and ``leaf_value``.

Everything here is eager PyTorch on the device of its inputs, with no
host sync: a grown tree stays on the device until its caller copies it.
Where a reduction order would change from run to run on the card (float
atomics), the port sums deterministically instead: B1 in fixed point, leaf
sums as a float64 one-hot matmul, feature-importance gains as a plain
reduction — so a resumed forest is bit-identical to an uninterrupted one.
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


# ------------------------------------------------------------- split scan
def _variance_score(w, wy):
    """Per-partition variance score; gain = score_L + score_R - score_P."""
    return wy * wy / w.clamp_min(EPS)


def best_splits(hist, cat_mask, feat_active, impurity: str = "variance",
                min_instances: float = 1.0, min_gain: float = 0.0,
                has_cat: bool = True):
    """Best split per node from the level histogram hist [nodes, C, B, 2]
    (w, wy); cat_mask [C] bool (categorical bins sort by response before
    the prefix scan), feat_active [C] bool (feature subset).  ``impurity``
    is GBT's ``variance`` or ``friedmanmse``; entropy and gini come with
    the RF/DT trainers (ROADMAP Queue 1 item 6).

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
    elif impurity == "variance":
        gain = (_variance_score(cw, cwy)
                + _variance_score(tw - cw, twy - cwy)
                - _variance_score(tw, twy))
    else:
        raise ValueError(f"unknown impurity {impurity!r}")

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


#: rows x nodes per one-hot block of the leaf-sum matmul
_LEAF_BLOCK = 1 << 24


def _level_leaf_raw(stats, node_idx, n_nodes: int):
    """Per-node raw stat sums [S, K] f32 (frozen rows contribute nothing):
    a float64 one-hot matmul over row blocks, added in a fixed order —
    deterministic on the card, unlike a float scatter."""
    n, s = stats.shape
    dev = stats.device
    ids = torch.arange(n_nodes, device=dev, dtype=node_idx.dtype)
    out = torch.zeros((s, n_nodes), dtype=torch.float64, device=dev)
    step = max(1, _LEAF_BLOCK // max(n_nodes, 1))
    for r0 in range(0, n, step):
        oh = (node_idx[r0:r0 + step, None] == ids[None, :]).double()
        out = out + stats[r0:r0 + step].double().T @ oh
    return out.float()


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
    tree launches B1 d times.  The bottom level needs leaf sums only.

    Returns (split_feat [total] int32, left_mask [total, B] bool,
    leaf_value [total] f32, gain_fi [C] f32 realized split gains per
    feature, leaf_glob [N] int32 terminal node per row)."""
    n, c = bins.shape
    dev = bins.device
    feats, lmasks, leaves = [], [], []
    gain_fi = torch.zeros(c, dtype=torch.float32, device=dev)
    node_idx = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_glob = torch.zeros(n, dtype=torch.int32, device=dev)
    nodes_cnt = torch.ones((), dtype=torch.int32, device=dev)
    feat_ids = torch.arange(c, device=dev)
    hist_prev = feat_prev = None
    for level in range(depth + 1):
        n_nodes = 1 << level
        if level == depth:
            leaves.append(leaf_values_from_raw(
                _level_leaf_raw(stats, node_idx, n_nodes)))
            feats.append(torch.full((n_nodes,), -1, dtype=torch.int32,
                                    device=dev))
            lmasks.append(torch.zeros((n_nodes, n_bins), dtype=torch.bool,
                                      device=dev))
            break
        if level == 0:
            hist = build_histograms(bins, node_idx, stats, 1, n_bins)
        else:
            # histogram subtraction: build the left children only
            hl = build_histograms(bins, _left_child_index(node_idx), stats,
                                  n_nodes // 2, n_bins)
            hr = torch.where((feat_prev >= 0)[:, None, None, None],
                             hist_prev - hl, 0.0)
            hist = torch.stack([hl, hr], dim=1).reshape(
                n_nodes, c, n_bins, hl.shape[3])
        gain, feat, lmask, leaf, _ = best_splits(
            hist, cat, fa, impurity, min_instances, min_gain, has_cat)
        if max_leaves > 0:
            feat, lmask, nodes_cnt = cap_splits_by_leaves(
                gain, feat, lmask, nodes_cnt, max_leaves)
        feats.append(feat)
        lmasks.append(lmask)
        leaves.append(leaf)
        split = feat >= 0
        realized = torch.where(split, gain.clamp_min(0.0), 0.0).float()
        gain_fi = gain_fi + torch.where(
            feat.long()[:, None] == feat_ids[None, :], realized[:, None],
            0.0).sum(dim=0)
        hist_prev, feat_prev = hist, feat
        node_idx = _descend(bins, node_idx, feat, lmask)
        # rows that descended rest at their child's GLOBAL id; frozen rows
        # keep the node they stopped at
        leaf_glob = torch.where(node_idx >= 0,
                                ((1 << (level + 1)) - 1) + node_idx,
                                leaf_glob)
    return (torch.cat(feats), torch.cat(lmasks), torch.cat(leaves), gain_fi,
            leaf_glob)
