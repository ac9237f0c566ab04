"""Port parity for the tree-growth ops: ``shifu_tpu_torch.ops.tree``'s
``best_splits``, ``cap_splits_by_leaves`` and ``grow_tree`` against
``shifu_tpu.ops.tree``'s on the same numpy-seeded inputs, on the CPU, and
a grown tree walked by ``ops.tree_quant`` against the reference's
``predict_tree``.

Integer outputs (split feature, left mask, leaf-wise budget, terminal node
per row) must be equal.  Gains and leaf values are f32 arithmetic taken in
another order (cumsum, histogram sums), so they agree within rtol 1e-5;
leaf values also within 1e-6 absolute, because an internal node's mean
gradient is a cancelling sum near 0.  Inputs are built with well-separated
gains (ROADMAP Queue 3, C4): the test data's best splits beat the runners-
up by far more than f32 rounding.  Categorical ties in the response-rate
sort are deliberate: both packages break them by bin index (stable sorts).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shifu_tpu.ops import tree as jt
from shifu_tpu_torch.ops import tree as tt
from shifu_tpu_torch.ops import tree_quant as tq

pytestmark = pytest.mark.torch_port


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hist(seed, nodes=4, c=6, b=12):
    """A [nodes, C, B, 2] (w, wy) histogram with integer counts and
    response sums on a 1/4 grid, so category rates tie often."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 40, size=(nodes, c, b)).astype(np.float32)
    w[rng.random(w.shape) < 0.15] = 0.0
    wy = np.round(w * rng.uniform(-1, 1, size=w.shape) * 4) / 4
    return np.stack([w, wy.astype(np.float32)], axis=-1)


@pytest.mark.parametrize("impurity", ["variance", "friedmanmse"])
@pytest.mark.parametrize("has_cat", [False, True])
@pytest.mark.parametrize("min_instances,min_gain", [(1.0, 0.0),
                                                    (25.0, 0.5)])
def test_best_splits_match_reference(impurity, has_cat, min_instances,
                                     min_gain):
    h = _hist(3 + int(has_cat))
    c = h.shape[1]
    cat = np.zeros(c, bool)
    if has_cat:
        cat[[1, 4]] = True
    fa = np.ones(c, bool)
    fa[2] = False
    want = jt.best_splits(jnp.asarray(h), jnp.asarray(cat), jnp.asarray(fa),
                          impurity, min_instances, min_gain, 0, has_cat)
    got = tt.best_splits(_t(h), _t(cat), _t(fa), impurity, min_instances,
                         min_gain, has_cat)
    gain_w, feat_w, lm_w, leaf_w, nw_w = (np.asarray(a) for a in want)
    gain_g, feat_g, lm_g, leaf_g, nw_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(feat_g, feat_w)
    np.testing.assert_array_equal(lm_g, lm_w)
    assert (feat_w >= 0).sum() >= 2 and not np.any(feat_w == 2)
    if has_cat:
        assert np.isin(feat_w, [1, 4]).any()       # a categorical split won
    fin = np.isfinite(gain_w)
    np.testing.assert_array_equal(np.isfinite(gain_g), fin)
    np.testing.assert_allclose(gain_g[fin], gain_w[fin], rtol=1e-5)
    np.testing.assert_allclose(leaf_g, leaf_w, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nw_g, nw_w)


def test_cap_splits_by_leaves_matches_reference():
    """Budget ranks by gain with ties broken by node index."""
    gain = np.array([5.0, 1.0, 5.0, 3.0, 0.5, 3.0, 7.0, 2.0], np.float32)
    feat = np.array([0, 2, -1, 1, 3, 0, 2, 1], np.int32)
    lm = np.random.default_rng(0).random((8, 5)) < 0.5
    for max_leaves, cnt in ((9, 1), (6, 3), (3, 7), (30, 1)):
        want = jt.cap_splits_by_leaves(jnp.asarray(gain), jnp.asarray(feat),
                                       jnp.asarray(lm), jnp.int32(cnt),
                                       max_leaves)
        got = tt.cap_splits_by_leaves(_t(gain), _t(feat), _t(lm),
                                      torch.tensor(cnt, dtype=torch.int32),
                                      max_leaves)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plane(seed, n=3000, c=6, b=16):
    """Rows whose target follows two numeric columns and one categorical
    column strongly: the best splits stand far above the rest."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(np.uint8)
    effect = rng.permutation(b) / b
    logit = 3.0 * (bins[:, 0] > 9) - 2.5 * (bins[:, 3] < 4) \
        + 4.0 * effect[bins[:, 5]] - 1.5
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    cat = np.zeros(c, bool)
    cat[5] = True
    return bins, y, w, cat


@pytest.mark.parametrize("impurity,max_leaves", [("variance", 0),
                                                 ("friedmanmse", 0),
                                                 ("variance", 9)])
def test_grow_tree_matches_reference(impurity, max_leaves):
    bins, y, w, cat = _plane(11)
    n, c = bins.shape
    grad = y - 0.4
    stats = np.stack([w, w * grad], axis=1).astype(np.float32)
    fa = np.ones(c, bool)
    fa[1] = False
    depth, b = 4, 16
    want = jt.grow_tree_jit(jnp.asarray(bins), jnp.asarray(stats),
                            jnp.asarray(cat), jnp.asarray(fa), b, depth,
                            impurity, 20.0, 1.0, max_leaves=max_leaves)
    before = tt.build_histograms.launches
    got = tt.grow_tree(_t(bins), _t(stats), _t(cat), _t(fa), b, depth,
                       impurity, 20.0, 1.0, max_leaves=max_leaves)
    assert tt.build_histograms.launches == before     # CPU: plain version
    sf_w, lm_w, lv_w, fi_w, lg_w = (np.asarray(a) for a in want)
    sf_g, lm_g, lv_g, fi_g, lg_g = (a.numpy() for a in got)
    assert sf_g.shape == (tt.n_tree_nodes(depth),) and lm_g.shape == (31, b)
    np.testing.assert_array_equal(sf_g, sf_w)
    np.testing.assert_array_equal(lm_g, lm_w)
    np.testing.assert_array_equal(lg_g, lg_w)
    np.testing.assert_allclose(lv_g, lv_w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fi_g, fi_w, rtol=1e-5, atol=1e-3)
    assert (sf_w >= 0).sum() >= 4 and sf_w[0] in (0, 3, 5)
    if max_leaves:
        assert (sf_w >= 0).sum() <= (max_leaves + 1) // 2


def test_predict_tree_matches_reference():
    """A grown tree walked by the port's forest walk (``tree_quant``'s
    plain version, B4's oracle) predicts what the reference's
    ``predict_tree`` does, and ends every row at ``grow_tree``'s
    ``leaf_glob``."""
    bins, y, w, cat = _plane(12, n=500)
    stats = np.stack([w, w * (y - 0.5)], axis=1).astype(np.float32)
    sf, lm, lv, _, leaf_glob = tt.grow_tree(
        _t(bins), _t(stats), _t(cat), _t(np.ones(6, bool)), 16, 3,
        "variance", 5.0, 0.0)
    lm_u8 = lm.to(torch.uint8)
    got = tq.predict_forest_quant_ref(sf[None], lm_u8[None], lv[None],
                                      _t(bins), 3)[0].numpy()
    want = np.asarray(jt.predict_tree(jnp.asarray(sf.numpy()),
                                      jnp.asarray(lm.numpy()),
                                      jnp.asarray(lv.numpy()),
                                      jnp.asarray(bins), 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tq.traverse_quant(sf, lm_u8, _t(bins), 3).numpy(), leaf_glob.numpy())


def test_best_splits_rejects_unknown_impurity():
    """variance, friedmanmse, entropy and gini are ported; any other name
    must not silently score as one of them."""
    h = _t(_hist(5))
    c = h.shape[1]
    with pytest.raises(ValueError, match="unknown impurity"):
        tt.best_splits(h, torch.zeros(c, dtype=torch.bool),
                       torch.ones(c, dtype=torch.bool), "hinge")


def test_depth_zero_tree_is_one_leaf():
    bins, y, w, cat = _plane(13, n=200)
    stats = np.stack([w, w * y], axis=1).astype(np.float32)
    sf, lm, lv, fi, lg = tt.grow_tree(_t(bins), _t(stats), _t(cat),
                                      _t(np.ones(6, bool)), 16, 0,
                                      "variance", 1.0, 0.0)
    assert sf.tolist() == [-1] and lm.shape == (1, 16) and not lm.any()
    np.testing.assert_allclose(lv.numpy(), [(w * y).sum() / w.sum()],
                               rtol=1e-6)
    assert not fi.any() and not lg.any()


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("k", [1, 8, 300])
def test_leaf_sums_match_reference(integer, k):
    """The leaf-sum level on both of the port's paths — the plain float64
    one-hot matmul (the CPU path) and the one-column, one-bin histogram
    the card builds with B1 (here through B1's plain version) — against
    the reference's ``_level_leaf_raw`` on the same inputs.  Integer
    stats sum exactly everywhere; otherwise the reference's f32 dot agrees
    within 1e-5 of the node's |stats| sum, and the port's two paths, both
    f64 sums rounded once, within one f32 ulp of each other."""
    rng = np.random.default_rng(k + integer)
    n = 3000
    node = rng.integers(0, k, size=n).astype(np.int32)
    node[rng.random(n) < 0.25] = -1
    w = rng.poisson(1.0, size=n).astype(np.float32)
    y = (rng.random(n) < 0.4) if integer else rng.standard_normal(n)
    stats = np.stack([w, w * y], axis=1).astype(np.float32)
    want = np.asarray(jt._level_leaf_raw(jnp.asarray(stats),
                                         jnp.asarray(node), k))
    scale = np.asarray(jt._level_leaf_raw(jnp.asarray(np.abs(stats)),
                                          jnp.asarray(node), k))
    before = tt.build_histograms.launches, tt._leaf_raw_hist.launches
    plain = tt._level_leaf_raw(_t(stats), _t(node), k).numpy()
    hist = tt._leaf_raw_hist(_t(stats), _t(node), k).numpy()
    assert (tt.build_histograms.launches,             # CPU: plain versions
            tt._leaf_raw_hist.launches) == before
    for got in (plain, hist):
        assert got.shape == (2, k) and got.dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        if integer:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert np.all(np.abs(got[1] - want[1]) <= 1e-5 * scale[1])
    assert np.all(np.abs(hist - plain) <= np.spacing(np.abs(plain)))


@pytest.mark.parametrize("algorithm", ["GBT", "RF"])
def test_growth_on_the_prepared_plane_matches_reference(prepared_set,
                                                        algorithm):
    """``grow_tree`` (GBT stats, variance) and ``grow_forest`` (3 Poisson
    bags, entropy) on the prepared fixture's clean plane (int32 bins of
    4001) against the reference's ``grow_tree_jit`` / ``grow_forest_jit``:
    equal splits, masks and terminal nodes, leaves within 1e-6.  A gain
    floor of 1e-3 pins the structure (ROADMAP Queue 3, C9)."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.ops.hist import widen_bins
    import json
    import os
    data = Shards.open(os.path.join(prepared_set, "tmp",
                                    "CleanedData")).load_all()
    with open(os.path.join(prepared_set, "ColumnConfig.json")) as f:
        ccs = {c["columnNum"]: c for c in json.load(f)}
    cols = Shards.open(os.path.join(prepared_set, "tmp", "CleanedData")) \
        .schema["columnNums"]
    cat = np.array([ccs[c]["columnType"] == "C" for c in cols])
    bins = widen_bins(_t(data["bins"])).numpy()
    n_bins = int(bins.max()) + 1
    y, w = data["y"].astype(np.float32), data["w"].astype(np.float32)
    rng = np.random.default_rng(3)
    depth = 3
    # the id-like column (4001 bins) separates y by itself: leave it out
    # of the subsets so the trees grow past the root
    keep = bins.max(axis=0) < 1000
    if algorithm == "GBT":
        stats = np.stack([w, w * (y - y.mean())], axis=1).astype(np.float32)
        fa = keep
        want = [jt.grow_tree_jit(jnp.asarray(bins), jnp.asarray(stats),
                                 jnp.asarray(cat), jnp.asarray(fa), n_bins,
                                 depth, "variance", 20.0, 1e-3)]
        got = [tt.grow_tree(_t(bins), _t(stats), _t(cat), _t(fa), n_bins,
                            depth, "variance", 20.0, 1e-3)]
    else:
        bags = rng.poisson(1.0, size=(3, len(y))) * w
        stats = np.stack([bags, bags * y], axis=2).astype(np.float32)
        fa = (rng.random((3, len(cols))) < 0.8) & keep
        out = jt.grow_forest_jit(jnp.asarray(bins), jnp.asarray(stats),
                                 jnp.asarray(cat), jnp.asarray(fa), n_bins,
                                 depth, "entropy", 20.0, 1e-3)
        want = [[a[t] for a in out] for t in range(3)]
        got = tt.grow_forest(_t(bins), _t(stats), _t(cat), _t(fa), n_bins,
                             depth, "entropy", 20.0, 1e-3)
    splits = 0
    for g, wt in zip(got, want):
        sf, lm, lv, _, lg = (x.numpy() for x in g)
        np.testing.assert_array_equal(sf, np.asarray(wt[0]))
        np.testing.assert_array_equal(lm, np.asarray(wt[1]))
        np.testing.assert_allclose(lv, np.asarray(wt[2]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(lg, np.asarray(wt[4]))
        splits += int((sf >= 0).sum())
    assert splits >= 3 * len(got)
